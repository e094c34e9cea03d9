"""Avatar training, texture finetuning, schedules and checkpoints."""
