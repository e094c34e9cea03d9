"""The benchmark of the PyTorch/CUDA port (avatarcap_tpu_torch): one cell
per run, configurations, traffic mixes, limits and metric readers found
by name. See run.py."""
