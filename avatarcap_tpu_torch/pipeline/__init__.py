"""Port counterpart of avatarcap_tpu/pipeline/."""
