"""Port counterpart of avatarcap_tpu/ops/."""
