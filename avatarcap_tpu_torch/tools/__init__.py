"""Port counterpart of avatarcap_tpu/tools/."""
