"""Port counterpart of avatarcap_tpu/utils/."""
