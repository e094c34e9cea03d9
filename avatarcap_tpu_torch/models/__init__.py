"""Port counterpart of avatarcap_tpu/models/."""
