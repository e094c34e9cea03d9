"""Port counterpart of avatarcap_tpu/fusion/."""
