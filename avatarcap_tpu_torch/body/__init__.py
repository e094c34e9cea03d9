"""Port counterpart of avatarcap_tpu/body/."""
