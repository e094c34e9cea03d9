"""Port counterpart of avatarcap_tpu/render/."""
