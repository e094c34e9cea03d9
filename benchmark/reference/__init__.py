"""The benchmark's plain reference: frozen copies of the port's float32
module path (commit 2621afd) and checks built on them. Imports nothing of
avatarcap_tpu_torch, avatarcap_tpu or jax."""
