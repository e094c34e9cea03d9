"""avatarcap_tpu_torch: the PyTorch / CUDA port of avatarcap_tpu for NVIDIA
Hopper (H100).

The JAX package ``avatarcap_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``models/``, ``body/``, ``render/``, ``pipeline/``) so
each module's counterpart is found by name, imports neither JAX nor
anything of ``avatarcap_tpu``, and runs on the card unless the caller asks
for the CPU (``device="cpu"``). Every Pallas kernel on a ported path is a
hand-written Hopper kernel under ``csrc/`` (see ``kernels.py``).

Ported so far: the avatar-only capture frame,
``pipeline.capture.AvatarCapture.process_frame(item, w_recon=False,
w_nerf=False)``, through the CUDA kernel ``csrc/warp_template_query.cu``.
"""

from avatarcap_tpu_torch.device import resolve_device  # noqa: F401
