"""avatarcap_tpu_torch: the PyTorch / CUDA port of avatarcap_tpu for NVIDIA
Hopper (H100).

The JAX package ``avatarcap_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``models/``, ``body/``, ``render/``, ``pipeline/``,
``fusion/``, ``train/``, ``data/``) so
each module's counterpart is found by name, imports neither JAX nor
anything of ``avatarcap_tpu``, and runs on the card unless the caller asks
for the CPU (``device="cpu"``). Every Pallas kernel on a ported path is a
hand-written Hopper kernel under ``csrc/`` (see ``kernels.py``).

Ported so far: the capture frame,
``pipeline.capture.AvatarCapture.process_frame`` (avatar geometry, normal
fusion, ReconNet, NeRF vertex colors; kernels K1-K5), and avatar training:
``train.trainer.AvatarTrainer`` (train step, ``fit``),
``train.finetune.finetune_texture_template`` and the dataset
``data.dataset.AvatarCapDataset`` (training and test mode), and the
command line: ``cli`` (``python -m avatarcap_tpu_torch.cli -c <cfg> -m
{train,test} [--stream N]``), ``config``, ``tools.gen_synthetic``, and
streaming and sharding: ``pipeline.streaming.StreamingCapture``,
``parallel`` (``make_mesh``, ``grid_query.ShardedGridQuery``) and
``AvatarCapture(shard_mesh=...)``.
"""

from avatarcap_tpu_torch.device import resolve_device  # noqa: F401
