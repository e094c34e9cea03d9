"""A step's work (work.train_step_macs: forward and backward of the
point MLPs and the U-Net, the KNN) over the unprofiled step time
(metrics.iteration_s) and the float32 peak (the step's precision)."""

from benchmark import work
from benchmark.metrics import iteration_s, unet_macs


def read(run):
    step_s = iteration_s(run)
    if not step_s:
        return None
    cfg = run.cfg
    tr = cfg["train"]
    unet = unet_macs(cfg) * tr["batch_size"]
    macs = work.train_step_macs(cfg["widths"], tr, unet,
                                cfg["body"]["vertices"])["step_macs"]
    return 100.0 * 2.0 * macs / (step_s * work.PEAK_F32_FLOPS)
