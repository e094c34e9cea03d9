"""Device milliseconds a frame of the operations launched under the
program's ``marching_tets`` spans (ops/marching_cubes: the avatar's mesh,
and ReconNet's with w_recon), in the stretch with the program's own spans
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.device_ms(run, "marching_tets")
