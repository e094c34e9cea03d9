"""The small sizes at which the harness's CPU tests drive a whole run: the
sparse toy body, a 48 x 48 x 32 grid, 128^2 renders, the capture options'
capacities cut to match, 10 merge steps, 4 samples a color ray, a short
fit and a 2-item training batch of 64 rays x 8 samples. Widths stay."""

from __future__ import annotations

import copy
import os

from benchmark.harness import ROOT, cell_files, load_json

SPEC = load_json(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json"))


def small_cfg(cell: str) -> dict:
    return shrink(copy.deepcopy(cell_files(SPEC, cell)[1]))


def shrink(cfg: dict) -> dict:
    """``cfg`` at the small sizes, in place."""
    cfg["vol_res"] = [48, 48, 32]
    cfg["body"] = {"n_lat": 9, "n_lon": 12, "vertices": 98}
    cfg["capture"]["img_res"] = 128
    cfg["capture"]["options"].update(
        max_tris=1 << 15, max_active=1 << 13, refine_capacity=1 << 16,
        recon_max_tris=1 << 15, recon_max_active=1 << 13,
        recon_refine_capacity=1 << 16, raster_max_candidates=0,
        render_res=128, skin_row_group=1, fusion_iters=10,
        nerf_unique_capacity=1 << 14, recon_unique_capacity=1 << 14,
        n_samples=4)
    cfg["fit"].update(template_steps=300, decoder_steps=100, n_pts=1024,
                      batch=2048)
    cfg["train"].update(batch_size=2, n_rays=64, n_samples=8, n_surf=200,
                        n_vol=56)
    return cfg
