"""The live position pass of the [cli] frame's normal lift through the JAX
package and through the port, on the CPU, on the inputs chip_smoke.py's
[cli] phase saved from the card (chiprun_out/cli_live_pass.npz: the
frame's live triangle soup, its valid flags, the capture camera's MVP and
the pass's window and capacities).

Run from the root of the repository, after a chip_smoke.py run:

    JAX_PLATFORMS=cpu python tests/jax_cli_live_pass.py [path.npz]

Prints one JSON line per package: the pass's covered-candidate count and
big-triangle count beside their capacities, and its overflow bit. It is a
script, not a test: pytest does not collect it.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(HERE, "..", "chiprun_out",
                                             "cli_live_pass.npz")
    d = np.load(path)
    tris = d["vertices"].reshape(-1, 3, 3).astype(np.float32)
    clip = np.einsum("ij,tvj->tvi", d["mvp"].astype(np.float64),
                     np.concatenate([tris, np.ones_like(tris[..., :1])], -1)
                     ).astype(np.float32)
    h, w = int(d["height"]), int(d["width"])
    kw = dict(window=int(d["window"]),
              big_tri_capacity=int(d["big_tri_capacity"]),
              max_candidates=int(d["max_candidates"]))
    cand_cap = kw["max_candidates"] or max(tris.shape[0], 1 << 16)

    sys.path.insert(0, os.path.join(HERE, ".."))
    import jax.numpy as jnp
    import torch
    from avatarcap_tpu.render.raster import rasterize_index
    from avatarcap_tpu_torch.render.raster import rasterize_index as trast
    ref = rasterize_index(jnp.asarray(clip), jnp.asarray(d["valid"]), h, w,
                          **kw)
    got = trast(torch.as_tensor(clip), torch.as_tensor(d["valid"]), h, w,
                **kw)
    for name, r in (("jax", ref), ("port", got)):
        print(json.dumps({
            "package": name, "triangles": int(np.asarray(d["valid"]).sum()),
            "candidates": int(np.asarray(r.n_candidates)),
            "candidate_capacity": cand_cap,
            "big_tris": int(np.asarray(r.n_big)),
            "big_tri_capacity": kw["big_tri_capacity"],
            "overflow": bool(np.asarray(r.overflow))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
