"""The one place where a cell builds a network: for the program, for the
reference, and on the meta device for the work counts.

A configuration file names its networks in a ``networks`` block, one entry
a role: ``avatar`` (GeoTexAvatar; the texture avatar has its form) and
``recon`` (ReconNet). Each entry gives the program's class and the
reference's class as ``module:Class`` paths, and the constructor's
keywords, the same for both sides::

    "recon": {"program": "avatarcap_tpu_torch.models.recon:ReconNetwork",
              "reference": "benchmark.reference.recon:ReconNetwork",
              "kwargs": {"feat_channels": 32}}

The avatar's ``if_type`` is the configuration's top-level key and is passed
from there. ``check(cfg)`` runs at a cell's set-up, before the window: each
path lies under its side's package and imports, the keywords are the
constructor's, the program's state-dict keys and shapes equal the
reference's, and the reference's point layers have the (out, in) shapes
that ``work`` counts from the configuration's ``widths``. Each refusal is a
ValueError that names the configuration key.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

from benchmark import work

# where each side's classes may come from: the reference never from the
# program, the program never from the benchmark
PACKAGES = {"program": "avatarcap_tpu_torch.",
            "reference": "benchmark.reference."}

# each work count's layer shapes: the role and submodules whose point
# layers they describe, in order, and the widths they are computed from
COUNTED = (
    (work.offset_shapes, "avatar",
     ("warping_field.mlp", "warping_field.out_layer_coord_affine"),
     ("warp_pos_encoding", "pose_feat_dim", "offset_width")),
    (work.template_shapes, "avatar", ("cano_template",),
     ("template_pos_encoding", "template_width")),
    (work.recon_shapes, "recon", ("image_decoder",),
     ("recon_in_dim", "recon_widths", "recon_res_layers")),
)


def _entry(cfg: dict, role: str) -> dict:
    entry = cfg.get("networks", {}).get(role)
    if not isinstance(entry, dict):
        raise ValueError(f"networks.{role}: the configuration names no "
                         f"{role} network")
    return entry


def _class(cfg: dict, role: str, side: str) -> type:
    """The class that ``networks.<role>.<side>`` names."""
    key = f"networks.{role}.{side}"
    path = _entry(cfg, role).get(side)
    if (not isinstance(path, str) or path.count(":") != 1
            or not path.startswith(PACKAGES[side])):
        raise ValueError(f"{key} = {path!r}: a 'module:Class' path under "
                         f"{PACKAGES[side].rstrip('.')}")
    module, name = path.split(":")
    try:
        return getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError) as e:
        raise ValueError(f"{key} = {path!r}: {e}") from e


def _kwargs(cfg: dict, role: str) -> dict:
    """The constructor's keywords: ``networks.<role>.kwargs``, and the
    avatar's ``if_type`` from the top level."""
    kw = dict(_entry(cfg, role).get("kwargs", {}))
    if role == "avatar":
        if "if_type" in kw:
            raise ValueError("networks.avatar.kwargs.if_type: the avatar's "
                             "if_type is the configuration's top-level key")
        kw["if_type"] = cfg["if_type"]
    return kw


def build(cfg: dict, role: str, side: str, **override) -> torch.nn.Module:
    """The configuration's ``role`` network of ``side`` ("program" or
    "reference"), its keywords replaced by ``override``, built as its
    constructor starts it (on the current default device)."""
    cls = _class(cfg, role, side)
    kw = dict(_kwargs(cfg, role), **override)
    try:
        return cls(**kw)
    except (TypeError, ValueError) as e:
        raise ValueError(f"networks.{role}.kwargs = {kw}: {e}") from e


def meta(cfg: dict, role: str, side: str = "reference") -> torch.nn.Module:
    """``build`` on the meta device: shapes without storage, for the
    work counts."""
    with torch.device("meta"):
        return build(cfg, role, side)


def point_shapes(module: torch.nn.Module) -> Tuple[Tuple[int, int], ...]:
    """(out, in) of each point layer of ``module`` in module order: the
    kernel-size-1 Conv1d layers, weight-normed (``weight_v``) or not."""
    shapes = []
    for m in module.modules():
        w = getattr(m, "weight_v", None)
        if w is None and isinstance(m, torch.nn.Conv1d):
            w = m.weight
        if w is not None and w.dim() == 3 and w.shape[2] == 1:
            shapes.append((w.shape[0], w.shape[1]))
    return tuple(shapes)


def _state_shapes(module: torch.nn.Module) -> Dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def check(cfg: dict) -> None:
    """Refuse, before anything is built for a run, a configuration whose
    networks do not resolve, whose program and reference differ in state,
    or whose ``widths`` differ from what is built (see the module's
    docstring)."""
    refs = {}
    for role in cfg.get("networks", {}):
        # on the host: on the meta device the weight norm's first call
        # imports torch._dynamo, seconds of set-up
        with torch.device("cpu"):
            ref, prog = (build(cfg, role, side)
                         for side in ("reference", "program"))
        a, b = _state_shapes(ref), _state_shapes(prog)
        if a != b:
            odd = sorted(set(a.items()) ^ set(b.items()))[:4]
            raise ValueError(f"networks.{role}: the program's state dict "
                             f"differs from the reference's, e.g. {odd}")
        refs[role] = ref
    widths = cfg["widths"]
    for count, role, parts, keys in COUNTED:
        if role not in refs:
            continue
        names = ", ".join(f"widths.{k}" for k in keys)
        missing = [k for k in keys if k not in widths]
        if missing:
            raise ValueError(f"widths.{missing[0]}: missing ({names} give "
                             f"work.{count.__name__})")
        want = tuple(tuple(s) for s in count(widths))
        got = tuple(s for p in parts
                    for s in point_shapes(refs[role].get_submodule(p)))
        if want != got:
            raise ValueError(f"{names} give work.{count.__name__} {want}; "
                             f"networks.{role} builds {got}")
