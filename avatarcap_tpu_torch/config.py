"""Configuration tree (a copy of avatarcap_tpu/config.py: the port keeps
its own; it adds ``testing.capture_options``).

Surface-compatible with the reference YAML layout (configs/example.yaml,
the reference's config.py) as typed, immutable dataclasses. Networks never
read the config at construction; everything is passed explicitly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import yaml


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Positional encoding frequency counts (reference configs/example.yaml:26-29).
    cano_template_pos_encoding: int = 10
    warping_field_pos_encoding: int = 0
    # Learning rates (reference configs/example.yaml:32-33).
    cano_template_lr: float = 1e-3
    warping_field_lr: float = 1e-4
    # Loss weights (reference configs/example.yaml:36-39).
    img_loss_weight: float = 1.0
    occ_loss_weight: float = 0.5
    geo_offset_reg_loss_weight: float = 0.05
    tex_offset_reg_loss_weight: float = 0.05


@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    training_data_dir: str = ""
    net_ckpt_dir: str = ""
    net_ckpt: Optional[str] = None
    start_epoch: int = 0
    end_epoch: int = 50
    ckpt_interval: int = 10
    training_data_ids: Optional[str] = None
    batch_size: int = 4
    num_workers: int = 0
    finetune_tex: bool = True
    finetune_tex_data_idx: int = 0


@dataclasses.dataclass(frozen=True)
class TestingConfig:
    vol_res: Sequence[int] = (384, 384, 128)
    recon_net_ckpt: Optional[str] = None
    net_ckpt: Optional[str] = None
    net_ckpt_finetuned: Optional[str] = None
    testing_data_dir: str = ""
    output_dir: str = ""
    # capture capacities (CaptureOptions defaults when 0; size to the
    # subject/grid — overflow is reported on the output meshes)
    max_tris: int = 0
    max_active: int = 0
    render_res: int = 512
    # The port's one addition: further CaptureOptions fields by name (the
    # texture path's unique-vertex capacities, recon_color_mode, the refine
    # capacities, ...), applied after max_tris / max_active. The JAX
    # package's load_config drops this key.
    capture_options: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level config (reference config.py:1-31 module globals + yaml)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    testing: TestingConfig = dataclasses.field(default_factory=TestingConfig)

    # Module-global equivalents (reference config.py:3-22).
    smpl_gender: str = "M"
    n_samples: int = 64          # rays samples (reference config.py:9)
    perturb: float = 1.0         # stratified jitter switch (reference config.py:10)
    if_type: str = "sdf"         # 'sdf' | 'occupancy' (reference config.py:13)
    smpl_model_dir: str = "./smpl_files"

    @property
    def iso_value(self) -> float:
        # reference config.py:16-22
        return 0.0 if self.if_type == "sdf" else 0.5

    @property
    def sdf_thres(self) -> float:
        return 0.1

    def __post_init__(self):
        if self.if_type not in ("sdf", "occupancy"):
            raise ValueError(f"Invalid if_type: {self.if_type!r}")


# Canonical pose: zero pose with legs spread +-25 deg about z
# (reference utils/smpl_util.py:16-18, dataset/avatarcap_dataset.py:61-63).
CANO_LEG_ANGLE_RAD = math.radians(25.0)


def load_config(path: str) -> Config:
    """Load a reference-format YAML (configs/example.yaml) into a Config."""
    with open(path, encoding="UTF-8") as f:
        raw = yaml.safe_load(f)
    model_raw = raw.get("model", {}) or {}
    model_kwargs = {}
    ct = model_raw.get("cano_template", {}) or {}
    wf = model_raw.get("warping_field", {}) or {}
    if "pos_encoding" in ct:
        model_kwargs["cano_template_pos_encoding"] = ct["pos_encoding"]
    if "pos_encoding" in wf:
        model_kwargs["warping_field_pos_encoding"] = wf["pos_encoding"]
    for k in ("cano_template_lr", "warping_field_lr", "img_loss_weight",
              "occ_loss_weight", "geo_offset_reg_loss_weight",
              "tex_offset_reg_loss_weight"):
        if k in model_raw:
            model_kwargs[k] = model_raw[k]
    model = ModelConfig(**model_kwargs)

    tr_raw = raw.get("training", {}) or {}
    tr_fields = {f.name for f in dataclasses.fields(TrainingConfig)}
    training = TrainingConfig(**{k: v for k, v in tr_raw.items() if k in tr_fields})

    te_raw = raw.get("testing", {}) or {}
    te_fields = {f.name for f in dataclasses.fields(TestingConfig)}
    te_kwargs = {k: v for k, v in te_raw.items() if k in te_fields}
    if "vol_res" in te_kwargs:
        te_kwargs["vol_res"] = tuple(te_kwargs["vol_res"])
    if te_kwargs.get("capture_options") is None:
        te_kwargs.pop("capture_options", None)
    testing = TestingConfig(**te_kwargs)

    top_kwargs = {}
    for k in ("smpl_gender", "n_samples", "perturb", "if_type", "smpl_model_dir"):
        if k in raw:
            top_kwargs[k] = raw[k]
    return Config(model=model, training=training, testing=testing, **top_kwargs)
