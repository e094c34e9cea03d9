"""Weight bridge: JAX/flax variables -> the port's state_dicts.

``avatar_state_dict_from_jax`` and ``recon_state_dict_from_jax`` are the
inverses of avatarcap_tpu/tools/convert_torch_ckpt.py:convert_geotex_avatar
and :convert_recon_network. Their key names are the reference torch names
those converters read, so the port's ``GeoTexAvatar`` and
``ReconNetwork`` also load released AvatarCap checkpoints (through
``load_reference_state_dict``). Layouts:

- flax Conv kernel (kh, kw, I, O)           -> torch Conv2d (O, I, kh, kw)
- ConvTranspose kernel (kh, kw, I, O)       -> torch (I, O, kh, kw), a pure
  transpose (the JAX module flips the kernel at apply time)
- Dense kernel (I, O)                       -> Conv1d (O, I, 1)
- BatchNorm running stats from ``batch_stats``; affine scale/bias from
  ``params``
- GroupNorm scale/bias                      -> weight/bias
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

# Reference parameters that no forward pass reads: the U-Net's ``upconv4``
# (the reference applies ``upconv3`` twice instead). The JAX converter
# drops them (convert_torch_ckpt.py:141); so does the port.
REFERENCE_DEAD_PREFIXES = ("warping_field.unet.upconv4.",)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _dense(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name, stats, affine=None):
    if affine is not None:
        sd[f"{name}.weight"] = _t(affine["scale"])
        sd[f"{name}.bias"] = _t(affine["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv2d(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _mlp(sd, prefix, p, n_hidden):
    for i in range(n_hidden):
        _dense(sd, f"{prefix}fc_list.{i}.0", p[f"fc{i}"])
    _dense(sd, f"{prefix}fc_list.{n_hidden}", p[f"fc{n_hidden}"])


def _unet(sd, prefix, p, s):
    for name in ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6",
                 "conv7"):
        _conv2d(sd, f"{prefix}{name}.conv", p[name]["conv"])
        if name in s:
            _bn(sd, f"{prefix}{name}.bn", s[name]["bn"])
    for name in ("upconv1", "upconv2", "upconv3"):
        k = np.asarray(p[name]["up"]["kernel"])            # (kh, kw, I, O)
        sd[f"{prefix}{name}.up.weight"] = _t(k.transpose(2, 3, 0, 1))
        _bn(sd, f"{prefix}{name}.bn", s[name]["bn"])
    for name in ("upconvC5", "upconvC6", "upconvC7"):
        _conv2d(sd, f"{prefix}{name}.up.1", p[name]["up_conv"])
        if name in s:
            _bn(sd, f"{prefix}{name}.bn", s[name]["bn"])


def avatar_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of GeoTexAvatar (numpy or any
    array type numpy converts) -> the port's GeoTexAvatar state_dict."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    tpl = params["cano_template"]
    _mlp(sd, "cano_template.shared_mlp.", tpl["shared_mlp"], 6)
    geo = tpl["geo_mlp"]
    _dense(sd, "cano_template.geo_mlp.fc_list.0.0", geo["fc0"])
    _dense(sd, "cano_template.geo_mlp.fc_list.1",
           {"kernel": geo["fc1_kernel"], "bias": geo["fc1_bias"]})
    _mlp(sd, "cano_template.clr_mlp.", tpl["clr_mlp"], 2)

    wf, wfs = params["warping_field"], stats["warping_field"]
    _unet(sd, "warping_field.unet.", wf["unet"], wfs["unet"])
    for i in range(1, 8):
        _dense(sd, f"warping_field.mlp.conv{i}", wf["mlp"][f"conv{i}"])
        _bn(sd, f"warping_field.mlp.bn{i}", wfs["mlp"][f"bn{i}"],
            affine=wf["mlp"][f"bn{i}"])
    _dense(sd, "warping_field.out_layer_coord_affine",
           wf["out_layer_coord_affine"])
    return sd


def _groupnorm(sd, name, p):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _hg_convblock(sd, name, p):
    for i in (1, 2, 3):
        _conv2d(sd, f"{name}.conv{i}", p[f"conv{i}"])
        _groupnorm(sd, f"{name}.bn{i}", p[f"bn{i}"])
    if "downsample_conv" in p:
        _groupnorm(sd, f"{name}.downsample.0", p["bn4"])
        _conv2d(sd, f"{name}.downsample.2", p["downsample_conv"])


def recon_state_dict_from_jax(variables: Mapping,
                              depth: int = 4) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of ReconNetwork -> the port's ReconNetwork
    state_dict (the inverse of convert_torch_ckpt.py:convert_recon_network).
    Weight-normed layers: ``g`` (O,) -> ``weight_g`` (O, 1, 1), ``v``
    (I, O) -> ``weight_v`` (O, I, 1)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    enc = params["image_encoder"]
    _conv2d(sd, "image_encoder.conv1", enc["conv1"])
    _groupnorm(sd, "image_encoder.bn1", enc["bn1"])
    for name in ("conv2", "conv3", "conv4"):
        _hg_convblock(sd, f"image_encoder.{name}", enc[name])
    hg = enc["m0"]
    for lvl in range(depth, 0, -1):
        for b in ("b1", "b2", "b3"):
            _hg_convblock(sd, f"image_encoder.m0.{b}_{lvl}", hg[f"{b}_{lvl}"])
    _hg_convblock(sd, "image_encoder.m0.b2_plus_1", hg["b2_plus_1"])
    _hg_convblock(sd, "image_encoder.top_m_0", enc["top_m_0"])
    _conv2d(sd, "image_encoder.conv_last0", enc["conv_last0"])
    _groupnorm(sd, "image_encoder.bn_end0", enc["bn_end0"])
    _conv2d(sd, "image_encoder.l0", enc["l0"])
    dec = params["image_decoder"]
    for i in range(3):
        p = dec[f"fc{i}"]
        name = f"image_decoder.fc_list.{i}.0"
        sd[f"{name}.weight_g"] = _t(np.asarray(p["g"])[:, None, None])
        sd[f"{name}.weight_v"] = _t(np.asarray(p["v"]).T[:, :, None])
        sd[f"{name}.bias"] = _t(p["bias"])
    _dense(sd, "image_decoder.fc_list.3", dec["fc3"])
    return sd


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping[str, torch.Tensor]) -> None:
    """Strict ``load_state_dict`` after dropping REFERENCE_DEAD_PREFIXES
    (so a released reference checkpoint loads as it is)."""
    kept = {k: v for k, v in state_dict.items()
            if not k.startswith(REFERENCE_DEAD_PREFIXES)}
    model.load_state_dict(kept, strict=True)


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a torch checkpoint file (``net.pt``, ``recon_net.pt``) into
    ``model``: a released reference checkpoint keeps its state_dict under
    ``"network"`` (unwrapped here, as the JAX package's
    tools/convert_torch_ckpt.load_torch_state_dict does); the port's own
    checkpoints are the bare state_dict. Tensors only (weights_only)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state_dict(model, data.get("network", data))
