"""Weight bridge: JAX/flax variables -> the port's state_dicts.

``avatar_state_dict_from_jax`` and ``recon_state_dict_from_jax`` are the
inverses of avatarcap_tpu/tools/convert_torch_ckpt.py:convert_geotex_avatar
and :convert_recon_network. Their key names are the reference torch names
those converters read, so the port's ``GeoTexAvatar`` and
``ReconNetwork`` also load released AvatarCap checkpoints (through
``load_reference_state_dict``); ``generator_state_dict_from_jax`` does the
same for the pix2pixHD generators (the inverse of convert_global_generator,
convert_local_enhancer and convert_encoder). The avatar bridge reads every
width from the parameters' shapes, so it serves every positional
encoding; ``hgfilter_state_dict_from_jax`` (any stack count) and
``unet_state_dict_from_jax`` (UnetNoCond5DS / 6DS / 7DS) carry the
modules no network of the capture uses. Layouts:

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


def _conv_t(sd, name, p):
    # (kh, kw, I, O) -> torch ConvTranspose2d (I, O, kh, kw)
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(2, 3, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _mlp(sd, prefix, p, n_hidden):
    for i in range(n_hidden):
        _dense(sd, f"{prefix}fc_list.{i}.0", p[f"fc{i}"])
    _dense(sd, f"{prefix}fc_list.{n_hidden}", p[f"fc{n_hidden}"])


def _unet(sd, prefix, p, s):
    """A POP U-Net's blocks by their flax names: ``conv*`` Conv2DBlocks,
    up blocks with a transposed convolution (``up``) or an upsample +
    conv (``up_conv``, torch ``up.1``); a BatchNorm where the block has
    statistics."""
    for name, block in p.items():
        if "conv" in block:
            _conv2d(sd, f"{prefix}{name}.conv", block["conv"])
        elif "up" in block:
            _conv_t(sd, f"{prefix}{name}.up", block["up"])
        else:
            _conv2d(sd, f"{prefix}{name}.up.1", block["up_conv"])
        if name in s:
            _bn(sd, f"{prefix}{name}.bn", s[name]["bn"])


def unet_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of a UnetNoCond5DS / 6DS / 7DS
    -> the port's state_dict of the same U-Net (the reference's
    network/unets.py key names)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    _unet(sd, "", variables["params"], variables.get("batch_stats", {}))
    return sd


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


def _hgfilter(sd, prefix, enc, depth, n_stack):
    _conv2d(sd, f"{prefix}conv1", enc["conv1"])
    _groupnorm(sd, f"{prefix}bn1", enc["bn1"])
    for name in ("conv2", "conv3", "conv4"):
        _hg_convblock(sd, f"{prefix}{name}", enc[name])
    for i in range(n_stack):
        hg = enc[f"m{i}"]
        for lvl in range(depth, 0, -1):
            for b in ("b1", "b2", "b3"):
                _hg_convblock(sd, f"{prefix}m{i}.{b}_{lvl}",
                              hg[f"{b}_{lvl}"])
        _hg_convblock(sd, f"{prefix}m{i}.b2_plus_1", hg["b2_plus_1"])
        _hg_convblock(sd, f"{prefix}top_m_{i}", enc[f"top_m_{i}"])
        _conv2d(sd, f"{prefix}conv_last{i}", enc[f"conv_last{i}"])
        _groupnorm(sd, f"{prefix}bn_end{i}", enc[f"bn_end{i}"])
        _conv2d(sd, f"{prefix}l{i}", enc[f"l{i}"])
        if i < n_stack - 1:
            _conv2d(sd, f"{prefix}bl{i}", enc[f"bl{i}"])
            _conv2d(sd, f"{prefix}al{i}", enc[f"al{i}"])


def hgfilter_state_dict_from_jax(variables: Mapping, depth: int = 4,
                                 n_stack: int = 1
                                 ) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of an HGFilter -> the port's HGFilter
    state_dict, stacks joined by ``bl{i}`` / ``al{i}`` (the reference's
    network/HGFilters.py names; convert_torch_ckpt.py:convert_hgfilter
    reads one stack's keys, so this bridge is the inverse of the JAX
    variables themselves)."""
    sd: Dict[str, torch.Tensor] = OrderedDict()
    _hgfilter(sd, "", variables["params"], depth, n_stack)
    return sd


def recon_state_dict_from_jax(variables: Mapping,
                              depth: int = 4) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of ReconNetwork -> the port's ReconNetwork
    state_dict (the inverse of convert_torch_ckpt.py:convert_recon_network).
    Weight-normed layers: ``g`` (O,) -> ``weight_g`` (O, 1, 1), ``v``
    (I, O) -> ``weight_v`` (O, I, 1)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    _hgfilter(sd, "image_encoder.", params["image_encoder"], depth, 1)
    dec = params["image_decoder"]
    for i in range(3):
        p = dec[f"fc{i}"]
        name = f"image_decoder.fc_list.{i}.0"
        sd[f"{name}.weight_g"] = _t(np.asarray(p["g"])[:, None, None])
        sd[f"{name}.weight_v"] = _t(np.asarray(p["v"]).T[:, :, None])
        sd[f"{name}.bias"] = _t(p["bias"])
    _dense(sd, "image_decoder.fc_list.3", dec["fc3"])
    return sd


def _resnet_block(sd, name, p):
    _conv2d(sd, f"{name}.conv_block.1", p["conv1"])
    _conv2d(sd, f"{name}.conv_block.5", p["conv2"])


def _global_generator(sd, p, n_downsampling, n_blocks, prefix=""):
    """A GlobalGenerator's ``model.*`` keys (the layout
    convert_global_generator reads); the final conv when ``p`` has one."""
    _conv2d(sd, f"{prefix}model.1", p["conv_in"])
    idx = 4
    for i in range(n_downsampling):
        _conv2d(sd, f"{prefix}model.{idx}", p[f"down{i}"])
        idx += 3
    for i in range(n_blocks):
        _resnet_block(sd, f"{prefix}model.{idx}", p[f"res{i}"])
        idx += 1
    for i in range(n_downsampling):
        _conv_t(sd, f"{prefix}model.{idx}", p[f"up{i}"])
        idx += 3
    if "conv_out" in p:
        _conv2d(sd, f"{prefix}model.{idx + 1}", p["conv_out"])


def generator_state_dict_from_jax(variables: Mapping, kind: str = "global",
                                  n_downsampling: int = 4,
                                  n_blocks: int = 9,
                                  n_local_enhancers: int = 1,
                                  n_blocks_local: int = 3
                                  ) -> Dict[str, torch.Tensor]:
    """flax ``{"params"}`` of a pix2pixHD generator -> the port's
    ``models/pix2pix`` state_dict: the inverse of convert_torch_ckpt.py's
    convert_global_generator (``kind="global"``), convert_local_enhancer
    (``"local"``: ``n_downsampling`` / ``n_blocks`` are the global trunk's,
    n_downsample_global / n_blocks_global there) and convert_encoder
    (``"encoder"``, no resnet blocks)."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = OrderedDict()
    if kind == "global":
        _global_generator(sd, params, n_downsampling, n_blocks)
    elif kind == "encoder":
        _global_generator(sd, params, n_downsampling, 0)
    elif kind == "local":
        _global_generator(sd, params["global"], n_downsampling, n_blocks)
        for n in range(1, n_local_enhancers + 1):
            _conv2d(sd, f"model{n}_1.1", params[f"enh{n}_conv_in"])
            _conv2d(sd, f"model{n}_1.4", params[f"enh{n}_down"])
            for i in range(n_blocks_local):
                _resnet_block(sd, f"model{n}_2.{i}", params[f"enh{n}_res{i}"])
            _conv_t(sd, f"model{n}_2.{n_blocks_local}", params[f"enh{n}_up"])
            if n == n_local_enhancers:
                _conv2d(sd, f"model{n}_2.{n_blocks_local + 4}",
                        params[f"enh{n}_conv_out"])
    else:
        raise ValueError(f"kind={kind!r}: one of 'global', 'local', "
                         "'encoder'")
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
