"""benchmark/networks.py builds every network of a cell. Today's two
configurations get the networks the constructor calls built before it
(the same classes, state-dict keys and shapes), the same drawn weights
and fit-cache names, and the same work counts; a configuration whose
networks do not resolve, or whose widths are not what is built, is
refused at set-up, before the window, naming its key."""

import copy
import hashlib

import pytest
import torch

from benchmark import networks, run as bench_run, subject, work
from benchmark.harness import cell_files
from benchmark.metrics import hgfilter_macs, unet_macs
from benchmark.tests.small import SPEC, small_cfg

# geotex_sdf and geotex_occ
CAPTURE_CELLS = ("sdf.textured", "occ.avatar_only")
SEEDS = (7, 2 ** 31 + 5)

# the weights' digests before the form came from the configuration: the
# draws of subject.capture_weights (its fits left out, as they follow from
# these) and subject.train_weights; the same at the small and full sizes
# and in both configurations
CAPTURE_DIGESTS = {
    7: {"avatar": "d691538d53729d46", "tex": "31b751ff37a5dde1",
        "recon": "1e2563d524a5a7f5"},
    2 ** 31 + 5: {"avatar": "f40630659192fb99", "tex": "541e08ed77023988",
                  "recon": "1e2563d524a5a7f5"}}
TRAIN_DIGESTS = {7: "4ddf86ac28022fe1", 2 ** 31 + 5: "b5fd2345dc1ef82f"}
# the fit cache's names: (template, decoder), small on the CPU and full
# size on the card
FIT_NAMES = {"small": ("fit_8204d1034201d942.pt", "fit_7173dbf3c4b7367a.pt"),
             "full": ("fit_7f4df9f0c7b2456a.pt", "fit_6a67b50c48e010b0.pt")}


def _digest(state: dict) -> str:
    h = hashlib.sha1()
    for k in sorted(state):
        v = state[k].detach().contiguous()
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()[:16]


def _shapes(module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("cell", CAPTURE_CELLS)
def test_networks_are_the_constructors_they_replace(cell):
    from avatarcap_tpu_torch.models.avatar import GeoTexAvatar
    from avatarcap_tpu_torch.models.recon import ReconNetwork
    from benchmark.reference.avatar_model import GeoTexAvatar as RefAvatar
    from benchmark.reference.recon import ReconNetwork as RefRecon
    cfg = cell_files(SPEC, cell)[1]
    with torch.device("meta"):
        pairs = [
            (networks.build(cfg, "avatar", "program"),
             GeoTexAvatar(if_type=cfg["if_type"])),
            (networks.build(cfg, "recon", "program"), ReconNetwork()),
            (networks.build(cfg, "avatar", "reference"),
             RefAvatar(if_type=cfg["if_type"])),
            (networks.build(cfg, "recon", "reference"), RefRecon()),
            (networks.meta(cfg, "avatar").warping_field.unet,
             RefAvatar().warping_field.unet),
            (networks.meta(cfg, "recon").image_encoder,
             RefRecon().image_encoder)]
    for got, want in pairs:
        assert type(got) is type(want)
        assert _shapes(got) == _shapes(want)
    for avatar in (pairs[0][0], pairs[2][0]):
        assert avatar.if_type == cfg["if_type"]
        assert avatar.encodings == (10, 0)
    networks.check(cfg)


@pytest.mark.parametrize("cell", CAPTURE_CELLS)
@pytest.mark.parametrize("size", ["small", "full"])
def test_weights_and_fit_names_are_todays(cell, size, monkeypatch):
    cfg = small_cfg(cell) if size == "small" else copy.deepcopy(
        cell_files(SPEC, cell)[1])
    # the draws alone: the fits are left out (the fitted modules' starts
    # are what the form decides)
    monkeypatch.setattr(subject, "_cached", lambda key, module, fit_fn,
                        use_cache: {"cache_hit": False, "loss": 0.0})
    for seed in SEEDS:
        weights = subject.capture_weights(cfg, seed, None, None, None,
                                          "cpu")[0]
        assert {k: _digest(v) for k, v in weights.items()} == \
            CAPTURE_DIGESTS[seed]
        assert _digest(subject.train_weights(cfg, seed)) == \
            TRAIN_DIGESTS[seed]
    device = "cpu" if size == "small" else "cuda"
    names = tuple(subject._cache_path(k).rsplit("/", 1)[1]
                  for k in subject.fit_keys(cfg, device))
    assert names == FIT_NAMES[size]


def test_todays_counts():
    cfg = cell_files(SPEC, "sdf.textured")[1]
    w = cfg["widths"]
    assert work.k1_macs_per_point(w) == 985_472
    assert work.k2_macs_per_point(w) == 193_536
    assert work.k2_bytes_per_point(w) == 136
    assert unet_macs(cfg) == 5_175_771_136              # a 256^2 map
    assert hgfilter_macs(cfg) == 116_153_909_248        # 512^2 images


def test_recon_shapes_take_any_decoder():
    # PIFu's SurfaceClassifier (ICCV 2019, scripts/test.sh --mlp_dim 257
    # 1024 512 256 128 1): the input concatenated before every layer after
    # the first
    w = {"recon_in_dim": 257, "recon_widths": [1024, 512, 256, 128],
         "recon_res_layers": [1, 2, 3, 4]}
    assert work.recon_shapes(w) == ((1024, 257), (512, 1281), (256, 769),
                                    (128, 513), (1, 385))
    assert work.k2_macs_per_point(w) == 1_181_953
    assert work.k2_bytes_per_point(w) == 1_032


def _unknown_class(cfg):
    cfg["networks"]["recon"]["program"] = \
        "avatarcap_tpu_torch.models.recon:NoSuchNetwork"


def _reference_from_the_program(cfg):
    cfg["networks"]["avatar"]["reference"] = \
        "avatarcap_tpu_torch.models.avatar:GeoTexAvatar"


def _unknown_keyword(cfg):
    cfg["networks"]["recon"]["kwargs"] = {"feat_chanels": 16}


def _widths_not_built(cfg):
    cfg["networks"]["recon"]["kwargs"]["feat_channels"] = 16


@pytest.mark.parametrize("cell", ["sdf.textured", "sdf.train_b4"])
@pytest.mark.parametrize("alter,key", [
    (_unknown_class, "networks.recon.program"),
    (_reference_from_the_program, "networks.avatar.reference"),
    (_unknown_keyword, "networks.recon.kwargs"),
    (_widths_not_built, "widths.recon_in_dim")])
def test_refused_at_set_up_naming_the_key(cell, alter, key, monkeypatch):
    cfg = small_cfg(cell)
    alter(cfg)

    def went_on(*a, **kw):
        raise AssertionError("set-up went on past the refusal")
    monkeypatch.setattr(subject, "toy_avatar_statics", went_on)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        bench_run.run_cell(SPEC, cell, 5, 0.5, False, "cpu",
                           cfg_override=cfg)
