"""The port's pix2pixHD generators (models/pix2pix.py) against the JAX
package's at small widths (ngf 4, 2 downsamplings, 1 resnet block), on
random draws carried across by the weight bridge: the port's state_dict
goes through the JAX converters (convert_global_generator,
convert_local_enhancer, convert_encoder), the JAX module runs on those
variables, and the outputs agree within 1e-4. The round trip back
through weights.generator_state_dict_from_jax gives every tensor's bits,
so the port keeps the reference's torch key names.
"""

import numpy as np
import pytest
import torch

WIDTHS = dict(ngf=4, n_down=2, n_blocks=1)


def _draw(module, seed):
    """Every parameter N(0, 0.3), biases too, from one generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return module.eval()


def _case(kind):
    from avatarcap_tpu.models import pix2pix as jp
    from avatarcap_tpu.tools import convert_torch_ckpt as conv
    from avatarcap_tpu_torch.models import pix2pix as tp
    ngf, nd, nb = WIDTHS["ngf"], WIDTHS["n_down"], WIDTHS["n_blocks"]
    if kind == "global":
        return (tp.GlobalGenerator(3, 3, ngf, nd, nb),
                jp.GlobalGenerator(output_nc=3, ngf=ngf, n_downsampling=nd,
                                   n_blocks=nb),
                lambda sd: conv.convert_global_generator(
                    sd, n_downsampling=nd, n_blocks=nb),
                dict(n_downsampling=nd, n_blocks=nb))
    if kind == "local":
        return (tp.LocalEnhancer(3, 3, ngf, nd, nb, 1, 1),
                jp.LocalEnhancer(output_nc=3, ngf=ngf, n_downsample_global=nd,
                                 n_blocks_global=nb, n_local_enhancers=1,
                                 n_blocks_local=1),
                lambda sd: conv.convert_local_enhancer(
                    sd, n_local_enhancers=1, n_downsample_global=nd,
                    n_blocks_global=nb, n_blocks_local=1),
                dict(n_downsampling=nd, n_blocks=nb, n_local_enhancers=1,
                     n_blocks_local=1))
    return (tp.Encoder(3, 3, ngf, nd),
            jp.Encoder(output_nc=3, ngf=ngf, n_downsampling=nd),
            lambda sd: conv.convert_encoder(sd, n_downsampling=nd),
            dict(n_downsampling=nd))


@pytest.mark.parametrize("kind", ["global", "local", "encoder"])
def test_generator_matches_jax(kind):
    import jax.numpy as jnp
    model, jmodel, convert, _ = _case(kind)
    _draw(model, seed=1)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 3, 40, 32)).astype(np.float32)
    variables = convert({k: v.detach() for k, v in
                         model.state_dict().items()})
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    if kind == "encoder":
        # ids past the 64-instance capacity clip to the last one
        inst = rng.randint(0, 5, (2, 40, 32))
        inst[0, :4] = 70
        ref = jmodel.apply(variables, xj, jnp.asarray(inst))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(inst))
    else:
        ref = jmodel.apply(variables, xj)
        with torch.no_grad():
            got = model(torch.from_numpy(x))
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    assert got.shape == ref.shape == (2, 3, 40, 32)
    assert ref.std() > 0.05
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("kind", ["global", "local", "encoder"])
def test_state_dict_round_trip_is_exact(kind):
    from avatarcap_tpu_torch.weights import generator_state_dict_from_jax
    model, _, convert, kw = _case(kind)
    _draw(model, seed=3)
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    back = generator_state_dict_from_jax(convert(sd), kind=kind, **kw)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    fresh = _case(kind)[0]
    fresh.load_state_dict(back, strict=True)


def test_reference_key_names():
    """The keys convert_torch_ckpt.py reads, for the reference's
    define_G(3, 3, 64, 'global', 4, 9) layout."""
    from avatarcap_tpu_torch.models.pix2pix import (GlobalGenerator,
                                                    LocalEnhancer)
    keys = set(GlobalGenerator(3, 3, 64, 4, 9).state_dict())
    assert {"model.1.weight", "model.4.weight", "model.13.weight",
            "model.16.conv_block.1.weight", "model.24.conv_block.5.bias",
            "model.25.weight", "model.34.weight",
            "model.38.weight"} <= keys
    keys = set(LocalEnhancer(3, 3, 32, 3, 9, 1, 3).state_dict())
    assert {"model.1.weight", "model1_1.1.weight", "model1_1.4.weight",
            "model1_2.2.conv_block.5.weight", "model1_2.3.weight",
            "model1_2.7.weight"} <= keys


def test_f32_convolutions_in_forward(monkeypatch):
    """Each forward pass asks for float32, deterministic cuDNN."""
    from avatarcap_tpu_torch.models import pix2pix
    seen = []
    real = torch.backends.cudnn.flags

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(torch.backends.cudnn, "flags", spy)
    model = _case("global")[0]
    with torch.no_grad():
        model(torch.zeros(1, 3, 16, 16))
    assert seen and seen[-1]["deterministic"] is True
    assert seen[-1]["allow_tf32"] is False
    assert pix2pix.conv_transpose_out_pad1(8, 4)(
        torch.zeros(1, 8, 5, 7)).shape == (1, 4, 10, 14)
