"""The port's VAE encoder (`AutoencoderKL.encode_moments`, `encode`) and the
method layer's `encode_image` against the JAX package's on the tiny-test
config's weights (the JAX parameters converted for the port,
`tests/_torch_tiny.py`), and the decode half left as it was.

Tolerance: 1e-4 of the largest value, as for the other VAE and UNet stacks
(f32 sums in other orders over a dozen layers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from lmdx.methods import base as jbase
from lmdx_torch import config as tconfig
from lmdx_torch.methods import base as tbase
from lmdx_torch.nn import vae as tvae
from lmdx_torch.runtime import models as tmodels
from tests._torch_tiny import one_torch_thread, tiny_bundles


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


def _close(got, want, rel=1e-4):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _images(bundle, seed, n=2):
    cfg = bundle.config
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, cfg.height, cfg.width, 3)).astype(np.float32)


def _japply(jb, method, *args):
    return jb.vae.apply({"params": jb.params["vae"]}, *args,
                        method=getattr(jb.vae.__class__, method))


def test_encode_moments_matches_jax(bundles):
    jb, tb = bundles
    x = _images(jb, 0)
    want_mean, want_logvar = _japply(jb, "encode_moments", jnp.asarray(x))
    with one_torch_thread(), torch.no_grad():
        mean, logvar = tb.vae.encode_moments(torch.from_numpy(x))
    cfg = tb.config
    assert mean.shape == (2, cfg.latent_height, cfg.latent_width, 4)
    _close(mean, want_mean)
    _close(logvar, want_logvar)


@pytest.mark.parametrize("with_noise", [False, True], ids=["mean", "sampled"])
def test_encode_matches_jax(bundles, with_noise):
    jb, tb = bundles
    x = _images(jb, 1)
    cfg = tb.config
    noise = (np.random.default_rng(2).standard_normal(
        (2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
        if with_noise else None)
    want = _japply(jb, "encode", jnp.asarray(x),
                   None if noise is None else jnp.asarray(noise))
    with one_torch_thread(), torch.no_grad():
        got = tb.vae.encode(torch.from_numpy(x),
                            None if noise is None else torch.from_numpy(noise))
    _close(got, want)


def test_logvar_is_clipped():
    """A VAE whose quant_conv bias pushes logvar past both ends returns it
    clipped to [-30, 20]."""
    cfg = tconfig.tiny_test()
    vae = tvae.AutoencoderKL(cfg.vae).eval()
    with torch.no_grad():
        vae.quant_conv.weight.zero_()
        vae.quant_conv.bias.copy_(torch.tensor([0, 0, 0, 0, 100.0, -100.0, 5.0, -5.0]))
        _, logvar = vae.encode_moments(torch.zeros(1, cfg.height, cfg.width, 3))
    assert logvar.amax(dim=(0, 1, 2)).tolist() == [20.0, -30.0, 5.0, -5.0]


@pytest.mark.parametrize("with_noise", [False, True], ids=["mean", "sampled"])
def test_encode_image_matches_jax(bundles, with_noise):
    jb, tb = bundles
    cfg = tb.config
    image = np.random.default_rng(3).integers(0, 256, (cfg.height, cfg.width, 3),
                                              dtype=np.uint8)
    noise = (np.random.default_rng(4).standard_normal(
        (1, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
        if with_noise else None)
    want = jbase.encode_image(jb, image, noise)
    with one_torch_thread():
        got = tbase.encode_image(tb, image, noise)
    _close(got, want)


def test_decode_roundtrip_matches_jax(bundles):
    """encode then decode, each side through its own VAE."""
    jb, tb = bundles
    x = _images(jb, 5, n=1)
    want = _japply(jb, "decode", _japply(jb, "encode", jnp.asarray(x), None))
    with one_torch_thread(), torch.no_grad():
        got = tb.vae.decode(tb.vae.encode(torch.from_numpy(x)))
        assert torch.equal(tb.vae(tb.vae.encode(torch.from_numpy(x))), got)
    _close(got, want)


def test_random_weights_other_than_the_encoder_are_unchanged():
    """A seeded random bundle draws the encoder half last: the UNet, the text
    encoder, the decode half and PositionNet hold what the same seed drew
    when the VAE had no encoder (post_quant_conv, then the decoder, drawn
    between the text encoder and PositionNet), so decode is bit for bit what
    it was."""
    cfg = tconfig.tiny_test()
    with one_torch_thread():
        bundle = tmodels.load_bundle("tiny-test", seed=3, device="cpu")
        fresh = tmodels.build_bundle(cfg, None, seed=3, device="cpu")
        decode_half = nn.ModuleDict({"post_quant_conv": fresh.vae.post_quant_conv,
                                     "decoder": fresh.vae.decoder})
        g = torch.Generator(device="cpu").manual_seed(3)
        for module in (fresh.unet, fresh.text_encoder, decode_half, fresh.position_net):
            tmodels._random_init(module.named_parameters(), g)
    got = dict(bundle.vae.named_parameters())
    for name, p in decode_half.named_parameters():
        assert torch.equal(got[name], p), name
    for part in ("unet", "text_encoder", "position_net"):
        want = dict(getattr(fresh, part).named_parameters())
        for name, p in getattr(bundle, part).named_parameters():
            assert torch.equal(p, want[name]), (part, name)
    assert got["encoder.conv_in.weight"].abs().sum() > 0
    assert got["quant_conv.weight"].abs().sum() > 0
