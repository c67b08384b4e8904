"""The port's BoxDiff (`lmdx_torch.sampling.boxdiff`, `methods.boxdiff`) and
`TapSpec.fused` against the JAX package's on the tiny-test config.

- `make_boxdiff_data` and `_gaussian_kernel` are the same numpy code: equal.
- `boxdiff_loss` and its gradient w.r.t. the taps on random maps: the loss
  within 1e-6 relative, the gradient within 1e-5 of its largest value (f32
  softmax, blur and top-k sums in other orders).
- `boxdiff.run` on the two layouts of tests/test_torch_baselines.py at 6 steps
  with 2 guided steps, on the same weights and noise: the latents handed to
  the VAE within 1e-4 of their largest value, the images within 2 levels.
- The route of an untapped attention under `TapSpec(fused=False)` (plain
  math) and under the default spec (unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmdx.methods as jmethods
from lmdx.config import SD_CONFIGS as JCONFIGS
from lmdx.methods import base as jbase
from lmdx.sampling import boxdiff as jbd
from lmdx_torch import config as tconfig
from lmdx_torch import methods as tmethods
from lmdx_torch.methods import base as tbase
from lmdx_torch.nn import attention as tatt
from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.sampling import boxdiff as tbd
from lmdx_torch.sampling.guidance import guidance_data_to_device
from tests._torch_tiny import one_torch_thread, record_decodes, tiny_bundles
from tests.test_torch_baselines import SPECS

UCFG = tconfig.tiny_test().unet
LATENT_HW, LEVELS = (16, 16), len(UCFG.block_out_channels)

# (boxes per object, token positions per object); an object may hold
# several boxes.
LAYOUTS = {
    "one": ([(0.1, 0.2, 0.6, 0.9)], [[2, 3]]),
    "two": ([(0.0, 0.0, 0.5, 0.5), (0.4, 0.3, 1.0, 0.8)], [[4], [7, 8]]),
    "three_multibox": ([[(0.05, 0.1, 0.3, 0.4), (0.6, 0.6, 0.95, 0.9)],
                        (0.2, 0.5, 0.45, 1.0), (0.7, 0.0, 1.0, 0.25)],
                       [[3], [5, 6], [9]]),
}


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


def _spec():
    keys = tbd.default_boxdiff_keys(UCFG)
    assert keys == jbd.default_boxdiff_keys(JCONFIGS["tiny-test"]().unet)
    return tbd.BoxDiffSpec(keys=keys), jbd.BoxDiffSpec(keys=keys)


def test_default_keys_are_the_sd1_set():
    assert tbd.default_boxdiff_keys(tconfig.sd15().unet) == tbd.BOXDIFF_GUIDANCE_ATTN_KEYS
    assert tbd.BOXDIFF_GUIDANCE_ATTN_KEYS == jbd.BOXDIFF_GUIDANCE_ATTN_KEYS
    assert tbd.BoxDiffSpec().tap_spec.fused is False


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_make_boxdiff_data_matches_jax(layout):
    bboxes, positions = LAYOUTS[layout]
    tspec, jspec = _spec()
    got = tbd.make_boxdiff_data(bboxes, positions, tspec, LATENT_HW, LEVELS)
    want = jbd.make_boxdiff_data(bboxes, positions, jspec, LATENT_HW, LEVELS)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["valid"].sum() == sum(len(p) for p in positions)


def test_make_boxdiff_data_refuses_mixed_resolutions():
    spec = tbd.BoxDiffSpec(keys=(("down", 0, 0, 0), ("up", 0, 0, 0)))
    with pytest.raises(ValueError, match="resolutions"):
        tbd.make_boxdiff_data(*LAYOUTS["one"], spec, LATENT_HW, LEVELS)


@pytest.mark.parametrize("size,sigma", [(3, 0.5), (5, 1.0), (3, 2.0)])
def test_gaussian_kernel_matches_jax(size, sigma):
    got = tbd._gaussian_kernel(size, sigma)
    np.testing.assert_array_equal(got, jbd._gaussian_kernel(size, sigma))
    assert got.dtype == np.float32 and abs(got.sum() - 1.0) < 1e-6
    # exp(-(x / 2 sigma)^2), not exp(-x^2 / 2 sigma^2).
    g = np.exp(-((np.arange(size) - (size - 1) / 2) / (2 * sigma)) ** 2)
    np.testing.assert_allclose(got, np.outer(g, g) / np.outer(g, g).sum(), rtol=1e-6)


def test_smooth_matches_jax():
    x = np.random.default_rng(0).random((3, 16, 16), dtype=np.float32)
    got = tbd._smooth(torch.from_numpy(x), 3, 0.5).numpy()
    want = np.asarray(jbd._smooth(jnp.asarray(x), 3, 0.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _random_taps(keys, seed, heads=2, n=256, ctx=77):
    rng = np.random.default_rng(seed)
    taps = {}
    for k in keys:
        logits = rng.standard_normal((1, heads, n, ctx)).astype(np.float32) * 3.0
        e = np.exp(logits - logits.max(-1, keepdims=True))
        taps[k] = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return taps


@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_boxdiff_loss_and_gradient_match_jax(layout, smooth):
    bboxes, positions = LAYOUTS[layout]
    tspec, jspec = _spec()
    tspec = tbd.BoxDiffSpec(keys=tspec.keys, smooth_attentions=smooth)
    jspec = jbd.BoxDiffSpec(keys=jspec.keys, smooth_attentions=smooth)
    taps = _random_taps(tspec.keys, seed=len(layout) + smooth)
    jdata = jbd.make_boxdiff_data(bboxes, positions, jspec, LATENT_HW, LEVELS)
    tdata = guidance_data_to_device(
        tbd.make_boxdiff_data(bboxes, positions, tspec, LATENT_HW, LEVELS), "cpu")

    want, want_grad = jax.value_and_grad(
        lambda t: jbd.boxdiff_loss(t, jdata, jspec))({k: jnp.asarray(v) for k, v in taps.items()})
    ttaps = {k: torch.from_numpy(v).requires_grad_(True) for k, v in taps.items()}
    got = tbd.boxdiff_loss(ttaps, tdata, tspec)
    got.backward()
    assert float(want) > 0
    assert got.item() == pytest.approx(float(want), rel=1e-6, abs=0)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want_grad.values())
    assert scale > 0
    for k in tspec.keys:
        np.testing.assert_allclose(ttaps[k].grad.numpy(), np.asarray(want_grad[k]),
                                   rtol=0, atol=1e-5 * scale, err_msg=str(k))


@pytest.mark.parametrize("spec", SPECS, ids=["layout_a", "layout_b"])
def test_boxdiff_run_matches_jax(monkeypatch, bundles, spec):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    kw = dict(bg_seed=3, num_inference_steps=6, overall_max_index_step=2)
    want = jmethods.get_method("boxdiff").run(spec, jb, **kw)
    with one_torch_thread():
        got = tmethods.get_method("boxdiff").run(spec, tb, **kw)
    assert len(got_latents) == len(want_latents) == 1
    np.testing.assert_allclose(got_latents[0], want_latents[0], rtol=0,
                               atol=1e-4 * np.abs(want_latents[0]).max())
    assert got.image.dtype == np.uint8 and got.image.shape == want.image.shape
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= 2, diff.max()


def test_boxdiff_guidance_moves_the_latents(monkeypatch, bundles):
    """Two guided steps move the final latents by far more than the parity
    tolerance above, so that parity sees the guidance."""
    (latents,) = record_decodes(monkeypatch, tbase)
    with one_torch_thread():
        for guided in (0, 2):
            tmethods.get_method("boxdiff").run(SPECS[0], bundles[1], bg_seed=3,
                                               num_inference_steps=6,
                                               overall_max_index_step=guided)
    a, b = latents
    assert np.abs(a - b).max() > 1e-2 * np.abs(a).max()


def _routes(monkeypatch):
    calls = []
    for name in ("flash_attention", "attention_plain", "flash_attention_hd"):
        orig = getattr(fa, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(fa, name, rec)
    return calls


@pytest.mark.parametrize("fused_heads", [False, True], ids=["default", "fused_heads"])
def test_tapspec_fused_routes_untapped_layers(monkeypatch, fused_heads):
    """An untapped attention (KV of 256 tokens: the flash gate holds) handed a
    spec with fused=False runs plain math; the default spec keeps the kernel
    route (per-head flash, or fused-heads under that option) with the same
    result as before the flag existed (fused=True is the default)."""
    torch.manual_seed(0)
    options = tconfig.KernelOptions(fused_heads=fused_heads)
    layer = tatt.CrossAttention(32, 2, 16, tap_name="down_0_0_0", options=options).eval()
    x = torch.randn(1, 256, 32)
    other = (("up", 1, 0, 0),)
    calls = _routes(monkeypatch)
    with torch.no_grad():
        default = layer(x, taps=tatt.TapSpec(keys=other))
        route_default = list(calls)
        calls.clear()
        plain = layer(x, taps=tatt.TapSpec(keys=other, fused=False))
        route_plain = list(calls)
        calls.clear()
        explicit = layer(x, taps=tatt.TapSpec(keys=other, fused=True))
    assert route_default == (["flash_attention_hd"] if fused_heads else ["flash_attention"])
    assert route_plain == ["attention_plain"]
    assert calls == route_default
    assert torch.equal(default, explicit)
    torch.testing.assert_close(plain, default, rtol=0, atol=1e-5)


def test_unfused_guidance_forward_routes(monkeypatch, bundles):
    """In an early-exit guidance forward under a spec with fused=False the
    tapped layer exports its map, the untapped cross-attentions run plain
    math, and the self-attentions (which receive no spec) keep their route."""
    from lmdx_torch.nn.unet import apply_unet

    tb = bundles[1]
    spec = tatt.TapSpec(keys=(("up", 1, 1, 0),), fused=False)
    calls = _routes(monkeypatch)
    lat = torch.randn(1, 16, 16, 4, generator=torch.Generator().manual_seed(0))
    ctx = torch.randn(1, 77, 32, generator=torch.Generator().manual_seed(1))
    with one_torch_thread(), torch.no_grad():
        taps = apply_unet(tb.unet, lat, 501, ctx, taps=spec, stop_after_taps=True)[1]
    assert set(taps) == set(spec.keys)
    # Tiny UNet: a 16x16 self-attention (256 tokens: the flash gate holds) and
    # a cross-attention in down_0, in the 8x8 mid block (its 64-token
    # self-attention is below the gate) and in each of up_1's two blocks.
    flash, plain = "flash_attention", "attention_plain"
    assert calls == [flash, plain, plain, plain, flash, plain, flash]
