"""The port's MultiDiffusion (`lmdx_torch.methods.multidiffusion`) against the
JAX package's on the tiny-test config.

`get_views` and `boxes_to_masks_prompts` are the same host code: equal.
For `run`, the two packages draw from different generators, so the test
draws the JAX side's random values in its own split order (the initial
latent, the background colors, the bootstrap noise, one key per bootstrap
step for the background indices) and hands them to the port through its one
draw helper, `draw_randomness`. The runs then hold the latents handed to the
VAE within 1e-4 of their largest value and the images within 2 uint8
levels, as tests/test_torch_baselines.py does. `bootstrapping=3` of 6 steps
runs both segments; 0 runs the plain one alone; a 32x64 canvas slides three
overlapping views.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.methods import base as jbase
from lmdx.methods import multidiffusion as jmd
from lmdx_torch.methods import base as tbase
from lmdx_torch.methods import multidiffusion as tmd
from tests._torch_tiny import one_torch_thread, record_decodes, tiny_bundles
from tests.test_torch_baselines import SPECS


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


@pytest.mark.parametrize("hw", [(512, 512), (512, 1024), (768, 768), (32, 32), (32, 64)])
def test_get_views_matches_jax(hw):
    for vae_scale in (8, 2):
        got = tmd.get_views(*hw, vae_scale=vae_scale)
        assert got == jmd.get_views(*hw, vae_scale=vae_scale)
    assert len(tmd.get_views(512, 512)) == 1


OVERLAPPING = [("a red cube", (50, 50, 250, 250)), ("a blue ball", (150, 150, 250, 250)),
               ("a green tree", (0, 300, 200, 200))]


@pytest.mark.parametrize("first_top", [False, True])
@pytest.mark.parametrize("hw", [(16, 16), (64, 64)])
def test_boxes_to_masks_prompts_matches_jax(first_top, hw):
    got_masks, got_prompts = tmd.boxes_to_masks_prompts(OVERLAPPING, *hw, first_top=first_top)
    want_masks, want_prompts = jmd.boxes_to_masks_prompts(OVERLAPPING, *hw,
                                                          first_top=first_top)
    assert got_prompts == want_prompts == [n for n, _ in OVERLAPPING]
    assert len(got_masks) == len(want_masks) == 3
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g, w)
    # Exclusive: no pixel in two masks; the overlap goes to the top box.
    stacked = np.stack(got_masks)
    assert stacked.sum(0).max() == 1
    top = 0 if first_top else 1
    y, x = hw[0] * 200 // 512, hw[1] * 200 // 512   # inside both first boxes
    assert stacked[top, y, x] == 1


def _jax_draws(seed, latent_shape, num_backgrounds, num_boxes, bootstrap_steps):
    """The JAX side's random values, in its own split order."""
    key = jax.random.key(seed)
    k_latent, k_bg, k_noise, k_steps = jax.random.split(key, 4)
    latent = jax.random.normal(k_latent, latent_shape, jnp.float32)
    if not bootstrap_steps:
        return latent, None, None, None
    colors = jax.random.uniform(k_bg, (num_backgrounds, 1, 1, 3)) * 2.0 - 1.0
    noise = jax.random.normal(k_noise, (num_boxes, *latent_shape[1:]), jnp.float32)
    bg_idx = jnp.stack([jax.random.randint(k, (num_boxes,), 0, num_backgrounds)
                        for k in jax.random.split(k_steps, bootstrap_steps)])
    return latent, colors, noise, bg_idx


def _with_jax_draws(monkeypatch, seen):
    def draws(seed, device, latent_shape, num_backgrounds, num_boxes, bootstrap_steps):
        seen.append((seed, tuple(latent_shape), num_backgrounds, num_boxes, bootstrap_steps))
        out = _jax_draws(seed, latent_shape, num_backgrounds, num_boxes, bootstrap_steps)
        return tmd.Draws(*(None if x is None else torch.as_tensor(np.array(x), device=device)
                           for x in out))

    monkeypatch.setattr(tmd, "draw_randomness", draws)


def _wide(bundle):
    return dataclasses.replace(bundle, config=dataclasses.replace(bundle.config, width=64))


@pytest.mark.parametrize("case", [
    dict(spec=0, bootstrapping=3), dict(spec=1, bootstrapping=3),
    dict(spec=0, bootstrapping=0), dict(spec=1, bootstrapping=3, wide=True),
    dict(spec=0, bootstrapping=3, first_top=True, normalization=True, indep_uncond=False),
], ids=["layout_a", "layout_b", "no_bootstrap", "panorama", "options"])
def test_multidiffusion_run_matches_jax(monkeypatch, bundles, case):
    case = dict(case)
    spec = SPECS[case.pop("spec")]
    jb, tb = bundles
    if case.pop("wide", False):
        jb, tb = _wide(jb), _wide(tb)
    seen = []
    _with_jax_draws(monkeypatch, seen)
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    kw = dict(bg_seed=5, num_inference_steps=6, **case)
    want = jmd.run(spec, jb, **kw)
    with one_torch_thread():
        got = tmd.run(spec, tb, **kw)
    cfg = tb.config
    boxes = len(spec["gen_boxes"])
    assert seen == [(5, (1, cfg.latent_height, cfg.latent_width, 4), case["bootstrapping"],
                     boxes, min(case["bootstrapping"], 6))]
    assert len(got_latents) == len(want_latents) == 1
    np.testing.assert_allclose(got_latents[0], want_latents[0], rtol=0,
                               atol=1e-4 * np.abs(want_latents[0]).max())
    assert got.image.dtype == np.uint8 and got.image.shape == want.image.shape
    assert got.image.shape == (cfg.height, cfg.width, 3)
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    for g, w in zip(got.aux["masks"], want.aux["masks"]):
        np.testing.assert_array_equal(g, w)


def test_gen_boxes_signature_is_the_spec_one(bundles):
    """run(gen_boxes=..., bg_prompt=...) is run(spec) with the same layout."""
    tb = bundles[1]
    spec = SPECS[1]
    kw = dict(original_ind_base=2, steps=3, bootstrapping=2)
    with one_torch_thread():
        a = tmd.run(spec, tb, **kw).image
        b = tmd.run(bundle=tb, gen_boxes=spec["gen_boxes"], bg_prompt=spec["bg_prompt"],
                    extra_neg_prompt=spec["extra_neg_prompt"], **kw).image
    np.testing.assert_array_equal(a, b)


def test_draw_randomness_is_seeded():
    kw = dict(latent_shape=(1, 8, 8, 4), num_backgrounds=4, num_boxes=2, bootstrap_steps=3)
    a = tmd.draw_randomness(7, "cpu", **kw)
    b = tmd.draw_randomness(7, "cpu", **kw)
    c = tmd.draw_randomness(8, "cpu", **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.latent, c.latent)
    assert a.bg_idx.shape == (3, 2) and 0 <= int(a.bg_idx.min()) and int(a.bg_idx.max()) < 4
    assert a.colors.shape == (4, 1, 1, 3) and float(a.colors.abs().max()) <= 1.0
    assert tmd.draw_randomness(7, "cpu", **{**kw, "bootstrap_steps": 0}).colors is None
