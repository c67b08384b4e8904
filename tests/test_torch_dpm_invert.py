"""The port's methods on DPM-Solver++(2M) and its DDIM inversion against the
JAX package's on the tiny-test config.

- `sd`, `gligen`, `backward_guidance` (its published ladder: every one of
  the 6 steps guided) and `lmd_plus` (both passes) with
  `scheduler="dpmpp_2m"` at 6 steps, where the lower-order-final rule drops
  the last step to first order, on the same weights and noise: the latents
  handed to the VAE within 1e-4 of their largest value and the images within
  2 uint8 levels, as tests/test_torch_baselines.py does.
- `sampling.loop.invert` against `lmdx.sampling.loop.invert` at CFG 7.5 and
  at 0 (the uncond-only branch): the final latents and the whole trajectory
  within 1e-4 of their largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmdx.methods as jmethods
from lmdx.core import schedule as jsched
from lmdx.methods import base as jbase
from lmdx.sampling import loop as jloop
from lmdx_torch import methods as tmethods
from lmdx_torch.core import schedule as tsched
from lmdx_torch.methods import base as tbase
from lmdx_torch.sampling import loop as tloop
from tests._torch_tiny import one_torch_thread, record_decodes, tiny_bundles
from tests.test_torch_baselines import SPECS

LMD_PLUS = dict(max_iter=1, overall_max_iter=1, max_index_step=2, overall_max_index_step=2)


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("spec", SPECS, ids=["layout_a", "layout_b"])
@pytest.mark.parametrize("name", ["sd", "gligen", "backward_guidance", "lmd_plus"])
def test_method_on_dpm_solver_matches_jax(monkeypatch, bundles, name, spec):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    kw = dict(num_inference_steps=6, scheduler="dpmpp_2m",
              **(LMD_PLUS if name == "lmd_plus" else {"bg_seed": 3}))
    want = jmethods.get_method(name).run(spec, jb, **kw)
    with one_torch_thread():
        got = tmethods.get_method(name).run(spec, tb, **kw)
    assert len(got_latents) == len(want_latents) == (2 if name == "lmd_plus" else 1)
    for g, w in zip(got_latents, want_latents):
        _close(g, w)
    assert got.image.dtype == np.uint8 and got.image.shape == want.image.shape
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= 2, diff.max()


def test_dpm_solver_differs_from_ddim(monkeypatch, bundles):
    """The solver reaches the result: DDIM and DPM-Solver++ runs of the same
    layout and noise differ by far more than the parity tolerance."""
    (latents,) = record_decodes(monkeypatch, tbase)
    with one_torch_thread():
        for scheduler in ("ddim", "dpmpp_2m"):
            tmethods.get_method("sd").run(SPECS[0], bundles[1], bg_seed=3,
                                          num_inference_steps=6, scheduler=scheduler)
    a, b = latents
    assert np.abs(a - b).max() > 1e-2 * np.abs(a).max()


@pytest.mark.parametrize("guidance_scale", [7.5, 0.0], ids=["cfg", "uncond_only"])
def test_invert_matches_jax(bundles, guidance_scale):
    jb, tb = bundles
    cfg = tb.config
    rng = np.random.default_rng(int(guidance_scale * 10))
    x0 = rng.standard_normal((1, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    emb = rng.standard_normal((2, cfg.clip.max_length, cfg.unet.cross_attention_dim))
    emb = emb.astype(np.float32)
    steps = 6
    want_final, want_traj = jloop.invert(jb.unet, jb.params["unet"],
                                         jsched.make_schedule(steps), jnp.asarray(x0),
                                         jnp.asarray(emb), guidance_scale=guidance_scale)
    with one_torch_thread():
        got_final, got_traj = tloop.invert(tb.unet, tsched.make_schedule(steps),
                                           torch.from_numpy(x0), torch.from_numpy(emb),
                                           guidance_scale=guidance_scale)
    # The trajectory starts at x0 and takes steps - 1 steps; the final
    # latents are its last entry.
    assert got_traj.shape == (steps, *x0.shape)
    np.testing.assert_array_equal(got_traj[0].numpy(), x0)
    assert torch.equal(got_traj[-1], got_final)
    _close(got_final.numpy(), want_final)
    _close(got_traj.numpy(), want_traj)
    assert (got_final - got_traj[0]).abs().max() > 1e-2 * np.abs(x0).max()
