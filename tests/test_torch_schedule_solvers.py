"""The port's DPM-Solver++(2M) schedule and steps, DDIM inversion's step,
the forward process and the Euler solver (grid, sigmas, step, input scale,
forward noise) (`lmdx_torch.core.schedule`) against the JAX package's
`lmdx.core.schedule`.

Grids and flags are integers and must be equal. Step values are held within
1e-6 of the largest value (f32 arithmetic in another order); the guidance
step sizes are scalars held within 1e-6 relative. Euler's float grids and
sigmas are held within 1e-6 of their largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.core import schedule as jsched
from lmdx_torch.core import schedule as tsched
from lmdx_torch.sampling import guidance as tguidance
from lmdx_torch.sampling import loop as tloop

STEPS = [6, 20, 50]


def _close(got, want, rel=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _state(seed, shape=(2, 8, 8, 4)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("fast_after", [None, 2])
@pytest.mark.parametrize("steps", STEPS)
def test_dpm_schedule_matches_jax(steps, fast_after):
    want = jsched.make_schedule(steps, fast_after_steps=fast_after, solver="dpmpp_2m")
    got = tsched.make_schedule(steps, fast_after_steps=fast_after, solver="dpmpp_2m")
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_array_equal(got.prev_timesteps, np.asarray(want.prev_timesteps))
    np.testing.assert_array_equal(got.alphas_cumprod, np.asarray(want.alphas_cumprod))
    assert np.float32(got.final_alpha_cumprod) == np.float32(want.final_alpha_cumprod)
    assert got.init_noise_sigma == want.init_noise_sigma
    # The DPM grid is linspaced, not DDIM's leading-spaced one.
    assert not np.array_equal(got.timesteps, tsched.make_schedule(steps).timesteps)


def test_euler_is_still_refused():
    # Euler is ported (the cases below); energy guidance on it is refused, as
    # the JAX side's sampler asserts: guidance is defined on the VP-space
    # solvers only.
    with pytest.raises(ValueError, match="VP-space"):
        tloop.sample(None, tsched.make_schedule(8, solver="euler"), torch.zeros(1, 4, 4, 4),
                     torch.zeros(2, 77, 8), spec=tguidance.GuidanceSpec(), guidance_data={},
                     solver="euler")


EULER_STEPS = [8, 50]


@pytest.mark.parametrize("steps", EULER_STEPS)
def test_euler_schedule_matches_jax(steps):
    want = jsched.make_schedule(steps, solver="euler")
    got = tsched.make_schedule(steps, solver="euler")
    np.testing.assert_array_equal(tsched.euler_timestep_grid(steps),
                                  jsched.euler_timestep_grid(steps))
    for name in ("timesteps", "prev_timesteps", "sigmas", "alphas_cumprod"):
        _close(getattr(got, name), getattr(want, name))
    assert np.float32(got.final_alpha_cumprod) == np.float32(want.final_alpha_cumprod)
    assert got.init_noise_sigma == pytest.approx(want.init_noise_sigma, rel=1e-6, abs=0)
    assert got.sigmas.shape == (steps + 1,) and got.sigmas[-1] == 0.0
    _close(tsched.euler_sigmas(got.alphas_cumprod, got.timesteps),
           jsched.euler_sigmas(np.asarray(want.alphas_cumprod), np.asarray(want.timesteps)))


@pytest.mark.parametrize("steps", EULER_STEPS)
def test_euler_step_input_scale_and_add_noise_match_jax(steps):
    js = jsched.make_schedule(steps, solver="euler")
    ts = tsched.make_schedule(steps, solver="euler")
    for i in range(steps):
        sample, eps, x0 = _state(steps * 10 + i)
        sigma, sigma_next = ts.sigmas[i], ts.sigmas[i + 1]
        jsig, jnext = js.sigmas[i], js.sigmas[i + 1]
        _close(tsched.euler_step(torch.from_numpy(eps), sigma, sigma_next,
                                 torch.from_numpy(sample)),
               jsched.euler_step(jnp.asarray(eps), jsig, jnext, jnp.asarray(sample)))
        _close(tsched.euler_scale_model_input(torch.from_numpy(sample), sigma),
               jsched.euler_scale_model_input(jnp.asarray(sample), jsig))
        _close(tsched.euler_add_noise(torch.from_numpy(x0), torch.from_numpy(eps), sigma),
               jsched.euler_add_noise(jnp.asarray(x0), jnp.asarray(eps), jsig))


@pytest.mark.parametrize("steps", [0, 1, 6, 14, 15, 50])
def test_dpm_lower_order_mask_matches_jax(steps):
    np.testing.assert_array_equal(tsched.dpm_lower_order_mask(steps),
                                  jsched.dpm_lower_order_mask(steps))


@pytest.mark.parametrize("mode", ["first", "second", "forced"])
@pytest.mark.parametrize("steps", STEPS)
def test_dpmpp_2m_step_matches_jax(steps, mode):
    js = jsched.make_schedule(steps, solver="dpmpp_2m")
    ts = tsched.make_schedule(steps, solver="dpmpp_2m")
    # Every step of the grid, the final one (towards t = 0) included.
    for i in range(1 if mode != "first" else 0, steps):
        t, nxt = int(ts.timesteps[i]), int(ts.prev_timesteps[i])
        prev_t = -1000 if mode == "first" else int(ts.timesteps[i - 1])
        sample, eps, prev_x0 = _state(steps * 100 + i)
        want = jsched.dpmpp_2m_step(js, jnp.asarray(eps), jnp.int32(t), jnp.int32(nxt),
                                    jnp.asarray(sample), jnp.asarray(prev_x0),
                                    jnp.int32(prev_t), force_first_order=mode == "forced")
        got = tsched.dpmpp_2m_step(ts, torch.from_numpy(eps), t, nxt,
                                   torch.from_numpy(sample), torch.from_numpy(prev_x0),
                                   prev_t, force_first_order=mode == "forced")
        for g, w in zip(got, want):
            _close(g, w)


def test_dpmpp_2m_second_order_uses_the_history():
    ts = tsched.make_schedule(20, solver="dpmpp_2m")
    sample, eps, prev_x0 = (torch.from_numpy(x) for x in _state(7))
    t, nxt, prev_t = int(ts.timesteps[3]), int(ts.prev_timesteps[3]), int(ts.timesteps[2])
    second = tsched.dpmpp_2m_step(ts, eps, t, nxt, sample, prev_x0, prev_t)[0]
    first = tsched.dpmpp_2m_step(ts, eps, t, nxt, sample, prev_x0, prev_t,
                                 force_first_order=True)[0]
    assert (second - first).abs().max() > 1e-3


@pytest.mark.parametrize("solver", ["ddim", "dpmpp_2m"])
def test_guidance_step_size_matches_jax(solver):
    js = jsched.make_schedule(50, solver=solver)
    ts = tsched.make_schedule(50, solver=solver)
    for t in [*ts.timesteps.tolist(), 0, -19]:
        want = float(jsched.guidance_step_size(js, jnp.int32(t), solver=solver))
        got = tsched.guidance_step_size(ts, t, solver)
        assert got == pytest.approx(want, rel=1e-6, abs=0), (t, got, want)


def test_ddim_inverse_step_matches_jax():
    js, ts = jsched.make_schedule(50), tsched.make_schedule(50)
    ratio = 1000 // 50
    for i, target in enumerate(ts.timesteps[::-1][:-1].tolist()):
        sample, eps, _ = _state(500 + i)
        want = jsched.ddim_inverse_step(js, jnp.asarray(eps), jnp.int32(target - ratio),
                                        jnp.int32(target), jnp.asarray(sample))
        got = tsched.ddim_inverse_step(ts, torch.from_numpy(eps), target - ratio, target,
                                       torch.from_numpy(sample))
        _close(got, want)


@pytest.mark.parametrize("t", [999, 501, 21, 1, 0, -19])
def test_add_noise_matches_jax(t):
    js, ts = jsched.make_schedule(50), tsched.make_schedule(50)
    x0, noise, _ = _state(t + 100)
    want = jsched.add_noise(js, jnp.asarray(x0), jnp.asarray(noise), jnp.int32(t))
    got = tsched.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(noise), t)
    _close(got, want)
