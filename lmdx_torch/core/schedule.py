"""Noise schedules and sampler steps of the two VP-space solvers, DDIM and
DPM-Solver++(2M) (port of the JAX core/schedule.py).

A schedule is a pair of static grids `(timesteps, prev_timesteps)` built on
the host with numpy, exactly as on the JAX side: scaled-linear betas
(0.00085 .. 0.012, 1000 train steps), final step to alpha_cumprod[0]; DDIM
takes the leading-spaced grid with steps_offset 1, DPM-Solver++(2M)
diffusers' linspace grid. The step math runs in f32 on whatever device the
sample lives on: `ddim_step`, `dpmpp_2m_step` (with the lower-order-final
rule of `dpm_lower_order_mask`), `ddim_inverse_step` for inversion and
`add_noise` for the forward process. The Euler solver (sigma-space, the
SDXL refiner's) is not ported yet: `make_schedule(solver="euler")` raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    timesteps: np.ndarray         # (T,) int64 descending
    prev_timesteps: np.ndarray    # (T,); < 0 means the final step
    alphas_cumprod: np.ndarray    # (num_train_timesteps,) float32
    final_alpha_cumprod: float
    init_noise_sigma: float = 1.0

    @property
    def num_steps(self) -> int:
        return int(self.timesteps.shape[0])


def make_alphas_cumprod(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timestep_grid(num_inference_steps: int, num_train_timesteps: int = 1000,
                       steps_offset: int = 1) -> np.ndarray:
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    return (timesteps + steps_offset).astype(np.int64)


def dpm_timestep_grid(num_inference_steps: int,
                      num_train_timesteps: int = 1000) -> np.ndarray:
    """DPMSolverMultistep's grid (diffusers 0.18 set_timesteps): n + 1 points
    linspaced over [0, T - 1], rounded, descending, the last dropped."""
    return (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
            .round()[::-1][:-1].astype(np.int64))


def fast_schedule_timesteps(timesteps: np.ndarray, fast_after_steps: int,
                            fast_rate: int) -> np.ndarray:
    """Full resolution up to `fast_after_steps`, then every `fast_rate`-th."""
    if fast_after_steps >= len(timesteps) - 1:
        return timesteps
    return np.concatenate([timesteps[:fast_after_steps],
                           timesteps[fast_after_steps + 1 :: fast_rate]])


def make_schedule(num_inference_steps: int, num_train_timesteps: int = 1000,
                  fast_after_steps: int | None = None, fast_rate: int = 2,
                  solver: str = "ddim") -> Schedule:
    if solver == "dpmpp_2m":
        timesteps = dpm_timestep_grid(num_inference_steps, num_train_timesteps)
    elif solver == "ddim":
        timesteps = ddim_timestep_grid(num_inference_steps, num_train_timesteps)
    else:
        raise NotImplementedError(f"solver {solver!r} is not ported yet")
    alphas_cumprod = make_alphas_cumprod(num_train_timesteps)
    if fast_after_steps is not None:
        timesteps = fast_schedule_timesteps(timesteps, fast_after_steps, fast_rate)
    if len(timesteps) > 1:
        last_gap = int(timesteps[-2] - timesteps[-1])
    else:
        last_gap = num_train_timesteps // num_inference_steps
    prev = np.concatenate([timesteps[1:], [timesteps[-1] - last_gap]])
    return Schedule(timesteps=timesteps, prev_timesteps=prev,
                    alphas_cumprod=alphas_cumprod,
                    final_alpha_cumprod=float(alphas_cumprod[0]))


def alpha_at(schedule: Schedule, t: int) -> float:
    """alphas_cumprod[t] as an f32 value, mapping t < 0 to the final alpha."""
    t = int(t)
    if t < 0:
        return float(np.float32(schedule.final_alpha_cumprod))
    return float(schedule.alphas_cumprod[min(t, len(schedule.alphas_cumprod) - 1)])


def ddim_step(schedule: Schedule, eps: torch.Tensor, t: int, prev_t: int,
              sample: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM update x_t -> x_{prev_t} (eta 0, epsilon
    prediction, no clipping), computed in f32."""
    dtype = sample.dtype
    a_t = torch.tensor(alpha_at(schedule, t), dtype=torch.float32)
    a_prev = torch.tensor(alpha_at(schedule, prev_t), dtype=torch.float32)
    sample32 = sample.float()
    eps32 = eps.float()
    x0 = (sample32 - torch.sqrt(1.0 - a_t) * eps32) / torch.sqrt(a_t)
    out = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps32
    return out.to(dtype)


def ddim_inverse_step(schedule: Schedule, eps: torch.Tensor, t: int, next_t: int,
                      sample: torch.Tensor) -> torch.Tensor:
    """One DDIM inversion update x_t -> x_{next_t} (next_t > t), in f32."""
    return ddim_step(schedule, eps, t, next_t, sample)


def add_noise(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor,
              t: int) -> torch.Tensor:
    """The forward process q(x_t | x_0): sqrt(a) x0 + sqrt(1 - a) noise."""
    a_t = torch.tensor(alpha_at(schedule, t), dtype=torch.float32)
    out = torch.sqrt(a_t) * x0.float() + torch.sqrt(1.0 - a_t) * noise.float()
    return out.to(x0.dtype)


def guidance_step_size(schedule: Schedule, t: int, solver: str = "ddim") -> float:
    """The energy-guidance step factor at t: sqrt(1 - a) for DDIM; for
    DPM-Solver++ sigma_t^2 = (1 - a) / max(a, 1e-10), the reference's
    scheduler.sigmas[i]**2. f32 arithmetic, as on the JAX side."""
    a = np.float32(alpha_at(schedule, t))
    if solver == "dpmpp_2m":
        return float((np.float32(1.0) - a) / np.maximum(a, np.float32(1e-10)))
    return float(np.sqrt(np.float32(1.0) - a))


def _alpha_sigma_lambda(schedule: Schedule, t: int):
    """(alpha_t, sigma_t, lambda_t) as f32 scalar tensors: sqrt(a),
    sqrt(1 - a), log(alpha) - log(max(sigma, 1e-10))."""
    a = torch.tensor(alpha_at(schedule, t), dtype=torch.float32)
    alpha, sigma = torch.sqrt(a), torch.sqrt(1.0 - a)
    lam = torch.log(alpha) - torch.log(torch.clamp(sigma, min=1e-10))
    return alpha, sigma, lam


def dpmpp_2m_step(schedule: Schedule, eps: torch.Tensor, t: int, next_t: int,
                  sample: torch.Tensor, prev_x0: torch.Tensor, prev_t: int,
                  force_first_order: bool = False):
    """One DPM-Solver++(2M) update x_t -> x_{next_t} (diffusers
    DPMSolverMultistep, algorithm "dpmsolver++", order 2), in f32.

    (prev_x0, prev_t) is the previous step's state; prev_t < -500 means no
    history and gives the first-order update, as does `force_first_order`
    (the lower-order-final rule). Returns (new_sample, x0); the caller
    carries (x0, t) into the next step."""
    alpha_t, sigma_t, lam_t = _alpha_sigma_lambda(schedule, t)
    alpha_s, sigma_s, lam_s = _alpha_sigma_lambda(schedule, next_t)
    sample32 = sample.float()
    x0 = (sample32 - sigma_t * eps.float()) / alpha_t
    h = lam_s - lam_t
    if prev_t < -500 or force_first_order:
        d = x0
    else:
        _, _, lam_p = _alpha_sigma_lambda(schedule, max(prev_t, 0))
        r0 = (lam_t - lam_p) / (h if float(h) != 0.0 else torch.tensor(1e-10))
        coeff = 1.0 / torch.clamp(2.0 * r0, min=1e-10)
        d = (1.0 + coeff) * x0 - coeff * prev_x0.float()
    out = (sigma_s / sigma_t) * sample32 - alpha_s * (torch.exp(-h) - 1.0) * d
    return out.to(sample.dtype), x0.to(sample.dtype)


def dpm_lower_order_mask(num_steps: int) -> np.ndarray:
    """Per-step first-order flags of DPM-Solver++(2M): diffusers'
    lower_order_final rule drops the final step to first order when the run
    has fewer than 15 steps."""
    mask = np.zeros((num_steps,), bool)
    if 0 < num_steps < 15:
        mask[-1] = True
    return mask
