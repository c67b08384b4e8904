"""DDIM noise schedule and sampler step (port of the JAX core/schedule.py).

A schedule is a pair of static grids `(timesteps, prev_timesteps)` built on
the host with numpy, exactly as on the JAX side: scaled-linear betas
(0.00085 .. 0.012, 1000 train steps), leading-spaced DDIM grid with
steps_offset 1, final step to alpha_cumprod[0]. The step math runs in f32 on
whatever device the sample lives on. DPM-Solver++ and Euler are not ported
yet.
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
    if solver != "ddim":
        raise NotImplementedError(f"solver {solver!r} is not ported yet")
    alphas_cumprod = make_alphas_cumprod(num_train_timesteps)
    timesteps = ddim_timestep_grid(num_inference_steps, num_train_timesteps)
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


def guidance_step_size(schedule: Schedule, t: int) -> float:
    """sqrt(1 - alpha_cumprod[t]): the DDIM energy-guidance step factor."""
    return float(np.sqrt(np.float32(1.0) - np.float32(alpha_at(schedule, t))))
