"""The denoising loop and DDIM inversion (port of the JAX package's
sampling/loop.py `sample` and `invert`).

One function covers plain CFG sampling, CA-energy guidance of one image or
of a batch of independent images (`guidance_batched`), BoxDiff's one-step
box-constraint guidance (a `BoxDiffSpec` as `spec`), GLIGEN scheduled
sampling and frozen-mask regeneration, on either VP-space solver: DDIM or
DPM-Solver++(2M), whose multistep state (the previous step's x0 and t)
carries across steps and segments; and plain CFG sampling on Euler, the
sigma-space solver of the SDXL refiner (the UNet takes the scaled input
x / sqrt(sigma^2 + 1); energy guidance is defined on the VP-space solvers
only and is refused there, as the JAX side asserts). `added_cond` (pooled
text embeddings, time ids), both (2B, ...) [uncond; cond], reaches the
UNet's text_time conditioning on both CFG halves. As on the JAX side the
run is cut into segments at the feature boundaries (guidance `max_index_step`, fuser
steps, frozen steps) and every step of a segment runs the same features;
here a segment is a plain Python loop over its steps. Each step: the
guidance (autograd through the early-exit, cond-only UNet), one
CFG-doubled UNet forward (saving taps when asked), the solver update, and
the frozen-mask splice.

`invert` runs DDIM inversion from x0 towards x_T with the reference's
conventions.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..core import schedule as sched
from ..nn.attention import NO_TAPS, AttnKey, TapSpec
from ..nn.unet import apply_unet
from ..utils import trace
from . import boxdiff as boxdiff_lib
from . import guidance as guidance_lib


class SampleOutput(NamedTuple):
    latents: torch.Tensor                 # (B, H, W, C) final
    all_latents: torch.Tensor | None      # (T+1, B, H, W, C) trajectory
    saved_taps: dict | None               # {AttnKey: (T, ...)} main-forward taps
    final_loss: torch.Tensor              # last guidance loss: (B,) batched, else ()


def _segment_boundaries(num_steps: int, *cuts: int) -> list[tuple[int, int]]:
    points = sorted({0, num_steps, *(min(max(c, 0), num_steps) for c in cuts)})
    return [(a, b) for a, b in zip(points[:-1], points[1:]) if b > a]


def _max_iter_list(max_iter, num_steps: int) -> list[int]:
    """Per-step iteration budgets; a scalar broadcasts, a short list extends
    with its last value."""
    if isinstance(max_iter, (int, float)):
        return [int(max_iter)] * num_steps
    return [int(max_iter[i]) if i < len(max_iter) else int(max_iter[-1])
            for i in range(num_steps)]


def sample(
    unet,
    schedule: sched.Schedule,
    latents: torch.Tensor,                 # (B, H, W, C)
    text_embeddings: torch.Tensor,         # (2B, L, D) [uncond; cond]
    *,
    cond_embeddings: torch.Tensor | None = None,
    guidance_scale: float = 7.5,
    spec: guidance_lib.GuidanceSpec | None = None,
    guidance_data: dict | None = None,     # one image's, or stacked when batched
    max_iter: Any = 5,
    ref_taps: dict | None = None,          # {key: (T, Bx, heads, n)}; batched (T, B, Bx, ...)
    gligen: tuple | None = None,           # (objs (2B, M, D), objs_guidance (B, M, D))
    num_fuser_steps: int = 0,
    frozen_mask: torch.Tensor | None = None,     # (H, W) or (B, H, W)
    frozen_latents: torch.Tensor | None = None,  # (>= frozen_steps + 1, B, H, W, C)
    num_frozen_steps: int = 0,
    save_all_latents: bool = False,
    save_keys: tuple[AttnKey, ...] = (),
    save_cond_only: bool = False,
    save_single_token: bool = False,
    tap_token_index=None,
    guidance_batched: bool = False,        # guidance_data has a leading image axis
    solver: str = "ddim",                  # "ddim" | "dpmpp_2m" | "euler"
    added_cond: tuple | None = None,       # (text_embeds (2B, D), time_ids (2B, K))
) -> SampleOutput:
    num_steps = schedule.num_steps
    has_guidance = spec is not None and guidance_data is not None
    guidance_steps = min(spec.max_index_step, num_steps) if has_guidance else 0
    fuser_steps = min(num_fuser_steps, num_steps) if gligen is not None else 0
    frozen_steps = min(num_frozen_steps, num_steps) if frozen_mask is not None else 0

    latents = latents.float()
    # The first guidance step always iterates (the reference's initial loss).
    loss = torch.full((latents.shape[0],) if guidance_batched else (), 10000.0,
                      dtype=torch.float32, device=latents.device)
    update = (guidance_lib.guidance_update_batched if guidance_batched
              else guidance_lib.guidance_update)
    budgets = _max_iter_list(max_iter, num_steps)
    save_tapspec = (TapSpec(keys=tuple(save_keys), cond_only=save_cond_only,
                            single_token=save_single_token)
                    if save_keys else NO_TAPS)
    if tap_token_index is not None:
        tap_token_index = trace.to_device(tap_token_index, latents.device,
                                          "tables_to_device")
    if frozen_mask is not None:
        fm = frozen_mask.float()
        fm = fm[None, :, :, None] if fm.dim() == 2 else fm[:, :, :, None]
    if solver not in ("ddim", "dpmpp_2m", "euler"):
        raise NotImplementedError(f"solver {solver!r} is not ported yet")
    if solver == "euler" and has_guidance:
        raise ValueError("energy guidance is defined on the VP-space solvers (ddim, "
                         "dpmpp_2m); the euler path serves the SDXL refiner, which has none")
    added = {}
    if added_cond is not None:
        added = {"added_text_embeds": added_cond[0], "added_time_ids": added_cond[1]}
    dpm_first = sched.dpm_lower_order_mask(num_steps)
    # DPM-Solver++'s multistep state: no history yet.
    prev_x0, prev_tc = torch.zeros_like(latents), -1000

    all_latents = [latents] if save_all_latents else None
    saved_taps: list = []

    for start, stop in _segment_boundaries(num_steps, guidance_steps, fuser_steps,
                                           frozen_steps):
        seg_guidance = has_guidance and start < guidance_steps
        seg_fuser = gligen is not None and start < fuser_steps
        seg_frozen = frozen_mask is not None and start < frozen_steps
        objs_full, objs_guidance = gligen if seg_fuser else (None, None)

        for i in range(start, stop):
            # Euler's grid is fractional (its step reads `sigmas`, not prev_t).
            t = float(schedule.timesteps[i]) if solver == "euler" else int(schedule.timesteps[i])
            prev_t = int(schedule.prev_timesteps[i])

            if seg_guidance:
                def unet_taps(lat, t=t):
                    # Early exit: blocks after the last tapped layer are
                    # dead for the loss, forward and backward.
                    return apply_unet(unet, lat, t, cond_embeddings,
                                      objs=objs_guidance, taps=spec.tap_spec,
                                      stop_after_taps=True)[1]

                with trace.annotate("guidance"):
                    if isinstance(spec, boxdiff_lib.BoxDiffSpec):
                        latents, loss = boxdiff_lib.boxdiff_update(
                            unet_taps, latents, step_index=i, num_steps=num_steps,
                            data=guidance_data, spec=spec)
                    else:
                        ref = ({k: v[i] for k, v in ref_taps.items()}
                               if ref_taps is not None else None)
                        latents, loss = update(
                            unet_taps, latents, loss,
                            step_size=sched.guidance_step_size(schedule, t, solver),
                            max_iter=budgets[i], data=guidance_data, spec=spec,
                            ref_taps=ref)

            with torch.no_grad():
                latent_in = torch.cat([latents, latents], dim=0)
                if solver == "euler":
                    latent_in = sched.euler_scale_model_input(latent_in, schedule.sigmas[i])
                eps, taps = apply_unet(
                    unet, latent_in, t, text_embeddings,
                    objs=objs_full, taps=save_tapspec,
                    tap_token_index=tap_token_index, **added)
                eps_uncond, eps_cond = eps.chunk(2, dim=0)
                eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
                if solver == "euler":
                    latents = sched.euler_step(eps, schedule.sigmas[i],
                                               schedule.sigmas[i + 1], latents)
                elif solver == "dpmpp_2m":
                    latents, prev_x0 = sched.dpmpp_2m_step(
                        schedule, eps, t, prev_t, latents, prev_x0, prev_tc,
                        force_first_order=bool(dpm_first[i]))
                    prev_tc = t
                else:
                    latents = sched.ddim_step(schedule, eps, t, prev_t, latents)
                if seg_frozen:
                    latents = frozen_latents[i + 1] * fm + latents * (1.0 - fm)

            if save_all_latents:
                all_latents.append(latents)
            if save_keys:
                saved_taps.append(taps)

    stacked_taps = None
    if save_keys:
        stacked_taps = {k: torch.stack([s[k] for s in saved_taps], dim=0)
                        for k in saved_taps[0]}
    return SampleOutput(
        latents=latents,
        all_latents=torch.stack(all_latents, dim=0) if save_all_latents else None,
        saved_taps=stacked_taps, final_loss=loss)


def invert(unet, schedule: sched.Schedule, latents: torch.Tensor,
           text_embeddings: torch.Tensor, guidance_scale: float = 7.5):
    """DDIM inversion x0 -> near x_T, with the reference's conventions (as the
    JAX package's `invert`): the ascending grid's first T - 1 entries are the
    step targets; each step predicts eps with the TARGET t's embedding on the
    source-level latents, the source noise level being target - train // T
    (a sub-zero first source maps to the final alpha). CFG when
    `guidance_scale` > 0, else one uncond-only forward. `text_embeddings`
    (2B, L, D) [uncond; cond]. Returns the final latents (at the grid's
    second-highest point: the reference stops one short) and the trajectory
    (T, B, H, W, C) ascending from the input x0."""
    ts = schedule.timesteps[::-1]                      # ascending
    ratio = len(schedule.alphas_cumprod) // schedule.num_steps
    latents = latents.float()
    trajectory = [latents]
    uncond = text_embeddings[: text_embeddings.shape[0] // 2]
    with torch.no_grad():
        for target in ts[:-1]:
            target = int(target)
            if guidance_scale > 0.0:
                eps = apply_unet(unet, torch.cat([latents, latents], dim=0), target,
                                 text_embeddings)[0]
                eps_uncond, eps_cond = eps.chunk(2, dim=0)
                eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
            else:
                eps = apply_unet(unet, latents, target, uncond)[0]
            latents = sched.ddim_inverse_step(schedule, eps, target - ratio, target,
                                              latents)
            trajectory.append(latents)
    return latents, torch.stack(trajectory, dim=0)
