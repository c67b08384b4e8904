"""MultiDiffusion region-control baseline (port of the JAX package's
methods/multidiffusion.py).

Each step denoises every region (the background, then one per box) over
sliding latent views and recombines the regions' DDIM updates, weighted by
their exclusive masks. The first `bootstrapping` steps replace each box
region's outside with a random constant-color background, VAE-encoded and
noised to the step's level. Every region has its own prompt and negative
prompt, and by default its own unconditional prediction (`indep_uncond`).
The regions are one UNet batch of 2 x regions (CFG); one 64x64 view covers
a 512x512 image, panoramas slide a grid of views.

All randomness (the initial latent, the background colors, the bootstrap
noise, one draw of background indices per bootstrap step, shared by the
step's views) comes from `draw_randomness`, from one `torch.Generator` on
the bundle's device seeded with `seed`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import boxes as boxlib
from ..core import schedule as sched
from ..nn.unet import apply_unet
from ..runtime import models as runtime_models
from ..text.parser import BOX_SCALE, filter_boxes
from . import base

version = "multidiffusion"

BG_NEGATIVE = (
    "artifacts, blurry, smooth texture, bad quality, distortions, unrealistic, "
    "distorted image, bad proportions, duplicate, headshot, close-up, partial, "
    "large, large, huge, gigantic"
)
FG_NEGATIVE = BG_NEGATIVE + ", cut-out, partial, occluded, weird"


def get_views(height: int, width: int, window_size: int = 64, stride: int = 8,
              vae_scale: int = 8):
    """Sliding latent views (h0, h1, w0, w1)."""
    h, w = height // vae_scale, width // vae_scale
    window_size = min(window_size, h, w)
    num_h = (h - window_size) // stride + 1
    num_w = (w - window_size) // stride + 1
    views = []
    for i in range(int(num_h * num_w)):
        h_start = int(i // num_w) * stride
        w_start = int(i % num_w) * stride
        views.append((h_start, h_start + window_size, w_start, w_start + window_size))
    return views


def boxes_to_masks_prompts(gen_boxes, H: int, W: int, first_top: bool = False):
    """Exclusive per-box masks at latent resolution: each pixel belongs to one
    box, the last painted (`first_top` paints in reverse, so the first box
    wins). Returns (masks [(H, W) f32], prompts) in the boxes' order."""
    boxes = list(gen_boxes)
    if first_top:
        boxes = boxes[::-1]
    inds = np.full((H, W), -1, np.int32)
    prompts = []
    for ind, (name, bbox) in enumerate(boxes):
        x0, y0, x1, y1 = boxlib.scale_proportion(
            boxlib.convert_box_xywh_to_xyxy_norm(bbox, *BOX_SCALE), H=H, W=W)
        inds[y0:y1, x0:x1] = ind
        prompts.append(name)
    masks = [(inds == i).astype(np.float32) for i in range(len(boxes))]
    if first_top:
        masks, prompts = masks[::-1], prompts[::-1]
    return masks, prompts


class Draws(NamedTuple):
    latent: torch.Tensor              # (1, H, W, 4) f32 standard normal
    colors: torch.Tensor | None       # (backgrounds, 1, 1, 3) uniform in [-1, 1)
    noise: torch.Tensor | None        # (boxes, H, W, 4) f32 standard normal
    bg_idx: torch.Tensor | None       # (bootstrap steps, boxes) int64 in [0, backgrounds)


def draw_randomness(seed: int, device, latent_shape, num_backgrounds: int,
                    num_boxes: int, bootstrap_steps: int) -> Draws:
    """Every random value of one run, from one generator seeded with `seed`.
    Without bootstrap steps only the latent is drawn."""
    g = torch.Generator(device=device).manual_seed(seed)
    latent = torch.randn(latent_shape, generator=g, device=device)
    if not bootstrap_steps:
        return Draws(latent, None, None, None)
    colors = torch.rand((num_backgrounds, 1, 1, 3), generator=g, device=device) * 2.0 - 1.0
    noise = torch.randn((num_boxes, *latent_shape[1:]), generator=g, device=device)
    bg_idx = torch.randint(0, num_backgrounds, (bootstrap_steps, num_boxes), generator=g,
                           device=device)
    return Draws(latent, colors, noise, bg_idx)


@torch.no_grad()
def _step(unet, schedule, latent, t: int, prev_t: int, views, masks, text_embeddings,
          guidance_scale: float, indep_uncond: bool, normalization: bool,
          bootstrap=None):
    """One MultiDiffusion step. latent (1, H, W, C); masks (R, H, W, 1);
    bootstrap: None or (backgrounds (R - 1, H, W, C) of this step, their
    noise (R - 1, H, W, C))."""
    num_regions = masks.shape[0]
    value = torch.zeros_like(latent)
    count = torch.zeros_like(latent)
    for h0, h1, w0, w1 in views:
        masks_view = masks[:, h0:h1, w0:w1, :]
        latent_view = latent[:, h0:h1, w0:w1, :].expand(num_regions, -1, -1, -1)
        if bootstrap is not None:
            bgs, noise = bootstrap
            bg = sched.add_noise(schedule, bgs[:, h0:h1, w0:w1, :],
                                 noise[:, h0:h1, w0:w1, :], t)
            m = (masks_view[1:] >= 0.5).to(latent.dtype)
            fg = latent_view[1:] * m + bg * (1.0 - m)
            latent_view = torch.cat([latent_view[:1], fg], dim=0)

        eps = apply_unet(unet, torch.cat([latent_view, latent_view], dim=0), t,
                         text_embeddings)[0]
        eps_uncond, eps_text = eps.chunk(2, dim=0)
        if indep_uncond:
            eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        else:
            eps = eps_uncond[:1] + guidance_scale * (eps_text - eps_uncond)

        denoised = sched.ddim_step(schedule, eps, t, prev_t, latent_view)
        value[:, h0:h1, w0:w1, :] += (denoised * masks_view).sum(dim=0, keepdim=True)
        if normalization:
            count[:, h0:h1, w0:w1, :] += masks_view.sum(dim=0, keepdim=True)
        else:
            count = torch.ones_like(count)
    return torch.where(count > 0, value / torch.clamp(count, min=1e-8), value)


def run(
    spec=None,
    bundle=None,
    gen_boxes=None,
    bg_prompt: str = "",
    original_ind_base: int | None = None,
    bootstrapping: int = 20,
    first_top: bool = False,
    steps: int = 50,
    guidance_scale: float = 10.0,
    extra_neg_prompt: str = "",
    indep_uncond: bool = True,
    normalization: bool = False,
    bg_seed: int | None = None,
    num_inference_steps: int | None = None,
) -> base.GenerationResult:
    # A layout spec (the methods' common interface) or explicit gen_boxes and
    # bg_prompt (the reference's signature).
    if spec is not None:
        gen_boxes = base.spec_get(spec, "gen_boxes", gen_boxes)
        bg_prompt = base.spec_get(spec, "bg_prompt", bg_prompt)
        extra_neg_prompt = base.spec_get(spec, "extra_neg_prompt", extra_neg_prompt)
    if bg_seed is not None and original_ind_base is None:
        original_ind_base = bg_seed
    if num_inference_steps is not None:
        steps = num_inference_steps
    seed = original_ind_base if original_ind_base is not None else 0

    cfg = bundle.config
    device = bundle.device
    H, W = cfg.latent_height, cfg.latent_width

    gen_boxes = filter_boxes(gen_boxes)
    bg_negative = f"{extra_neg_prompt}, {BG_NEGATIVE}" if extra_neg_prompt else BG_NEGATIVE
    fg_negative = f"{extra_neg_prompt}, {FG_NEGATIVE}" if extra_neg_prompt else FG_NEGATIVE

    fg_masks, fg_prompts = boxes_to_masks_prompts(gen_boxes, H, W, first_top=first_top)
    bg_mask = np.clip(1.0 - sum(fg_masks, np.zeros((H, W), np.float32)), 0, 1)
    masks = torch.as_tensor(np.stack([bg_mask, *fg_masks])[..., None], dtype=torch.float32,
                            device=device)                      # (R, H, W, 1)

    prompts = [bg_prompt] + fg_prompts
    neg_prompts = [bg_negative] + [fg_negative] * len(fg_prompts)
    cond, _ = runtime_models.encode_text(bundle, prompts)
    uncond, _ = runtime_models.encode_text(bundle, neg_prompts)
    text_embeddings = torch.cat([uncond, cond], dim=0)

    schedule = sched.make_schedule(steps)
    bootstrap_steps = min(bootstrapping, steps) if fg_prompts else 0
    draws = draw_randomness(seed, device, (1, H, W, 4), bootstrapping, len(fg_prompts),
                            bootstrap_steps)
    latent = draws.latent * schedule.init_noise_sigma
    if bootstrap_steps:
        # Random constant-color backgrounds through the VAE encoder.
        bg_images = draws.colors.expand(bootstrapping, cfg.height, cfg.width, 3)
        bootstrap_bgs = base._vae_encode(bundle, bg_images)

    views = get_views(cfg.height, cfg.width, vae_scale=cfg.vae_scale)
    for i in range(steps):
        bootstrap = ((bootstrap_bgs[draws.bg_idx[i]], draws.noise)
                     if i < bootstrap_steps else None)
        latent = _step(bundle.unet, schedule, latent, int(schedule.timesteps[i]),
                       int(schedule.prev_timesteps[i]), views, masks, text_embeddings,
                       guidance_scale, indep_uncond, normalization, bootstrap)

    images = base.decode_latents(bundle, latent)
    return base.GenerationResult(image=images[0], aux={"masks": fg_masks})
