"""Seeded latent noise and foreground/background blending (port of the JAX
sampling/latents.py).

`noise_from_seed` draws with `torch.manual_seed(seed)` + `randn` in NCHW on the
CPU and transposes to NHWC — the reference's noise stream, bit-identical to
the JAX side's `backend="torch"` path. Noise is drawn in f32 and cast after.
Results live on the host (numpy); callers move them to the device.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_COLLISION_BUMP = 12345


def noise_from_seed(seed: int, shape) -> np.ndarray:
    """Standard-normal (B, H, W, C) f32 noise for an integer seed."""
    b, h, w, c = shape
    generator = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=generator, dtype=torch.float32)
    return x.numpy().transpose(0, 2, 3, 1)


def blend_latents(latents_bg: np.ndarray, latents_fg: np.ndarray,
                  fg_mask: np.ndarray, fg_blending_ratio: float = 0.01) -> np.ndarray:
    """bg outside the mask; inside bg*sqrt(1-r) + fg*sqrt(r) (unit variance).
    fg_mask: (H, W)."""
    m = np.asarray(fg_mask, np.float32)[..., None]
    mixed = (latents_bg * np.float32(np.sqrt(1.0 - fg_blending_ratio))
             + latents_fg * np.float32(np.sqrt(fg_blending_ratio)))
    return latents_bg * (np.float32(1.0) - m) + mixed * m


def get_input_latents_list(bg_seed: int, fg_seed_start: int, fg_masks,
                           latent_shape, fg_blending_ratio: float = 0.01,
                           init_noise_sigma: float = 1.0):
    """Per-box input latents (box idx seeded fg_seed_start + idx, bumped on a
    collision with bg_seed, blended inside its mask) and the shared
    background latents."""
    latents_bg_raw = noise_from_seed(bg_seed, latent_shape)
    input_latents = []
    for idx, fg_mask in enumerate(fg_masks):
        fg_seed = fg_seed_start + idx
        if fg_seed == bg_seed:
            fg_seed += SEED_COLLISION_BUMP
        latents_fg = noise_from_seed(fg_seed, latent_shape)
        blended = blend_latents(latents_bg_raw, latents_fg, fg_mask,
                                fg_blending_ratio=fg_blending_ratio)
        input_latents.append(blended * np.float32(init_noise_sigma))
    return input_latents, latents_bg_raw * np.float32(init_noise_sigma)
