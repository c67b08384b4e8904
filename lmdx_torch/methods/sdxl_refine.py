"""Image refinement (img2img), the SDXL-refiner stage (port of the JAX
package's methods/sdxl_refine.py).

`refine` upscales a grounded image to the refiner's resolution (PIL LANCZOS,
on the host) and runs `img2img` at strength `refinement_step_ratio` with the
style negative prompt after the spec's extra negatives. `img2img` is
architecture-agnostic: it encodes the image with the bundle's VAE, noises it
at the strength point of the grid and denoises the tail, with text_time
conditioning where the UNet has it (the refiner: 5 ids, the aesthetic score
6.0 for the prompt and 2.5 for the negative one).

The refiner bundle (`load_refiner_bundle`) is the SDXL refiner
(stabilityai/stable-diffusion-xl-refiner-1.0: one OpenCLIP bigG tower, the
text_time UNet, EulerDiscrete, 1024x1024) unless LMDX_REFINER_MODEL names
another configuration: the SDXL base (stabilityai/stable-diffusion-xl-base-1.0:
two towers, the base's 6 time ids, DDIM), or `tiny-sdxl` / `tiny-sdxl-base`
for CPU tests. It is built at its
configuration's bfloat16 with the default `KernelOptions()`, whatever the
stage-2 bundle's precision, as the JAX side's loader passes no dtype; it
reads `$LMDX_CHECKPOINT_DIR/<model--key>` as `load_bundle` does.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from ..core import schedule as sched
from ..runtime import models as runtime_models
from ..sampling import latents as latents_lib
from ..sampling.loop import sample
from . import base

version = "sdxl_refine"

SDXL_NEGATIVE_PROMPT = (
    "drawing, painting, crayon, sketch, graphite, impressionist, noisy, "
    "blurry, soft, deformed, ugly"
)

_REFINER_CACHE: dict = {}


def load_refiner_bundle(device=None):
    """The refiner bundle of LMDX_REFINER_MODEL (default the SDXL refiner) on
    `device` (`cuda` unless named), built once per key and device."""
    key = os.environ.get("LMDX_REFINER_MODEL",
                         "stabilityai/stable-diffusion-xl-refiner-1.0")
    device = runtime_models.resolve_device(device)
    if (key, device) not in _REFINER_CACHE:
        _REFINER_CACHE[key, device] = runtime_models.load_bundle(key, device=device)
    return _REFINER_CACHE[key, device]


def _time_ids(bundle, h: int, w: int) -> torch.Tensor:
    """(2, K) [uncond; cond] micro-conditioning ids: the refiner's 5 (size,
    crop, aesthetic score 2.5 / 6.0) or the base's 6 (size, crop, target)."""
    ucfg = bundle.config.unet
    num_ids = ((ucfg.projection_class_embeddings_input_dim - bundle.config.pooled_dim)
               // ucfg.addition_time_embed_dim)
    if num_ids == 5:
        ids = [[h, w, 0, 0, 2.5], [h, w, 0, 0, 6.0]]
    else:
        ids = [[h, w, 0, 0, h, w]] * 2
    return torch.tensor(ids, dtype=torch.float32, device=bundle.device)


@torch.no_grad()
def img2img(bundle, image: np.ndarray, prompt: str, negative_prompt: str = "",
            strength: float = 0.3, num_inference_steps: int = 50,
            guidance_scale: float = 5.0, seed: int = 0, return_latents: bool = False,
            scheduler: str | None = None) -> np.ndarray:
    """Noise the encoded image (a uint8 (H, W, 3) at the bundle's size) at the
    strength point of the grid and denoise the remaining steps, with the JAX
    side's rule: start = min(max(n - int(n * strength), 0), n - 1). The VAE
    posterior's noise comes from `seed + 1`, the forward noise from `seed`.
    `scheduler` None takes the bundle's `default_scheduler` (Euler for the
    refiner). `return_latents` skips the decode and returns the final
    (1, h, w, 4) latents."""
    scheduler = scheduler or bundle.config.default_scheduler
    schedule = sched.make_schedule(num_inference_steps, solver=scheduler)
    start = max(num_inference_steps - int(num_inference_steps * strength), 0)
    start = min(start, num_inference_steps - 1)

    shape = (1,) + tuple(np.array(image.shape[:2]) // bundle.config.vae_scale) + (4,)
    latents0 = base.encode_image(bundle, image,
                                 noise=latents_lib.noise_from_seed(seed + 1, shape))
    noise = torch.as_tensor(latents_lib.noise_from_seed(seed, tuple(latents0.shape)),
                            device=bundle.device)
    if scheduler == "euler":
        latents = sched.euler_add_noise(latents0, noise, schedule.sigmas[start])
    else:
        latents = sched.add_noise(schedule, latents0, noise, int(schedule.timesteps[start]))
    tail = schedule._replace(
        timesteps=schedule.timesteps[start:], prev_timesteps=schedule.prev_timesteps[start:],
        sigmas=schedule.sigmas[start:] if scheduler == "euler" else None)

    cond, cond_pooled = runtime_models.encode_text(bundle, [prompt])
    uncond, uncond_pooled = runtime_models.encode_text(bundle, [negative_prompt])
    added_cond = None
    if bundle.config.unet.addition_embed_type == "text_time":
        h, w = image.shape[:2]
        added_cond = (torch.cat([uncond_pooled, cond_pooled], dim=0), _time_ids(bundle, h, w))
    out = sample(bundle.unet, tail, latents, torch.cat([uncond, cond], dim=0),
                 guidance_scale=guidance_scale, added_cond=added_cond, solver=scheduler)
    if return_latents:
        return out.latents.cpu().numpy()
    return base.decode_latents(bundle, out.latents)[0]


def refine(image: np.ndarray, spec, refine_seed: int, refinement_step_ratio: float = 0.3,
           bundle=None, target_size: int | None = None) -> np.ndarray:
    """Upscale (LANCZOS) to `target_size` (default the refiner's height) and
    refine by `img2img` with the negative prompt "<extra>, <style>" (the
    reference always prepends the spec's extra negatives and ", ", empty or
    not). `bundle` defaults to `load_refiner_bundle()`."""
    bundle = bundle or load_refiner_bundle()
    if target_size is None:
        target_size = bundle.config.height
    prompt = base.spec_get(spec, "prompt")
    extra = base.spec_get(spec, "extra_neg_prompt", "")
    negative = f"{extra}, {SDXL_NEGATIVE_PROMPT}"
    upscaled = np.array(
        Image.fromarray(image).resize((target_size, target_size), Image.LANCZOS))
    return img2img(bundle, upscaled, prompt, negative_prompt=negative,
                   strength=refinement_step_ratio, seed=refine_seed)
