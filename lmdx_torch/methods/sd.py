"""Plain Stable Diffusion baseline (port of the JAX package's methods/sd.py):
CFG sampling of the overall prompt against the overall negative prompt. The
layout's boxes are ignored by design: this is the ungrounded control.
"""

from __future__ import annotations

import torch

from ..core import schedule as sched
from ..runtime import models as runtime_models
from ..sampling import latents as latents_lib
from ..sampling.loop import sample
from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT
from . import base

version = "sd"


def run(
    spec,
    bundle,
    bg_seed: int = 1,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    negative_prompt: str = DEFAULT_OVERALL_NEGATIVE_PROMPT,
    batch_size: int = 1,
    scheduler: str = "ddim",
) -> base.GenerationResult:
    prompt = base.spec_get(spec, "prompt")
    negative_prompt = base.with_extra_negative(spec, negative_prompt)

    schedule = sched.make_schedule(num_inference_steps, solver=scheduler)
    uncond, cond = runtime_models.encode_prompts(bundle, [prompt] * batch_size,
                                                 negative_prompt)
    cfg = bundle.config
    shape = (batch_size, cfg.latent_height, cfg.latent_width, 4)
    latents = latents_lib.noise_from_seed(bg_seed, shape) * schedule.init_noise_sigma

    out = sample(bundle.unet, schedule, torch.from_numpy(latents).to(bundle.device),
                 torch.cat([uncond, cond], dim=0), guidance_scale=guidance_scale,
                 solver=scheduler)
    images = base.decode_latents(bundle, out.latents)
    return base.GenerationResult(image=images[0])
