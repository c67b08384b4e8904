"""GLIGEN baseline (port of the JAX package's methods/gligen.py): one
scheduled-sampling GLIGEN pass over the overall prompt, grounded by the
per-box prompts at the spec's boxes; no energy guidance.
"""

from __future__ import annotations

import torch

from ..core import schedule as sched
from ..runtime import models as runtime_models
from ..sampling import latents as latents_lib
from ..sampling.loop import sample
from ..text.parser import BOX_SCALE, convert_spec
from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT
from . import base

version = "gligen"


def run(
    spec,
    bundle,
    bg_seed: int = 1,
    gligen_scheduled_sampling_beta: float = 0.4,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    negative_prompt: str = DEFAULT_OVERALL_NEGATIVE_PROMPT,
    scheduler: str = "ddim",
) -> base.GenerationResult:
    cfg = bundle.config
    converted = convert_spec(spec, *BOX_SCALE)
    phrases = [item[0] for item in converted.so_prompt_phrase_word_box]
    bboxes = [item[3] for item in converted.so_prompt_phrase_word_box]
    negative_prompt = base.with_extra_negative(spec, negative_prompt)

    schedule = sched.make_schedule(num_inference_steps, solver=scheduler)
    uncond, cond = runtime_models.encode_prompts(bundle, [converted.overall_prompt],
                                                 negative_prompt)
    gligen_inputs = base.make_gligen_inputs(bundle, bboxes, phrases)

    shape = (1, cfg.latent_height, cfg.latent_width, 4)
    latents = latents_lib.noise_from_seed(bg_seed, shape) * schedule.init_noise_sigma

    out = sample(bundle.unet, schedule, torch.from_numpy(latents).to(bundle.device),
                 torch.cat([uncond, cond], dim=0), guidance_scale=guidance_scale,
                 gligen=gligen_inputs,
                 num_fuser_steps=int(gligen_scheduled_sampling_beta * schedule.num_steps),
                 solver=scheduler)
    images = base.decode_latents(bundle, out.latents)
    return base.GenerationResult(image=images[0])
