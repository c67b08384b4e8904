"""BoxDiff baseline (port of the JAX package's methods/boxdiff.py): one pass
over the overall prompt guided by BoxDiff's inner-box, outer-box and corner
constraints on its own attention keys (SD1.x: down_2_0/1, up_1_0/1/2), one
gradient step a step over the first 25 steps.
"""

from __future__ import annotations

import torch

from ..core import schedule as sched
from ..runtime import models as runtime_models
from ..sampling import boxdiff as boxdiff_lib
from ..sampling import guidance as guidance_lib
from ..sampling import latents as latents_lib
from ..sampling.loop import sample
from ..text import tokens as toklib
from ..text.parser import BOX_SCALE, convert_spec
from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT
from . import base

version = "boxdiff"


def run(
    spec,
    bundle,
    bg_seed: int = 1,
    overall_max_index_step: int = 25,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    negative_prompt: str = DEFAULT_OVERALL_NEGATIVE_PROMPT,
    guidance_attn_keys=None,
    scheduler: str = "ddim",
) -> base.GenerationResult:
    cfg = bundle.config
    if guidance_attn_keys is None:
        guidance_attn_keys = boxdiff_lib.default_boxdiff_keys(cfg.unet)
    converted = convert_spec(spec, *BOX_SCALE)
    phrases = [p for p, _, _ in converted.overall_phrases_words_bboxes]
    words = [w for _, w, _ in converted.overall_phrases_words_bboxes]
    bboxes = [b for _, _, b in converted.overall_phrases_words_bboxes]
    prompt = converted.overall_prompt
    negative_prompt = base.with_extra_negative(spec, negative_prompt)

    indices = toklib.get_phrase_indices(bundle.tokenizer, prompt, phrases, words=words)

    schedule = sched.make_schedule(num_inference_steps, solver=scheduler)
    uncond, cond = runtime_models.encode_prompts(bundle, [prompt], negative_prompt)

    spec_b = boxdiff_lib.BoxDiffSpec(keys=tuple(guidance_attn_keys),
                                     max_index_step=overall_max_index_step)
    data = guidance_lib.guidance_data_to_device(boxdiff_lib.make_boxdiff_data(
        bboxes, indices.object_positions, spec_b,
        (cfg.latent_height, cfg.latent_width), len(cfg.unet.block_out_channels)),
        bundle.device)

    shape = (1, cfg.latent_height, cfg.latent_width, 4)
    latents = latents_lib.noise_from_seed(bg_seed, shape) * schedule.init_noise_sigma

    out = sample(bundle.unet, schedule, torch.from_numpy(latents).to(bundle.device),
                 torch.cat([uncond, cond], dim=0), cond_embeddings=cond,
                 guidance_scale=guidance_scale, spec=spec_b, guidance_data=data,
                 solver=scheduler)
    images = base.decode_latents(bundle, out.latents)
    return base.GenerationResult(image=images[0])
