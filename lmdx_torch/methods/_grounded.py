"""LMD and LMD+ for one layout (port of the JAX package's
methods/_grounded.py: `GroundedParams`, `_make_guidance_spec`,
`run_grounded`; defaults = LMD, LMD+ overrides in methods/lmd_plus.py).

`run_grounded` runs the skeleton both methods share:

1. the layout spec becomes per-box and overall prompts;
2. every box runs in ONE batched per-box pass (batch = box count), saving its
   latent trajectory and word-token attention; LMD guides each box with its
   own CA energy (batched guidance, each box converging on its own), LMD+
   grounds each box with GLIGEN;
3. the per-box images are decoded when they are returned or the segmenter
   needs pixels, and ONE segmenter call refines every box's mask: prompted
   with the box under LMD+, with the peak of the box's aggregated attention
   under LMD;
4. the trajectories are composed under the masks on the host (largest
   first, optionally shifted onto the overall boxes, the reference taps with
   them);
5. the overall pass regenerates the image with the foreground frozen for
   the first `frozen_step_ratio` of the steps, single-image CA-energy
   guidance with reference-attention transfer and, under LMD+, GLIGEN over
   every overall box.

A layout without boxes samples the background noise alone. The batched
variant over many layouts is methods/batch.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import boxes as boxlib
from ..core import schedule as sched
from ..runtime import models as runtime_models
from ..sampling import compose as compose_lib
from ..sampling import guidance as guidance_lib
from ..sampling import latents as latents_lib
from ..sampling import masking
from ..sampling.loop import sample
from ..text import tokens as toklib
from ..text.parser import BOX_SCALE, convert_spec
from ..utils import trace
from . import base


@dataclass
class GroundedParams:
    bg_seed: int = 1
    fg_seed_start: int = 20
    overall_prompt_override: str = ""
    frozen_step_ratio: float = 0.5
    num_inference_steps: int = 50
    guidance_scale: float = 7.5

    loss_scale: float = 5.0
    loss_threshold: float = 5.0
    max_iter: object = None  # default ladder set in __post_init__
    max_index_step: int = 30
    overall_loss_scale: float = 5.0
    overall_loss_threshold: float = 5.0
    overall_max_iter: object = None
    overall_max_index_step: int = 30

    fg_top_p: float = 0.2
    bg_top_p: float = 0.2
    overall_fg_top_p: float = 0.2
    overall_bg_top_p: float = 0.2
    fg_weight: float = 1.0
    bg_weight: float = 4.0
    overall_fg_weight: float = 1.0
    overall_bg_weight: float = 4.0
    ref_ca_loss_weight: float = 2.0

    so_center_box: bool = True
    so_horizontal_center_only: bool = False
    so_vertical_placement: str = "floor_padding"
    so_floor_padding: float = 0.2
    fg_blending_ratio: float = 0.01
    align_with_overall_bboxes: bool = True
    horizontal_shift_only: bool = False
    use_fast_schedule: bool = False
    fast_rate: int = 2
    use_ref_ca: bool = True
    scheduler: str = "ddim"

    so_negative_prompt: str = ""
    overall_negative_prompt: str = ""

    use_gligen: bool = False
    so_gligen_scheduled_sampling_beta: float = 0.4
    overall_gligen_scheduled_sampling_beta: float = 0.4

    use_box_input: bool = False
    mask_th_for_point: float = 0.25

    # None -> derived from the UNet topology.
    guidance_attn_keys: tuple | None = None
    obj_attn_key: tuple | None = None
    attn_aggregation_step_start: int = 10

    def __post_init__(self):
        default_iters = [4] * 5 + [3] * 5 + [2] * 5 + [2] * 5 + [1] * 10
        if self.max_iter is None:
            self.max_iter = default_iters
        if self.overall_max_iter is None:
            self.overall_max_iter = default_iters


def _make_guidance_spec(p: GroundedParams, overall: bool) -> guidance_lib.GuidanceSpec:
    if overall:
        return guidance_lib.GuidanceSpec(
            keys=tuple(p.guidance_attn_keys),
            loss_scale=p.overall_loss_scale,
            loss_threshold=p.overall_loss_threshold,
            max_index_step=p.overall_max_index_step,
            fg_top_p=p.overall_fg_top_p,
            bg_top_p=p.overall_bg_top_p,
            fg_weight=p.overall_fg_weight,
            bg_weight=p.overall_bg_weight,
            use_ref_ca=p.use_ref_ca,
            ref_ca_loss_weight=p.ref_ca_loss_weight,
        )
    return guidance_lib.GuidanceSpec(
        keys=tuple(p.guidance_attn_keys),
        loss_scale=p.loss_scale,
        loss_threshold=p.loss_threshold,
        max_index_step=p.max_index_step,
        fg_top_p=p.fg_top_p,
        bg_top_p=p.bg_top_p,
        fg_weight=p.fg_weight,
        bg_weight=p.bg_weight,
    )


def run_grounded(spec, bundle, p: GroundedParams,
                 segmenter: masking.Segmenter | None = None,
                 refine_cfg: masking.RefineConfig | None = None,
                 return_so_images: bool = True) -> base.GenerationResult:
    converted = convert_spec(spec, *BOX_SCALE)
    with trace.annotate("request", layouts=1,
                        boxes=len(converted.so_prompt_phrase_word_box)):
        return _run_grounded(spec, converted, bundle, p, segmenter, refine_cfg,
                             return_so_images)


def _run_grounded(spec, converted, bundle, p, segmenter, refine_cfg, return_so_images):
    cfg = bundle.config
    device = bundle.device
    H, W = cfg.latent_height, cfg.latent_width
    num_levels = len(cfg.unet.block_out_channels)
    latent_hw = (H, W)
    if p.guidance_attn_keys is None:
        p.guidance_attn_keys = guidance_lib.default_guidance_keys(cfg.unet)
    if p.obj_attn_key is None:
        p.obj_attn_key = guidance_lib.default_obj_attn_key(cfg.unet)
    segmenter = segmenter or masking.CoarseSegmenter()
    refine_cfg = refine_cfg or masking.RefineConfig(
        use_box_input=p.use_box_input, mask_th_for_point=p.mask_th_for_point)

    frozen_steps = int(p.num_inference_steps * min(max(p.frozen_step_ratio, 0.0), 1.0))

    so_list = converted.so_prompt_phrase_word_box
    overall_prompt = converted.overall_prompt
    if p.overall_prompt_override.strip():
        overall_prompt = p.overall_prompt_override.strip()
    overall_phrases = [x[0] for x in converted.overall_phrases_words_bboxes]
    overall_words = [x[1] for x in converted.overall_phrases_words_bboxes]
    overall_bboxes = [x[2] for x in converted.overall_phrases_words_bboxes]

    # Per-box boxes are optionally centered; overall boxes keep placement.
    if p.so_center_box:
        so_list = [
            (prompt, phrase, word, boxlib.get_centered_box(
                box, horizontal_center_only=p.so_horizontal_center_only,
                vertical_placement=p.so_vertical_placement,
                floor_padding=p.so_floor_padding))
            for prompt, phrase, word, box in so_list]
    so_boxes = [x[3] for x in so_list]

    so_negative = base.with_extra_negative(spec, p.so_negative_prompt)
    overall_negative = base.with_extra_negative(spec, p.overall_negative_prompt)

    schedule = sched.make_schedule(p.num_inference_steps, solver=p.scheduler)
    if p.use_fast_schedule:
        fast_after = (max(frozen_steps, p.overall_max_index_step) if p.use_ref_ca
                      else frozen_steps)
        so_schedule = sched.make_schedule(p.num_inference_steps,
                                          fast_after_steps=fast_after,
                                          fast_rate=p.fast_rate, solver=p.scheduler)
    else:
        so_schedule = schedule

    # ---- ONE batched per-box pass over every box ---------------------------
    latents_all_list, mask_list, ref_taps_per_box, so_images = [], [], [], []
    if so_list:
        n = len(so_list)
        so_uncond, so_cond = runtime_models.encode_prompts(
            bundle, [x[0] for x in so_list], so_negative, one_uncond_input_only=True)
        fg_masks = [boxlib.box_to_mask(b, H, W) for b in so_boxes]
        input_latents_list, latents_bg = latents_lib.get_input_latents_list(
            p.bg_seed, p.fg_seed_start, fg_masks, (1, H, W, 4),
            fg_blending_ratio=p.fg_blending_ratio,
            init_noise_sigma=schedule.init_noise_sigma)

        so_spec = _make_guidance_spec(p, overall=False)
        use_so_guidance = so_spec.max_index_step > 0
        save_keys = ((p.obj_attn_key,) if not p.use_ref_ca
                     else tuple(dict.fromkeys((p.obj_attn_key, *p.guidance_attn_keys))))
        word_token_indices = [
            toklib.get_phrase_indices(bundle.tokenizer, prompt, [phrase],
                                      words=[word]).word_token_indices[0]
            for prompt, phrase, word, _ in so_list]
        fuser_steps = (int(p.so_gligen_scheduled_sampling_beta * so_schedule.num_steps)
                       if p.use_gligen else 0)

        # LMD: each box is an independent "image" of the batched guidance
        # loop, with its own single-box guidance data.
        so_data = None
        if use_so_guidance:
            so_positions = [
                toklib.get_phrase_indices(bundle.tokenizer, prompt, [phrase],
                                          words=[word]).object_positions
                for prompt, phrase, word, _ in so_list]
            so_p_pad = guidance_lib.bucket(max(
                (len(pos) for obj_pos in so_positions for pos in obj_pos), default=1))
            so_data = guidance_lib.stack_guidance_data([
                guidance_lib.make_guidance_data([box], obj_pos, so_spec, latent_hw,
                                                num_levels, max_objs=1,
                                                max_positions=so_p_pad)
                for box, obj_pos in zip(so_boxes, so_positions)], device)
        gligen_inputs = None
        if p.use_gligen:
            pooled = runtime_models.encode_text(bundle, [x[1] for x in so_list])[1]
            gligen_inputs = base.make_gligen_inputs_batched(bundle, so_boxes, pooled)
        with trace.annotate("per_box_pass"):
            out = sample(
                bundle.unet, so_schedule,
                trace.to_device(np.concatenate(input_latents_list, axis=0), device,
                                "latents_to_device"),
                torch.cat([so_uncond.expand(n, -1, -1), so_cond], dim=0),
                cond_embeddings=so_cond if use_so_guidance else None,
                guidance_scale=p.guidance_scale,
                spec=so_spec if use_so_guidance else None, guidance_data=so_data,
                guidance_batched=use_so_guidance, max_iter=p.max_iter,
                gligen=gligen_inputs, num_fuser_steps=fuser_steps,
                save_all_latents=True, save_keys=save_keys,
                save_cond_only=True, save_single_token=True,
                tap_token_index=np.asarray(word_token_indices, np.int64),
                solver=p.scheduler)

        needs_pixels = return_so_images or getattr(segmenter, "needs_image", True)
        img_list = (list(base.decode_latents(bundle, out.latents)) if needs_pixels
                    else [None] * n)
        all_latents_np = trace.to_host(out.all_latents, "latents_to_host")
        saved_taps_np = {k: trace.to_host(v, "taps_to_host") for k, v in out.saved_taps.items()}
        # Every box segments in ONE call.
        if p.use_gligen:
            # LMD+: the box itself prompts the segmenter.
            masks = masking.refine_masks_from_boxes(so_boxes, img_list, latent_hw,
                                                    segmenter, refine_cfg)
        else:
            # LMD: the box's aggregated word-token attention prompts it.
            attn_maps = [compose_lib.aggregate_token_attention(
                saved_taps_np[p.obj_attn_key][:, idx:idx + 1],
                start_step=p.attn_aggregation_step_start) for idx in range(n)]
            masks = masking.refine_masks_from_attn(attn_maps, img_list, latent_hw,
                                                   segmenter, refine_cfg)
        for idx, mask in enumerate(masks):
            latents_all_list.append(all_latents_np[:, idx:idx + 1])
            mask_list.append(mask)
            if p.use_ref_ca:
                ref_taps_per_box.append({k: saved_taps_np[k][:, idx, :, :, 0]
                                         for k in p.guidance_attn_keys})
            if return_so_images:
                so_images.append(img_list[idx])
    else:
        latents_bg = (latents_lib.noise_from_seed(p.bg_seed, (1, H, W, 4))
                      * np.float32(schedule.init_noise_sigma))

    # ---- composition on the host ------------------------------------------
    with trace.annotate("compose"):
        composed = compose_lib.compose_latents_with_alignment(
            latents_all_list, mask_list, latents_bg, num_compose_steps=frozen_steps,
            align_with_overall_bboxes=p.align_with_overall_bboxes,
            overall_bboxes=overall_bboxes, horizontal_shift_only=p.horizontal_shift_only)
    frozen_mask = (composed.foreground_indices != 0).astype(np.float32)

    # ---- the overall pass ---------------------------------------------------
    overall_spec = overall_data = ref_taps = None
    if so_list:
        indices = toklib.get_phrase_indices(
            bundle.tokenizer, overall_prompt, overall_phrases, words=overall_words,
            add_suffix_if_not_found=True)
        overall_prompt = indices.prompt
        overall_spec = _make_guidance_spec(p, overall=True)
        ref_box_to_obj = [obj for obj, bboxes in enumerate(overall_bboxes) for _ in bboxes]
        overall_data = guidance_lib.guidance_data_to_device(
            guidance_lib.make_guidance_data(
                overall_bboxes, indices.object_positions, overall_spec, latent_hw,
                num_levels, word_token_indices=indices.word_token_indices,
                ref_box_to_obj=ref_box_to_obj if p.use_ref_ca else None), device)
        if p.use_ref_ca and ref_taps_per_box:
            shifted = compose_lib.shift_ref_taps(
                ref_taps_per_box, composed.offsets,
                horizontal_shift_only=p.horizontal_shift_only)
            ref_taps = {k: trace.to_device(v, device, "tables_to_device")
                        for k, v in shifted.items()}

    uncond, cond = runtime_models.encode_prompts(bundle, [overall_prompt], overall_negative)
    gligen_inputs = None
    fuser_steps = 0
    if p.use_gligen and so_list:
        flat_phrases = [phrase for phrase, _, bboxes in converted.overall_phrases_words_bboxes
                        for _ in bboxes]
        gligen_inputs = base.make_gligen_inputs(
            bundle, boxlib.expand_overall_bboxes(overall_bboxes), flat_phrases)
        fuser_steps = int(p.overall_gligen_scheduled_sampling_beta * schedule.num_steps)

    def dev(x):
        return trace.to_device(np.asarray(x, np.float32), device, "latents_to_device")

    with trace.annotate("overall_pass"):
        out = sample(
            bundle.unet, schedule, dev(composed.latents[0]), torch.cat([uncond, cond], dim=0),
            cond_embeddings=cond, guidance_scale=p.guidance_scale,
            spec=overall_spec, guidance_data=overall_data, max_iter=p.overall_max_iter,
            ref_taps=ref_taps, gligen=gligen_inputs, num_fuser_steps=fuser_steps,
            frozen_mask=dev(frozen_mask) if so_list else None,
            frozen_latents=dev(composed.latents) if so_list else None,
            num_frozen_steps=frozen_steps if so_list else 0, solver=p.scheduler)

    images = base.decode_latents(bundle, out.latents)
    return base.GenerationResult(
        image=images[0], so_img_list=so_images,
        aux={"masks": mask_list, "frozen_mask": frozen_mask,
             "foreground_indices": composed.foreground_indices})
