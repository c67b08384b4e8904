"""Multi-image batched grounded generation (port of the JAX package's
methods/batch.py: `run_grounded_batch`, `_compose_batch_device`,
`_gather_ref_batched`, `_key_heads`, `_pad_ref`, `_overall_gligen_batched`,
`run_lmd_batch`, `run_lmd_plus_batch`).

G prompts ride the pipeline together:

- all boxes of all images run as ONE batched per-box pass (each box with its
  own image's negative prompt, noise seeds and tap token; LMD+ adds its
  GLIGEN slot, LMD its per-box CA-energy guidance, each box converging on
  its own);
- masks come from the segmenter (SAM, or the weightless CoarseSegmenter by
  default): LMD+ prompts it with the box, LMD with the peak of the box's
  aggregated word-token attention;
- composition: without alignment (LMD+) the per-box trajectories are
  composed per image on the device; with `align_with_overall_bboxes` (LMD)
  trajectories and taps come to the host, each box is shifted onto its
  overall box there and the reference-CA taps are shifted with it;
- the G overall passes run as one batched pass with per-image frozen masks,
  GLIGEN grounding (LMD+) and batched CA-energy guidance with reference-CA
  transfer.

`defer_fetch=True` leaves the final images on the device behind
`base.ImageRef`s (`base.finalize_results` copies them), so that a caller can
launch the next batch before it copies and saves this one.

The compile-budget floors `pad_boxes_to`, `pad_objs_to` and
`pad_positions_to`, and the per-box batch bucketing, change no real image in
the JAX package: per-box pad rows duplicate the last box and are sliced away
before anything a caller sees (no operation of the UNet or the guidance
mixes rows, and the guidance loop's "any image above its threshold" test
sees each duplicate's loss equal to its source's); floored object, box and
position slots carry zero weights (`obj_valid`, `pos_valid`, `box_weight`
0) and the loss divides by the real object count. Only the order of XLA's
float sums can move with the padded shapes ("numerically equivalent, not
bitwise", its docstring). They exist to bound XLA compiles, which an eager
program does not have: the port checks them as the JAX package does
(`pad_boxes_to` must hold the batch's boxes) and runs unpadded.

Under an active mesh (`dist/serve.py::activate_mesh`) each dp row runs its
share of the images (`serve.shard_leading_axis`: a contiguous slice of the
specs with their own seeds, so each image sees the noise it sees without a
mesh) through the unchanged pipeline on its bundle, tensor-split over tp when
tp > 1; the uint8 images and the host results are then gathered over dp, so
every rank returns what the call returns without a mesh, in input order. A
batch that dp does not divide runs whole on every rank (it warns). Without
a mesh nothing of this runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import boxes as boxlib
from ..core import schedule as sched
from ..dist import mesh as meshlib
from ..dist import serve as serve_lib
from ..runtime import models as runtime_models
from ..sampling import compose as compose_lib
from ..sampling import guidance as guidance_lib
from ..sampling import latents as latents_lib
from ..sampling import masking
from ..sampling.loop import sample
from ..text import tokens as toklib
from ..text.parser import BOX_SCALE, convert_spec
from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT, DEFAULT_SO_NEGATIVE_PROMPT
from ..utils import trace
from . import base
from ._grounded import GroundedParams, _make_guidance_spec


def run_grounded_batch(specs: list, bundle, p: GroundedParams,
                       bg_seeds: list[int] | None = None,
                       fg_seed_starts: list[int] | None = None,
                       segmenter=None, return_so_images: bool = False,
                       pad_boxes_to: int | None = None, pad_objs_to: int | None = None,
                       pad_positions_to: int | None = None, defer_fetch: bool = False):
    """One GenerationResult per spec (module docstring). The `pad_*_to`
    floors are checked and change nothing here; `defer_fetch` leaves the
    final images on the device behind `base.ImageRef`s."""
    g_count = len(specs)
    bg_seeds = bg_seeds or [p.bg_seed + i for i in range(g_count)]
    fg_seed_starts = fg_seed_starts or [p.fg_seed_start] * g_count
    n_boxes = sum(len(convert_spec(spec, *BOX_SCALE).so_prompt_phrase_word_box)
                  for spec in specs)
    if pad_boxes_to is not None and n_boxes and pad_boxes_to < n_boxes:
        raise ValueError(f"pad_boxes_to {pad_boxes_to} < the batch's {n_boxes} boxes")
    with trace.annotate("request", layouts=g_count, boxes=n_boxes):
        mesh = serve_lib.active_mesh()
        mine = serve_lib.shard_leading_axis(list(range(g_count)), mesh)
        final_images, extras = _run_local(
            [specs[i] for i in mine], bundle, p, [bg_seeds[i] for i in mine],
            [fg_seed_starts[i] for i in mine], segmenter, return_so_images)
        if len(mine) < g_count:
            final_images = torch.cat(meshlib.all_gather(final_images, mesh.dp_group,
                                                        mesh.dp_members))
            extras = [e for part in meshlib.all_gather_object(extras, mesh.dp_group,
                                                               mesh.dp_members)
                      for e in part]
        deferred = host_images = None
        if defer_fetch:
            deferred = base.DeferredImages(final_images)
        else:
            host_images = trace.to_host(final_images, "images_to_host")
    return [base.GenerationResult(
        image=base.ImageRef(deferred, gi) if defer_fetch else host_images[gi],
        so_img_list=so_img_list, aux=aux)
        for gi, (so_img_list, aux) in enumerate(extras)]


def _run_local(specs, bundle, p, bg_seeds, fg_seed_starts, segmenter, return_so_images):
    """The pipeline on this process's images: (the uint8 images (G, H, W, 3)
    on the device, [(so_img_list, aux)] per image)."""
    cfg = bundle.config
    device = bundle.device
    H, W = cfg.latent_height, cfg.latent_width
    latent_hw = (H, W)
    num_levels = len(cfg.unet.block_out_channels)
    if p.guidance_attn_keys is None:
        p.guidance_attn_keys = guidance_lib.default_guidance_keys(cfg.unet)
    if p.obj_attn_key is None:
        p.obj_attn_key = guidance_lib.default_obj_attn_key(cfg.unet)
    segmenter = segmenter or masking.CoarseSegmenter()
    refine_cfg = masking.RefineConfig(use_box_input=p.use_box_input,
                                      mask_th_for_point=p.mask_th_for_point)

    g_count = len(specs)
    frozen_steps = int(p.num_inference_steps * min(max(p.frozen_step_ratio, 0.0), 1.0))
    schedule = sched.make_schedule(p.num_inference_steps, solver=p.scheduler)
    if p.use_fast_schedule:
        fast_after = (max(frozen_steps, p.overall_max_index_step) if p.use_ref_ca
                      else frozen_steps)
        so_schedule = sched.make_schedule(p.num_inference_steps,
                                          fast_after_steps=fast_after,
                                          fast_rate=p.fast_rate, solver=p.scheduler)
    else:
        so_schedule = schedule

    # ---- per-image preprocessing -----------------------------------------
    images = []
    for spec, bg_seed, fg_start in zip(specs, bg_seeds, fg_seed_starts):
        conv = convert_spec(spec, *BOX_SCALE)
        so_list = conv.so_prompt_phrase_word_box
        if p.so_center_box:
            so_list = [
                (pr, ph, wd, boxlib.get_centered_box(
                    bx, horizontal_center_only=p.so_horizontal_center_only,
                    vertical_placement=p.so_vertical_placement,
                    floor_padding=p.so_floor_padding))
                for pr, ph, wd, bx in so_list]
        images.append({
            "conv": conv, "so_list": so_list, "bg_seed": bg_seed,
            "fg_seed_start": fg_start,
            "so_negative": base.with_extra_negative(spec, p.so_negative_prompt),
            "overall_negative": base.with_extra_negative(spec, p.overall_negative_prompt),
        })

    # ---- ONE batched per-box pass over every box of every image ----------
    flat = [(gi, item) for gi, im in enumerate(images) for item in im["so_list"]]
    n_boxes = len(flat)
    save_keys = (tuple(dict.fromkeys((p.obj_attn_key, *p.guidance_attn_keys)))
                 if p.use_ref_ca else (p.obj_attn_key,))
    fuser_steps = (int(p.so_gligen_scheduled_sampling_beta * so_schedule.num_steps)
                   if p.use_gligen else 0)
    so_spec = _make_guidance_spec(p, overall=False)
    use_so_guidance = so_spec.max_index_step > 0
    # Without alignment the trajectories and taps stay on the device (LMD+);
    # the alignment shifts run on the host (LMD).
    on_device = not p.align_with_overall_bboxes

    latents_bg_per_image = []
    so_images = []
    obj_taps_np = None
    if n_boxes:
        per_box_latents = []
        for im in images:
            fg_masks = [boxlib.box_to_mask(x[3], H, W) for x in im["so_list"]]
            lat_list, lat_bg = latents_lib.get_input_latents_list(
                im["bg_seed"], im["fg_seed_start"], fg_masks, (1, H, W, 4),
                fg_blending_ratio=p.fg_blending_ratio,
                init_noise_sigma=schedule.init_noise_sigma)
            per_box_latents.extend(lat_list)
            latents_bg_per_image.append(lat_bg)

        # One text-encoder call: per-box prompts, negatives, GLIGEN phrases.
        so_phrases = [item[1] for _, item in flat] if p.use_gligen else []
        texts = ([item[0] for _, item in flat] + [im["so_negative"] for im in images]
                 + so_phrases)
        enc_hidden, enc_pooled = runtime_models.encode_text(bundle, texts)
        cond = enc_hidden[:n_boxes]
        uncond = enc_hidden[n_boxes:n_boxes + g_count][
            trace.to_device([gi for gi, _ in flat], device, "tables_to_device")]
        word_token_indices = np.asarray([
            toklib.get_phrase_indices(bundle.tokenizer, item[0], [item[1]],
                                      words=[item[2]]).word_token_indices[0]
            for _, item in flat], np.int64)
        gligen_inputs = (base.make_gligen_inputs_batched(
            bundle, [item[3] for _, item in flat], enc_pooled[n_boxes + g_count:])
            if p.use_gligen else None)

        # LMD: per-box CA guidance rides the batched guidance loop, every box
        # an independent "image" with its own single-box guidance data.
        so_data = None
        if use_so_guidance:
            so_positions = [
                toklib.get_phrase_indices(bundle.tokenizer, prompt, [phrase],
                                          words=[word]).object_positions
                for _, (prompt, phrase, word, _) in flat]
            so_p_pad = guidance_lib.bucket(max(
                (len(pos) for obj_pos in so_positions for pos in obj_pos), default=1))
            so_data = guidance_lib.stack_guidance_data([
                guidance_lib.make_guidance_data(
                    [item[3]], obj_pos, so_spec, latent_hw, num_levels,
                    max_objs=1, max_positions=so_p_pad, max_ref_boxes=1)
                for (_, item), obj_pos in zip(flat, so_positions)], device)

        with trace.annotate("per_box_pass"):
            out = sample(
                bundle.unet, so_schedule,
                trace.to_device(np.concatenate(per_box_latents, axis=0), device,
                                "latents_to_device"),
                torch.cat([uncond, cond], dim=0),
                cond_embeddings=cond if use_so_guidance else None,
                guidance_scale=p.guidance_scale,
                spec=so_spec if use_so_guidance else None, guidance_data=so_data,
                guidance_batched=True, max_iter=p.max_iter,
                gligen=gligen_inputs, num_fuser_steps=fuser_steps,
                save_all_latents=True, save_keys=save_keys,
                save_cond_only=True, save_single_token=True,
                tap_token_index=word_token_indices, solver=p.scheduler)
        needs_pixels = return_so_images or getattr(segmenter, "needs_image", True)
        so_images = (list(base.decode_latents(bundle, out.latents))
                     if needs_pixels else [None] * n_boxes)
        if not on_device:
            all_latents_np = trace.to_host(out.all_latents, "latents_to_host")
            taps_np = {k: trace.to_host(v, "taps_to_host") for k, v in out.saved_taps.items()}
            obj_taps_np = taps_np[p.obj_attn_key]
        elif not p.use_gligen:
            obj_taps_np = trace.to_host(out.saved_taps[p.obj_attn_key], "taps_to_host")
    else:
        for im in images:
            latents_bg_per_image.append(
                latents_lib.noise_from_seed(im["bg_seed"], (1, H, W, 4))
                * np.float32(schedule.init_noise_sigma))

    # ---- masks and per-image composition ---------------------------------
    if not n_boxes:
        all_masks = []
    elif p.use_gligen:
        # LMD+: the box itself prompts the segmenter.
        all_masks = masking.refine_masks_from_boxes(
            [item[3] for _, item in flat], so_images, latent_hw, segmenter, refine_cfg)
    else:
        # LMD: the box's aggregated word-token attention prompts it.
        attn_maps = [compose_lib.aggregate_token_attention(
            obj_taps_np[:, bi:bi + 1], start_step=p.attn_aggregation_step_start)
            for bi in range(n_boxes)]
        all_masks = masking.refine_masks_from_attn(
            attn_maps, so_images, latent_hw, segmenter, refine_cfg)
    image_box_idxs, start = [], 0
    for im in images:
        image_box_idxs.append(list(range(start, start + len(im["so_list"]))))
        start += len(im["so_list"])

    device_path = bool(n_boxes) and on_device
    if device_path:
        with trace.annotate("compose"):
            frozen_latents, fg_batched = _compose_batch_device(
                out.all_latents, image_box_idxs, all_masks,
                np.concatenate(latents_bg_per_image, axis=0), frozen_steps)
    elif on_device:
        frozen_latents = torch.zeros((frozen_steps + 1, g_count, H, W, 4), device=device)
        frozen_latents[0] = trace.to_device(np.concatenate(latents_bg_per_image), device,
                                            "latents_to_device")
        fg_batched = np.zeros((g_count, H, W), np.int32)

    overall_spec = _make_guidance_spec(p, overall=True)
    guid_raw, overall_prompts, results_aux = [], [], []
    composed_list, shifted_refs = [], []
    for gi, im in enumerate(images):
        conv = im["conv"]
        idxs = image_box_idxs[gi]
        if on_device:
            fg_idx = fg_batched[gi]
        else:
            with trace.annotate("compose"):
                host = compose_lib.compose_latents_with_alignment(
                    [all_latents_np[:, bi:bi + 1] for bi in idxs],
                    [all_masks[bi] for bi in idxs], latents_bg_per_image[gi],
                    num_compose_steps=frozen_steps,
                    align_with_overall_bboxes=p.align_with_overall_bboxes,
                    overall_bboxes=[x[2] for x in conv.overall_phrases_words_bboxes],
                    horizontal_shift_only=p.horizontal_shift_only)
            composed_list.append(host.latents)
            fg_idx = host.foreground_indices
            if p.use_ref_ca:
                shifted_refs.append(compose_lib.shift_ref_taps(
                    [{k: taps_np[k][:, bi, :, :, 0] for k in p.guidance_attn_keys}
                     for bi in idxs],
                    host.offsets, horizontal_shift_only=p.horizontal_shift_only))
        results_aux.append({
            "frozen_mask": (fg_idx != 0).astype(np.float32),
            "foreground_indices": fg_idx,
            "so_image_ids": idxs,
            "masks": [all_masks[bi] for bi in idxs],
        })
        phrases = [x[0] for x in conv.overall_phrases_words_bboxes]
        words = [x[1] for x in conv.overall_phrases_words_bboxes]
        bboxes = [x[2] for x in conv.overall_phrases_words_bboxes]
        overall_prompt = conv.overall_prompt
        if phrases:
            indices = toklib.get_phrase_indices(
                bundle.tokenizer, overall_prompt, phrases, words=words,
                add_suffix_if_not_found=True)
            overall_prompt = indices.prompt
            guid_raw.append({"bboxes": bboxes, "positions": indices.object_positions,
                             "wt": indices.word_token_indices,
                             "ref": [o for o, bs in enumerate(bboxes) for _ in bs]})
        else:
            guid_raw.append({"bboxes": [], "positions": [], "wt": [], "ref": []})
        overall_prompts.append(overall_prompt)

    # Shared pads for the batch, bucketed to the actual maxima.
    o_pad = guidance_lib.bucket(max((len(g["bboxes"]) for g in guid_raw), default=1))
    p_pad = guidance_lib.bucket(max(
        (len(pos) for g in guid_raw for pos in g["positions"]), default=1))
    bx_pad = guidance_lib.bucket(max((len(g["ref"]) for g in guid_raw), default=1))
    data_batched = guidance_lib.stack_guidance_data([
        guidance_lib.make_guidance_data(
            g["bboxes"], g["positions"], overall_spec, latent_hw, num_levels,
            word_token_indices=g["wt"],
            ref_box_to_obj=g["ref"] if p.use_ref_ca else None,
            max_objs=o_pad, max_positions=p_pad, max_ref_boxes=bx_pad)
        for g in guid_raw], device)
    ref_batched = None
    if p.use_ref_ca and device_path:
        ref_batched = _gather_ref_batched(out.saved_taps, image_box_idxs, bx_pad,
                                          p.guidance_attn_keys)
    elif p.use_ref_ca and not on_device:
        padded = [_pad_ref(shifted, bx_pad, p, cfg, so_schedule.num_steps, latent_hw,
                           num_levels) for shifted in shifted_refs]
        ref_batched = {k: trace.to_device(np.stack([r[k] for r in padded], axis=1), device,
                                          "tables_to_device")
                       for k in p.guidance_attn_keys}       # (T, G, Bx, heads, n)
    if not on_device:
        frozen_latents = trace.to_device(
            np.concatenate(composed_list, axis=1).astype(np.float32), device,
            "latents_to_device")
        fg_batched = np.stack([aux["foreground_indices"] for aux in results_aux])

    # ---- ONE batched overall pass -----------------------------------------
    overall_phrases = _overall_phrases(images) if p.use_gligen else []
    enc_hidden, enc_pooled = runtime_models.encode_text(
        bundle, overall_prompts + [im["overall_negative"] for im in images]
        + overall_phrases)
    cond = enc_hidden[:g_count]
    uncond = enc_hidden[g_count:2 * g_count]
    gligen_inputs = (_overall_gligen_batched(bundle, images, pooled=enc_pooled[2 * g_count:])
                     if p.use_gligen else None)
    with trace.annotate("overall_pass"):
        out = sample(
            bundle.unet, schedule, frozen_latents[0], torch.cat([uncond, cond], dim=0),
            cond_embeddings=cond, guidance_scale=p.guidance_scale,
            spec=overall_spec, guidance_data=data_batched, guidance_batched=True,
            max_iter=p.overall_max_iter, ref_taps=ref_batched,
            gligen=gligen_inputs,
            num_fuser_steps=(int(p.overall_gligen_scheduled_sampling_beta * schedule.num_steps)
                             if p.use_gligen else 0),
            frozen_mask=trace.to_device((fg_batched != 0).astype(np.float32), device,
                                        "tables_to_device"),
            frozen_latents=frozen_latents, num_frozen_steps=frozen_steps,
            solver=p.scheduler)
    final_images = base.decode_latents(bundle, out.latents, to_host=False)
    return final_images, [
        ([so_images[i] for i in aux["so_image_ids"]] if return_so_images else [],
         {"frozen_mask": aux["frozen_mask"],
          "foreground_indices": aux["foreground_indices"],
          "masks": aux["masks"]})
        for aux in results_aux]


def _compose_batch_device(all_latents, image_box_idxs, mask_flat, latents_bg,
                          num_compose_steps):
    """Whole-batch masked trajectory composition on the device.

    all_latents: (T+1, B_flat, H, W, C); image_box_idxs: per image its flat
    box indices; mask_flat: flat list of host (H, W) masks; latents_bg:
    (G, H, W, C) host. Per image the boxes go largest mask first: the
    initial noise is copied under each box, then each trajectory is pasted
    under its mask, later (smaller) masks overwriting. Returns (composed
    (S+1, G, H, W, C) device, fg (G, H, W) np.int32; 0 = background)."""
    device = all_latents.device
    g_count = len(image_box_idxs)
    h, w = latents_bg.shape[1:3]
    n_max = max(len(i) for i in image_box_idxs)

    idx_map = np.zeros((g_count, n_max), np.int64)
    masks = np.zeros((g_count, n_max, h, w), np.float32)
    box_masks = np.zeros_like(masks)
    labels = np.zeros((g_count, n_max), np.int32)
    for gi, idxs in enumerate(image_box_idxs):
        ms = [np.asarray(mask_flat[bi], np.float32) for bi in idxs]
        order = np.argsort([-m.sum() for m in ms]) if ms else []
        for j, oi in enumerate(order):
            idx_map[gi, j] = idxs[oi]
            masks[gi, j] = ms[oi]
            box_masks[gi, j] = boxlib.mask_to_box_mask(ms[oi])
            labels[gi, j] = oi + 1

    def dev(x):
        return trace.to_device(x, device, "tables_to_device")

    masks_t, box_t = dev(masks), dev(box_masks)
    traj = all_latents[:num_compose_steps + 1][:, dev(idx_map)]  # (S+1, G, n_max, H, W, C)
    comp0 = dev(np.asarray(latents_bg, np.float32))
    for j in range(n_max):
        bm = box_t[:, j][..., None]
        comp0 = comp0 * (1.0 - bm) + traj[0, :, j] * bm
    composed = torch.zeros((num_compose_steps + 1,) + comp0.shape, device=device)
    composed[0] = comp0
    fg = np.zeros((g_count, h, w), np.int32)
    for j in range(n_max):
        fg = np.where(masks[:, j] > 0, labels[:, j][:, None, None], fg)
        me = masks_t[:, j][None, :, :, :, None]
        composed = composed * (1.0 - me) + traj[:, :, j] * me
    return composed, fg.astype(np.int32)


def _gather_ref_batched(taps, image_box_idxs, max_boxes, keys):
    """Reference-CA maps for the whole batch: {key: (T, G, Bx, heads, n)}
    gathered from the flat per-box tap stacks, padded box rows zeroed."""
    g_count = len(image_box_idxs)
    idx_map = np.zeros((g_count, max_boxes), np.int64)
    valid = np.zeros((g_count, max_boxes), np.float32)
    for gi, idxs in enumerate(image_box_idxs):
        n_i = min(len(idxs), max_boxes)
        idx_map[gi, :n_i] = idxs[:n_i]
        valid[gi, :n_i] = 1.0
    out = {}
    for k in keys:
        v = taps[k]
        out[k] = (v[..., 0][:, trace.to_device(idx_map, v.device, "tables_to_device")]
                  * trace.to_device(valid, v.device, "tables_to_device")[None, :, :, None, None])
    return out


def _key_heads(key, cfg) -> int:
    place, idx = key[0], key[1]
    levels = len(cfg.unet.block_out_channels)
    level = {"down": idx, "mid": levels - 1, "up": levels - 1 - idx}[place]
    return cfg.unet.num_attention_heads[level]


def _pad_ref(shifted, max_boxes, p, cfg, num_steps, latent_hw, num_levels):
    """Pad one image's shifted reference taps {key: (T, Bx, heads, n)} with
    zero boxes to max_boxes (zero box_weight rows match them). An image
    without boxes gets all-zero stacks with the model's head counts, so every
    image stacks into one (T, G, Bx, heads, n) array."""
    out = {}
    for key in p.guidance_attn_keys:
        h, w = guidance_lib.key_resolution(key, latent_hw, num_levels)
        arr = None if shifted is None or key not in shifted else np.asarray(shifted[key])
        t_dim = num_steps if arr is None else arr.shape[0]
        padded = np.zeros((t_dim, max_boxes, _key_heads(key, cfg), h * w), np.float32)
        if arr is not None:
            padded[:, :arr.shape[1]] = arr
        out[key] = padded
    return out


def _overall_phrases(images) -> list[str]:
    """Flat per-box phrase list across the batch, in _overall_gligen_batched
    span order."""
    return [ph for im in images
            for ph, _, bs in im["conv"].overall_phrases_words_bboxes for _ in bs]


def _overall_gligen_batched(bundle, images, pooled):
    """Per-image overall grounding: image i grounds all of its boxes.
    Returns (objs_full (2G, M, D), objs for the guidance forwards (G, M, D))."""
    max_objs = bundle.config.unet.gligen_max_objs
    g_count = len(images)
    width = bundle.config.clip.hidden_size
    pooled = (trace.to_host(pooled, "pooled_to_host") if len(pooled)
              else np.zeros((0, width), np.float32))

    boxes_arr = np.zeros((g_count, max_objs, 4), np.float32)
    embs = np.zeros((g_count, max_objs, width), np.float32)
    masks = np.zeros((g_count, max_objs), np.float32)
    start = 0
    for gi, im in enumerate(images):
        conv = im["conv"]
        boxes = boxlib.expand_overall_bboxes(
            [bs for _, _, bs in conv.overall_phrases_words_bboxes])
        n = min(len(boxes), max_objs)
        if n:
            boxes_arr[gi, :n] = np.asarray(boxes, np.float32)[:n]
            embs[gi, :n] = pooled[start:start + n]
            masks[gi, :n] = 1.0
        start += len(boxes)

    boxes2 = np.concatenate([boxes_arr, boxes_arr], axis=0)
    embs2 = np.concatenate([embs, embs], axis=0)
    masks2 = np.concatenate([np.zeros_like(masks), masks], axis=0)
    objs_full = runtime_models.gligen_objs(bundle, boxes2, masks2, embs2)
    return objs_full, objs_full[g_count:]


def run_lmd_batch(specs, bundle, segmenter=None, **overrides):
    """Batched training-free LMD over a list of specs; one GenerationResult
    per spec. Hyperparameters are shared across the batch (LMD defaults)."""
    defaults = dict(
        so_negative_prompt=DEFAULT_SO_NEGATIVE_PROMPT,
        overall_negative_prompt=DEFAULT_OVERALL_NEGATIVE_PROMPT,
        use_gligen=False,
        max_index_step=30,
        so_center_box=True,
        so_horizontal_center_only=False,
        fg_blending_ratio=0.01,
        align_with_overall_bboxes=True,
        horizontal_shift_only=False,
    )
    bg_seeds = overrides.pop("bg_seeds", None)
    fg_seed_starts = overrides.pop("fg_seed_starts", None)
    return_so_images = overrides.pop("return_so_images", False)
    batch_kw = {k: overrides.pop(k, None) for k in
                ("pad_boxes_to", "pad_objs_to", "pad_positions_to")}
    batch_kw["defer_fetch"] = overrides.pop("defer_fetch", False)
    params = GroundedParams(**{**defaults, **overrides})
    return run_grounded_batch(specs, bundle, params, bg_seeds=bg_seeds,
                              fg_seed_starts=fg_seed_starts, segmenter=segmenter,
                              return_so_images=return_so_images, **batch_kw)


def run_lmd_plus_batch(specs, bundle, segmenter=None, **overrides):
    """Batched LMD+ over a list of specs; one GenerationResult per spec.
    Hyperparameters are shared across the batch (LMD+ defaults)."""
    defaults = dict(
        so_negative_prompt=DEFAULT_SO_NEGATIVE_PROMPT,
        overall_negative_prompt=DEFAULT_OVERALL_NEGATIVE_PROMPT,
        use_gligen=True,
        so_gligen_scheduled_sampling_beta=0.4,
        overall_gligen_scheduled_sampling_beta=0.4,
        max_index_step=0,
        so_center_box=False,
        so_horizontal_center_only=True,
        fg_blending_ratio=0.1,
        align_with_overall_bboxes=False,
        horizontal_shift_only=True,
    )
    bg_seeds = overrides.pop("bg_seeds", None)
    fg_seed_starts = overrides.pop("fg_seed_starts", None)
    return_so_images = overrides.pop("return_so_images", False)
    batch_kw = {k: overrides.pop(k, None) for k in
                ("pad_boxes_to", "pad_objs_to", "pad_positions_to")}
    batch_kw["defer_fetch"] = overrides.pop("defer_fetch", False)
    params = GroundedParams(**{**defaults, **overrides})
    return run_grounded_batch(specs, bundle, params, bg_seeds=bg_seeds,
                              fg_seed_starts=fg_seed_starts, segmenter=segmenter,
                              return_so_images=return_so_images, **batch_kw)
