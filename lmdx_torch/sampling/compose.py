"""Masked latent-trajectory composition and alignment (host-side).

After the per-box passes, each object's denoising trajectory is pasted into
the background trajectory under its (SAM-refined) mask, largest mask first;
optionally each trajectory/mask/attention-map triple is first shifted so the
generated object's mass center lands on its target box center. Runs once per
image on the host (numpy) — it is orchestration, not hot-path compute.

Parity: utils/latents.py:38-118 (composition, box-to-bg copy, foreground
indices), utils/attn.py:40-70 (attention-map shifting), NHWC instead of NCHW.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core import boxes as boxlib


class ComposedLatents(NamedTuple):
    latents: np.ndarray             # (S+1, B, H, W, C) composed trajectory
    foreground_indices: np.ndarray  # (H, W) int32; 0 = background, i+1 = box i
    offsets: list                   # [(x_off, y_off) normalized] per box


def align_with_bboxes(latents_all_list, mask_list, bboxes, horizontal_shift_only=False):
    """Shift each trajectory+mask so the mask's mass center matches its target
    box center. Offsets are normalized and snapped to the 8x8 base grid so the
    identical physical shift applies at every attention resolution."""
    new_latents, new_masks, offsets = [], [], []
    for latents_all, mask, bbox in zip(latents_all_list, mask_list, bboxes):
        x_src, y_src = boxlib.mask_center(mask, normalize=True)
        x_dst = (bbox[0] + bbox[2]) / 2
        y_dst = (bbox[1] + bbox[3]) / 2
        x_off, y_off = x_dst - x_src, y_dst - y_src
        if horizontal_shift_only:
            y_off = 0.0
        # latents_all: (S+1, B, H, W, C): spatial dims are -3, -2
        shifted = boxlib.shift_tensor(np.asarray(latents_all), x_off, y_off,
                                      offset_normalized=True, ignore_last_dim=True)
        new_latents.append(shifted)
        new_masks.append(boxlib.shift_tensor(np.asarray(mask), x_off, y_off,
                                             offset_normalized=True))
        offsets.append((x_off, y_off))
    return new_latents, new_masks, offsets


def compose_latents(
    latents_all_list,            # list of (S+1, B, H, W, C) per-box trajectories
    mask_list,                   # list of (H, W) binary masks
    latents_bg: np.ndarray,      # (B, H, W, C) t=T background noise (scaled)
    num_compose_steps: int,      # S: how many steps of the trajectory to compose
    compose_box_to_bg: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    latents_bg = np.asarray(latents_bg)
    b, h, w, c = latents_bg.shape
    composed = np.zeros((num_compose_steps + 1, b, h, w, c), latents_bg.dtype)
    composed[0] = latents_bg
    foreground_indices = np.zeros((h, w), np.int32)

    masks = [np.asarray(m, np.float32) for m in mask_list]
    order = np.argsort([-m.sum() for m in masks]) if masks else []

    if compose_box_to_bg:
        # Copy each object's *initial noise* under its full box (not just the
        # refined mask) so centered/blended initial latents carry over intact.
        for idx in order:
            box_mask = boxlib.mask_to_box_mask(masks[idx])[None, :, :, None]
            first = np.asarray(latents_all_list[idx][0])
            composed[0] = composed[0] * (1.0 - box_mask) + first * box_mask

    for idx in order:
        m = masks[idx]
        foreground_indices = (foreground_indices * (m == 0) + (idx + 1) * (m > 0)).astype(
            np.int32
        )
        me = m[None, None, :, :, None]
        traj = np.asarray(latents_all_list[idx])[: num_compose_steps + 1]
        composed = composed * (1.0 - me) + traj * me

    return composed, foreground_indices


def compose_latents_with_alignment(
    latents_all_list,
    mask_list,
    latents_bg,
    num_compose_steps: int,
    align_with_overall_bboxes: bool = True,
    overall_bboxes=None,
    horizontal_shift_only: bool = False,
    compose_box_to_bg: bool = True,
) -> ComposedLatents:
    if align_with_overall_bboxes and len(latents_all_list):
        flat_boxes = boxlib.expand_overall_bboxes(overall_bboxes)
        latents_all_list, mask_list, offsets = align_with_bboxes(
            latents_all_list, mask_list, flat_boxes,
            horizontal_shift_only=horizontal_shift_only,
        )
    else:
        offsets = [(0.0, 0.0)] * len(latents_all_list)
    composed, fg_idx = compose_latents(
        latents_all_list, mask_list, latents_bg, num_compose_steps,
        compose_box_to_bg=compose_box_to_bg,
    )
    return ComposedLatents(latents=composed, foreground_indices=fg_idx, offsets=offsets)


def shift_ref_taps(ref_taps_per_box, offsets, horizontal_shift_only: bool = False):
    """Shift saved per-box attention maps by their alignment offsets.

    ref_taps_per_box: list (per box) of {AttnKey: (T, heads, n)} stacks.
    Returns {AttnKey: (T, num_boxes, heads, n)} ready for `sample(ref_taps=)`.
    Parity: utils/attn.py:40-70 (unflatten to 2D, shift, re-flatten).
    """
    if not ref_taps_per_box:
        return None
    keys = list(ref_taps_per_box[0].keys())
    out = {}
    for key in keys:
        shifted_boxes = []
        for box_taps, (x_off, y_off) in zip(ref_taps_per_box, offsets):
            if horizontal_shift_only:
                y_off = 0.0
            stack = np.asarray(box_taps[key])  # (T, heads, n)
            t_dim, heads, n = stack.shape
            hw = int(round(n**0.5))
            maps = stack.reshape(t_dim, heads, hw, hw)
            maps = boxlib.shift_tensor(maps, x_off, y_off, offset_normalized=True)
            shifted_boxes.append(maps.reshape(t_dim, heads, n))
        out[key] = np.stack(shifted_boxes, axis=1)  # (T, Bx, heads, n)
    return out


def aggregate_token_attention(taps_stack, start_step: int = 10):
    """Average a (T, 1, heads, n, 1) single-token tap stack over steps >=
    start_step and over heads -> (h, w) map for mask extraction.

    Parity: utils/attn.py:9-38 (get_token_attnv2 with cond-only input).
    """
    stack = np.asarray(taps_stack)
    if stack.ndim == 5:
        stack = stack[:, 0, :, :, 0]      # (T, heads, n)
    # Clamp so at least the final step contributes — short (truncated/test)
    # schedules with start_step >= T would otherwise average zero steps and
    # poison mask extraction with NaNs. At the reference settings (50 steps,
    # start 10) this is a no-op.
    start_step = min(start_step, stack.shape[0] - 1)
    attn = stack[start_step:].mean(axis=0).mean(axis=0)  # (n,)
    hw = int(round(attn.shape[0] ** 0.5))
    return attn.reshape(hw, hw)
