"""Plain reference of the sampler's stages: the DDIM schedule and update
with classifier-free guidance, the cross-attention energy loss of the
guidance step, and the composition of the per-box trajectories under their
masks (with the shift onto the overall boxes where the method aligns them).
"""

from __future__ import annotations

import numpy as np
import torch

from .prec import Prec


def alphas_cumprod(s: dict) -> np.ndarray:
    """Scaled-linear betas (float64), cumulative product as float32."""
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, s["num_train_timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_timesteps(s: dict, num_steps: int) -> list[tuple[int, int]]:
    """(t, prev_t) of each DDIM step: leading spacing plus steps_offset, the
    last step's prev_t -1 (alpha_cumprod[0] as the final alpha)."""
    ratio = s["num_train_timesteps"] // num_steps
    ts = [i * ratio + s["steps_offset"] for i in reversed(range(num_steps))]
    return [(t, t - ratio) for t in ts]


def ddim_cfg_step(s: dict, pr: Prec, eps2, latents, t: int, prev_t: int, scale: float):
    """x_t -> x_prev_t from the CFG-doubled eps (2B, ...) [uncond; cond]."""
    ac = alphas_cumprod(s)
    a_t = float(ac[t])
    a_prev = float(ac[prev_t]) if prev_t >= 0 else float(ac[0])
    eps_u, eps_c = pr.q(eps2).chunk(2, dim=0)
    eps = eps_u + scale * (eps_c - eps_u)
    x = pr.q(latents)
    x0 = (x - (1.0 - a_t) ** 0.5 * eps) / a_t ** 0.5
    return a_prev ** 0.5 * x0 + (1.0 - a_prev) ** 0.5 * eps


def guidance_step_size(s: dict, t: int) -> float:
    return float(np.sqrt(np.float32(1.0) - alphas_cumprod(s)[t]))


def _topk_mean(x, k):
    vals = torch.sort(x, dim=-1, descending=True).values
    k = torch.broadcast_to(k, x.shape[:-1])
    mask = torch.arange(x.shape[-1], device=x.device) < k[..., None]
    return (vals * mask).sum(-1) / k.to(x.dtype)


def ca_loss(taps: dict, data: dict, spec: dict, ref_taps: dict | None = None):
    """Per-image unscaled energy (G,): for each tapped layer and object, the
    mean of the top fg_top_p attention on each object token inside its box
    (pulled up) and of the top bg_top_p outside it (pushed down), averaged
    over tokens, summed over objects and layers and divided by the object
    count times the layer count; plus, with reference-attention transfer,
    the L1 distance between each box's normalised map and its per-box
    reference map, weighted per box."""
    positions = data["positions"]
    g, o, p = positions.shape
    total = torch.zeros(g, device=positions.device)
    for key in spec["keys"]:
        attn = taps[key].float()
        heads, n = attn.shape[1], attn.shape[2]
        idx = positions.reshape(g, 1, 1, o * p).expand(g, heads, n, o * p)
        sel = torch.gather(attn, -1, idx).reshape(g, heads, n, o, p).permute(0, 3, 4, 1, 2)
        m = data["masks"][key].float()[:, :, None, None, :]
        fg = _topk_mean(sel * m, data["kfg"][key][:, :, None, None])
        bg = _topk_mean(sel * (1.0 - m), data["kbg"][key][:, :, None, None])
        per_pos = (1.0 - fg).sum(-1) * spec["fg_weight"] + bg.sum(-1) * spec["bg_weight"]
        per_obj = (per_pos * data["pos_valid"]).sum(-1) / data["pos_count"]
        total = total + (per_obj * data["obj_valid"]).sum(-1)
    n_keys = len(spec["keys"])
    total = total / (data["num_objects"] * n_keys)
    if spec["use_ref_ca"] and ref_taps is not None:
        ref_total = torch.zeros_like(total)
        bw = data["box_word_idx"]
        bx = bw.shape[1]
        for key in spec["keys"]:
            attn = taps[key].float()
            heads, n = attn.shape[1], attn.shape[2]
            tgt = torch.gather(attn, -1, bw.reshape(g, 1, 1, bx).expand(g, heads, n, bx))
            tgt = tgt.permute(0, 3, 1, 2)
            mask = data["ref_masks"][key].float()[:, :, None, :]
            tgt_m, ref_m = tgt * mask, ref_taps[key].float() * mask
            tgt_n = tgt_m / (tgt_m.sum(-1, keepdim=True) + 1e-5)
            ref_n = ref_m / (ref_m.sum(-1, keepdim=True) + 1e-5)
            ref_total = ref_total + ((tgt_n - ref_n).abs().sum(-1).mean(-1)
                                     * data["box_weight"]).sum(-1)
        total = total + ref_total / (data["num_objects"] * n_keys)
    return total


def _box_of_mask(mask: np.ndarray):
    """The mask's bounding box enlarged by one texel (clipped), inclusive of
    its far edge as a filled rectangle."""
    ys, xs = np.where(mask)
    h, w = mask.shape
    y0, y1 = max(int(ys.min()) - 1, 0), min(int(ys.max()) + 1, h)
    x0, x1 = max(int(xs.min()) - 1, 0), min(int(xs.max()) + 1, w)
    out = np.zeros((h, w), np.float32)
    out[y0:y1 + 1, x0:x1 + 1] = 1.0
    return out


def compose(pr: Prec, trajectories, masks, latents_bg, steps: int):
    """One image: trajectories [(T+1, 1, H, W, C)] and binary masks [(H, W)]
    per box, background noise (1, H, W, C) -> composed (steps+1, 1, H, W, C)
    and foreground indices (H, W): largest mask first, each box's initial
    noise copied under its mask's box, then each trajectory pasted under its
    mask, later (smaller) masks overwriting."""
    bg = pr.q(torch.as_tensor(np.asarray(latents_bg, np.float32)))
    dev = trajectories[0].device if trajectories and torch.is_tensor(trajectories[0]) else None
    bg = bg.to(dev) if dev is not None else bg
    out = torch.zeros((steps + 1,) + tuple(bg.shape), device=bg.device)
    out[0] = bg
    h, w = bg.shape[1:3]
    fg = np.zeros((h, w), np.int32)
    ms = [np.asarray(m, np.float32) for m in masks]
    order = np.argsort([-m.sum() for m in ms], kind="stable") if ms else []
    trajs = [pr.q(torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t).to(bg.device))
             for t in trajectories]
    for i in order:
        bm = torch.as_tensor(_box_of_mask(ms[i]), device=bg.device)[None, :, :, None]
        out[0] = out[0] * (1.0 - bm) + trajs[i][0] * bm
    for i in order:
        fg = np.where(ms[i] > 0, i + 1, fg).astype(np.int32)
        me = torch.as_tensor(ms[i], device=bg.device)[None, None, :, :, None]
        out = out * (1.0 - me) + trajs[i][:steps + 1] * me
    return out, fg


def _shift(t: torch.Tensor, bx: int, by: int, last_dim: bool):
    """Shift the spatial dims by whole texels (snapped on an 8x8 grid), zero
    fill."""
    h, w = (t.shape[-3], t.shape[-2]) if last_dim else (t.shape[-2], t.shape[-1])
    dx, dy = bx * (w // 8), by * (h // 8)
    out = torch.zeros_like(t)
    ow, oh = w - abs(dx), h - abs(dy)
    if ow <= 0 or oh <= 0:
        return out
    ys, yd = (0, dy) if dy >= 0 else (-dy, 0)
    xs, xd = (0, dx) if dx >= 0 else (-dx, 0)
    if last_dim:
        out[..., yd:yd + oh, xd:xd + ow, :] = t[..., ys:ys + oh, xs:xs + ow, :]
    else:
        out[..., yd:yd + oh, xd:xd + ow] = t[..., ys:ys + oh, xs:xs + ow]
    return out


def align(trajectories, masks, boxes, horizontal_only: bool):
    """Shift each trajectory and mask so that the mask's mass centre lands on
    its target box's centre, the normalised offset snapped to an 8x8 grid."""
    new_t, new_m = [], []
    for traj, mask, box in zip(trajectories, masks, boxes):
        m = np.asarray(mask, np.float64)
        h, w = m.shape
        tot = m.sum()
        if tot == 0:
            cx, cy = 0.5, 0.5
        else:
            cx = float(m.sum(axis=0) @ np.arange(w)) / tot / w
            cy = float(m.sum(axis=1) @ np.arange(h)) / tot / h
        ox, oy = (box[0] + box[2]) / 2 - cx, (box[1] + box[3]) / 2 - cy
        if horizontal_only:
            oy = 0.0
        bx, by = round(ox * 8), round(oy * 8)
        t = traj if torch.is_tensor(traj) else torch.as_tensor(np.asarray(traj))
        new_t.append(_shift(t, bx, by, last_dim=True))
        new_m.append(_shift(torch.as_tensor(np.asarray(mask)), bx, by, last_dim=False).numpy())
    return new_t, new_m
