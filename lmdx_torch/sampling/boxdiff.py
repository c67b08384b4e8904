"""BoxDiff's box-constraint losses (inner box, outer box, corners) and its
one-iteration guidance update (port of the JAX package's
sampling/boxdiff.py).

- The attention maps of every guidance key are concatenated over layers and
  heads and averaged into one (H*W, 77) map.
- Text-token columns 1..75 are sharpened (x100) and softmaxed over tokens.
- Per (object, token) row: the inner-box top-k mean is pulled to 1, the
  outer-box top-k mean pushed to 0, and within +-L of each box edge the x / y
  max-projections of the (smoothed) map are matched to the box's profile.
- One gradient step per timestep while the step index is below
  `max_index_step`, of size latent_scale * sqrt(lerp(scale_range,
  index / (T - 1))).

The per-prompt structure is precomputed on the host into padded arrays
(`make_boxdiff_data`), so the loss is a function of the taps alone.

Its tap spec has `fused=False`: the guidance forward's untapped
cross-attention layers run plain math (`TapSpec.fused`), the reference's
routing for BoxDiff's gradient. The self-attentions receive no tap spec and
keep the flash kernels, forward and backward, as on the JAX side.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..core import boxes as boxlib
from ..nn.attention import AttnKey, TapSpec
from .guidance import _topk_mean, key_resolution

# BoxDiff's own attention keys: SD1.x's two 16x16 down and three 16x16 up
# attentions.
BOXDIFF_GUIDANCE_ATTN_KEYS: tuple[AttnKey, ...] = (
    ("down", 2, 0, 0), ("down", 2, 1, 0),
    ("up", 1, 0, 0), ("up", 1, 1, 0), ("up", 1, 2, 0),
)


def default_boxdiff_keys(ucfg) -> tuple[AttnKey, ...]:
    """Every attention of the last cross-attention down block and of the
    first cross-attention up block (for SD1.x: BOXDIFF_GUIDANCE_ATTN_KEYS)."""
    keys: list[AttnKey] = []
    for i in reversed(range(len(ucfg.down_block_types))):
        if ucfg.down_block_types[i] == "CrossAttnDownBlock2D":
            keys.extend(("down", i, j, 0) for j in range(ucfg.layers_per_block))
            break
    for i, block_type in enumerate(ucfg.up_block_types):
        if block_type == "CrossAttnUpBlock2D":
            keys.extend(("up", i, j, 0) for j in range(ucfg.layers_per_block + 1))
            break
    return tuple(keys)


@dataclass(frozen=True)
class BoxDiffSpec:
    """BoxDiff's hyperparameters."""

    keys: tuple[AttnKey, ...] = BOXDIFF_GUIDANCE_ATTN_KEYS
    top_p: float = 0.2           # P
    corner_halfwidth: int = 1    # L
    smooth_attentions: bool = True
    sigma: float = 0.5
    kernel_size: int = 3
    latent_scale: float = 20.0
    scale_range: tuple[float, float] = (1.0, 0.5)
    max_index_step: int = 25

    @property
    def tap_spec(self) -> TapSpec:
        return TapSpec(keys=self.keys, fused=False)


def make_boxdiff_data(bboxes, object_positions, spec: BoxDiffSpec, latent_hw,
                      num_levels, max_rows: int = 16) -> dict:
    """Padded host-side (numpy) rows, one per (object, token position). All
    guidance keys must share one attention resolution (their maps are
    concatenated)."""
    resolutions = {key_resolution(k, latent_hw, num_levels) for k in spec.keys}
    if len(resolutions) != 1:
        raise ValueError(f"BoxDiff keys span several resolutions: {resolutions}")
    H, W = next(iter(resolutions))

    rows = []
    L = spec.corner_halfwidth
    for obj_idx, positions in enumerate(object_positions):
        obj_boxes = bboxes[obj_idx]
        if obj_boxes and not isinstance(obj_boxes[0], (list, tuple)):
            obj_boxes = [obj_boxes]
        obj_mask = np.zeros((H, W), np.float32)
        corner_x = np.zeros((W,), np.float32)
        corner_y = np.zeros((H,), np.float32)
        for box in obj_boxes:
            x_min, y_min, x_max, y_max = boxlib.scale_proportion(box, H=H, W=W)
            obj_mask[y_min:y_max, x_min:x_max] = 1.0
            corner_x[max(x_min - L, 0): min(x_min + L + 1, W)] = 1.0
            corner_x[max(x_max - L, 0): min(x_max + L + 1, W)] = 1.0
            corner_y[max(y_min - L, 0): min(y_min + L + 1, H)] = 1.0
            corner_y[max(y_max - L, 0): min(y_max + L + 1, H)] = 1.0
        for pos in positions:
            rows.append((pos, obj_mask, corner_x, corner_y))

    R = max_rows
    if len(rows) > R:
        raise ValueError(f"{len(rows)} (object, token) rows > max_rows={R}")
    token_idx = np.zeros((R,), np.int64)
    masks = np.zeros((R, H, W), np.float32)
    corner_xs = np.zeros((R, W), np.float32)
    corner_ys = np.zeros((R, H), np.float32)
    kfg = np.ones((R,), np.int64)
    kbg = np.ones((R,), np.int64)
    valid = np.zeros((R,), np.float32)
    for r, (pos, m, cx, cy) in enumerate(rows):
        token_idx[r] = pos
        masks[r] = m
        corner_xs[r] = cx
        corner_ys[r] = cy
        kfg[r] = max(int(m.sum() * spec.top_p), 1)
        kbg[r] = max(int((1 - m).sum() * spec.top_p), 1)
        valid[r] = 1.0
    return {"token_idx": token_idx, "masks": masks, "corner_x": corner_xs,
            "corner_y": corner_ys, "gt_proj_x": masks.max(axis=1),
            "gt_proj_y": masks.max(axis=2), "kfg": kfg, "kbg": kbg, "valid": valid}


def _gaussian_kernel(kernel_size: int, sigma: float) -> np.ndarray:
    ax = np.arange(kernel_size) - (kernel_size - 1) / 2
    # Not the textbook exp(-x^2 / (2 sigma^2)): the reference's
    # GaussianSmoothing computes exp(-(x / (2 sigma))^2), an effective std of
    # sigma * sqrt(2). Kept as written, for the loss to match.
    g = np.exp(-((ax / (2.0 * sigma)) ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


def _smooth(images: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """(R, H, W) reflect-padded depthwise Gaussian blur."""
    k = torch.as_tensor(_gaussian_kernel(kernel_size, sigma), device=images.device)
    pad = (kernel_size - 1) // 2
    x = F.pad(images[:, None], (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(x, k[None, None])[:, 0]


def boxdiff_loss(taps: dict, data: dict, spec: BoxDiffSpec) -> torch.Tensor:
    """The total BoxDiff energy () of one cond-only forward's taps
    ({AttnKey: (1, heads, H*W, 77)}); `data`: `make_boxdiff_data`'s arrays
    as device tensors (`guidance.guidance_data_to_device`)."""
    H, W = data["masks"].shape[1:]
    attn = torch.cat([taps[k][0].float() for k in spec.keys], dim=0).mean(dim=0)

    text = torch.softmax(attn[:, 1:-1] * 100.0, dim=-1).reshape(H, W, -1)
    # Each row's token column, shifted by the removed BOS; a padded row's
    # index 0 wraps to the last column, as numpy indexing does (its row
    # weight is 0).
    cols = (data["token_idx"] - 1) % text.shape[-1]
    images = text[:, :, cols].permute(2, 0, 1)                # (R, H, W)
    if spec.smooth_attentions:
        images = _smooth(images, spec.kernel_size, spec.sigma)

    flat = images.reshape(images.shape[0], -1)
    m = data["masks"].reshape(data["masks"].shape[0], -1)
    fg = torch.relu(1.0 - _topk_mean(flat * m, data["kfg"]))
    bg = torch.relu(_topk_mean(flat * (1.0 - m), data["kbg"]))

    # amax spreads the gradient over ties evenly, as JAX's max does.
    proj_x = images.amax(dim=1)                               # (R, W)
    proj_y = images.amax(dim=2)                               # (R, H)
    dist_x = ((proj_x - data["gt_proj_x"]).abs() * data["corner_x"]).mean(dim=-1)
    dist_y = ((proj_y - data["gt_proj_y"]).abs() * data["corner_y"]).mean(dim=-1)
    return ((fg + bg + dist_x + dist_y) * data["valid"]).sum()


def boxdiff_update(unet_taps, latents: torch.Tensor, step_index: int, num_steps: int,
                   data: dict, spec: BoxDiffSpec):
    """One BoxDiff gradient step on the latents (1, H, W, C); unet_taps:
    latents -> taps (the cond-only early-exit forward). Returns (latents,
    loss ())."""
    x = latents.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = boxdiff_loss(unet_taps(x), data, spec)
        (grad,) = torch.autograd.grad(loss, x)
    s0, s1 = spec.scale_range
    frac = np.float32(step_index) / np.float32(max(num_steps - 1, 1))
    scale = np.sqrt(np.float32(s0) + np.float32(s1 - s0) * frac)
    return latents - float(np.float32(spec.latent_scale) * scale) * grad, loss.detach()
