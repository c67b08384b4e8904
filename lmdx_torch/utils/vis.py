"""Visualization artifacts: box layouts, masks, indexed image saving (a copy
of the JAX package's utils/vis.py).

Parity with the reference's artifact-as-log behavior (utils/vis.py:223-243,
utils/parse.py:228-302): layout renderings (`boxes.png`), mask grids, and
`img_{i}.png` savers under the run directory — implemented with PIL (no
matplotlib dependency on the generation path).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw

_PALETTE = [(228, 26, 28), (55, 126, 184), (77, 175, 74), (152, 78, 163),
            (255, 127, 0), (255, 255, 51), (166, 86, 40), (247, 129, 191)]


def draw_boxes(gen_boxes, size: int = 512, bg_prompt: str = "",
               neg_prompt: str = "") -> Image.Image:
    """Render a layout: one colored rectangle + caption per box."""
    img = Image.new("RGB", (size, size), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for i, box in enumerate(gen_boxes):
        if isinstance(box, dict):
            name, (x, y, w, h) = box["name"], box["bounding_box"]
        else:
            name, (x, y, w, h) = box
        color = _PALETTE[i % len(_PALETTE)]
        draw.rectangle([x, y, x + w, y + h], outline=color, width=3)
        draw.text((x + 4, y + 4), str(name), fill=color)
    footer = bg_prompt + (f" | neg: {neg_prompt}" if neg_prompt else "")
    if footer:
        draw.text((4, size - 14), footer[:100], fill=(0, 0, 0))
    return img


def annotate_image(image: np.ndarray, boxes_xyxy_norm, names=None) -> Image.Image:
    """Draw normalized xyxy boxes over a generated image (utils.py:8-17)."""
    img = Image.fromarray(np.asarray(image)).convert("RGB")
    w, h = img.size
    draw = ImageDraw.Draw(img)
    for i, box in enumerate(boxes_xyxy_norm):
        x0, y0, x1, y1 = box
        color = _PALETTE[i % len(_PALETTE)]
        draw.rectangle([x0 * w, y0 * h, x1 * w, y1 * h], outline=color, width=2)
        if names is not None:
            draw.text((x0 * w + 2, y0 * h + 2), str(names[i]), fill=color)
    return img


def mask_grid(masks, cell: int = 128) -> Image.Image:
    """Tile binary masks into one grid image for inspection."""
    masks = [np.asarray(m) for m in masks]
    n = max(len(masks), 1)
    img = Image.new("L", (cell * n, cell), 0)
    for i, m in enumerate(masks):
        tile = Image.fromarray((m * 255).astype(np.uint8)).resize(
            (cell, cell), Image.NEAREST)
        img.paste(tile, (i * cell, 0))
    return img


class RunSaver:
    """Indexed artifact writer for one prompt's output directory
    (vis.display parity, utils/vis.py:223-243)."""

    def __init__(self, img_dir: str):
        self.img_dir = img_dir
        os.makedirs(img_dir, exist_ok=True)
        self._save_ind = 0

    def save(self, image, name: str = "img", index: int | None = None,
             indexed: bool = True) -> str:
        if isinstance(image, np.ndarray):
            image = Image.fromarray(image)
        if index is None and indexed:
            index = self._save_ind
            self._save_ind += 1
        suffix = f"_{index}" if index is not None else ""
        path = os.path.join(self.img_dir, f"{name}{suffix}.png")
        image.save(path)
        return path


def mask_overlay(masks, size: int | None = None, seed: int = 0) -> Image.Image:
    """Composite all masks into ONE image, each with its own random bright
    color (reference parse.show_masks, utils/parse.py:293-302: colors drawn
    uniform in [0.4, 1.0) per mask, overlapping masks sum). Seeded here so
    artifacts are reproducible."""
    rng = np.random.default_rng(seed)
    masks = [np.asarray(m, np.float32) for m in masks]
    h, w = masks[0].shape if masks else (64, 64)
    out = np.zeros((h, w, 3), np.float32)
    for m in masks:
        color = rng.random(3) * 0.6 + 0.4
        out += m[..., None] * color[None, None, :]
    img = Image.fromarray((np.clip(out, 0.0, 1.0) * 255).astype(np.uint8))
    if size:
        img = img.resize((size, size), Image.NEAREST)
    return img


def _colormap(x: np.ndarray) -> np.ndarray:
    """Map [0,1] floats to an RGB heat ramp (black->purple->orange->yellow),
    a dependency-free stand-in for matplotlib's inferno-style maps."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(3.0 * x, 0, 1)
    g = np.clip(3.0 * x - 1.0, 0, 1)
    b = np.clip(np.sin(np.pi * x) * 0.7 + (x < 0.33) * 0.3, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def heatmap(array: np.ndarray, size: int | None = None,
            normalize: bool = True) -> Image.Image:
    """Render a 2D array as a heat image (vis.visualize equivalent)."""
    a = np.asarray(array, np.float32)
    if normalize:
        lo, hi = float(a.min()), float(a.max())
        a = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    img = Image.fromarray(_colormap(a))
    if size:
        img = img.resize((size, size), Image.NEAREST)
    return img


def array_grid(arrays, titles=None, cell: int = 128) -> Image.Image:
    """Tile 2D arrays as heatmaps in a row (vis.visualize_arrays
    equivalent, reference utils/vis.py:20-42)."""
    arrays = list(arrays)
    n = max(len(arrays), 1)
    img = Image.new("RGB", (cell * n, cell + 14), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    for i, a in enumerate(arrays):
        img.paste(heatmap(a, size=cell), (i * cell, 0))
        if titles is not None:
            draw.text((i * cell + 2, cell + 1), str(titles[i])[:20],
                      fill=(0, 0, 0))
    return img


def attn_heatmaps(taps_stack, steps=None, cell: int = 128) -> Image.Image:
    """Cross-attention maps of one token across timesteps as a heat strip
    (vis.visualize_attn / visualize_across_timesteps equivalent, reference
    utils/vis.py:115-207). taps_stack: (T, heads, n) or (T, 1, heads, n, 1)
    single-token tap stacks from the sampler."""
    stack = np.asarray(taps_stack)
    if stack.ndim == 5:
        stack = stack[:, 0, :, :, 0]
    maps = stack.mean(axis=1)                      # (T, n) head-mean
    hw = int(round(maps.shape[-1] ** 0.5))
    t_idx = list(steps) if steps is not None else list(range(maps.shape[0]))
    return array_grid([maps[t].reshape(hw, hw) for t in t_idx],
                      titles=[f"t{t}" for t in t_idx], cell=cell)


def masked_latents(latents, mask, cell: int = 256) -> Image.Image:
    """Channel-mean latent heatmap beside its masked version
    (vis.visualize_masked_latents equivalent, reference utils/vis.py:44-113).
    latents: (B, H, W, C) or (H, W, C); mask: (H, W)."""
    lat = np.asarray(latents, np.float32)
    if lat.ndim == 4:
        lat = lat[0]
    plane = lat.mean(axis=-1)
    m = np.asarray(mask, np.float32)
    return array_grid([plane, plane * m, m],
                      titles=["latents", "masked", "mask"], cell=cell)


def latent_trajectory_strip(all_latents, stride: int = 5,
                            cell: int = 96) -> Image.Image:
    """Latent evolution across the sampling trajectory
    (vis.visualize_across_timesteps equivalent). all_latents:
    (S+1, B, H, W, C) trajectory from save_all_latents."""
    traj = np.asarray(all_latents, np.float32)
    planes = traj[::stride, 0].mean(axis=-1)       # (k, H, W)
    return array_grid(list(planes),
                      titles=[f"s{i * stride}" for i in range(len(planes))],
                      cell=cell)
