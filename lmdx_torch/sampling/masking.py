"""Foreground-mask refinement: attention/box -> per-object latent mask.

After a per-box pass, LMD needs a latent-resolution foreground mask for the
generated object. The reference prompts SAM with either the aggregated
cross-attention map's peak (LMD, models/sam.py:125-172) or the target box
(LMD+, models/sam.py:182-213), then selects among SAM's three masks with a
"largest_over_conf" rule penalizing low confidence / low IoU-vs-coarse-mask
(models/sam.py:67-111).

Here the segmenter is pluggable:

- `CoarseSegmenter` (default, weightless): returns the coarse mask itself —
  the thresholded attention map or the box raster. Generation runs fully
  offline; quality matches the reference's no-SAM ablation.
- `nn/sam.py::SamSegmenter` (SAM ViT-B, from seeded random weights or a
  state dict with transformers `SamModel` key names) drops in via the same
  protocol.

Prompt extraction and mask selection are host-side numpy (once per box, off
the hot path); a real segmenter's forward runs batched — all boxes of a
pipeline batch in one `segment_batch` call (see refine_masks_from_boxes /
refine_masks_from_attn).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np
from scipy import ndimage

from ..core import boxes as boxlib


class Segmenter(Protocol):
    def segment(self, image, input_points=None, input_boxes=None,
                target_hw=None) -> tuple[np.ndarray, np.ndarray]:
        """Returns (masks (K, H, W) bool, conf_scores (K,))."""
        ...


@dataclass(frozen=True)
class RefineConfig:
    """Defaults: reference generation/lmd.py:36-48."""

    use_box_input: bool = False
    gaussian_sigma_point: float = 1.5
    gaussian_sigma_box: float = 0.1
    mask_th_for_point: float = 0.25
    mask_th_for_box: float = 0.05
    n_erode_dilate_mask_for_box: int = 1
    discourage_mask_below_confidence: float = 0.85
    discourage_mask_below_coarse_iou: float = 0.25


class CoarseSegmenter:
    """Weightless fallback segmenter: echoes its prompt as the mask."""

    # Prompt-only: callers may skip decoding per-box pixels entirely.
    needs_image = False

    def segment(self, image=None, input_points=None, input_boxes=None,
                target_hw=None):
        h, w = target_hw
        if input_boxes is not None:
            x0, y0, x1, y1 = input_boxes[0]
            mask = boxlib.box_to_mask((x0, y0, x1, y1), h, w) > 0
        elif input_points is not None:
            # A small disk around the point; callers always intersect with the
            # coarse attention mask via IoU selection, so radius is lax.
            yy, xx = np.mgrid[0:h, 0:w]
            px, py = input_points[0]
            r = max(h, w) / 4
            mask = (yy - py * h) ** 2 + (xx - px * w) ** 2 <= r * r
        else:
            raise ValueError("need input_points or input_boxes")
        return mask[None].astype(bool), np.ones((1,), np.float32)


def preprocess_mask(attn_smooth: np.ndarray, mask_th: float,
                    n_erode_dilate: int = 0) -> np.ndarray:
    """Normalize to [0,1], threshold, optional erode+dilate (sam.py:113-122)."""
    normalized = attn_smooth - attn_smooth.min()
    peak = normalized.max()
    if peak > 0:
        normalized = normalized / peak
    mask = normalized > mask_th
    if n_erode_dilate:
        mask = ndimage.binary_erosion(mask, iterations=n_erode_dilate)
        mask = ndimage.binary_dilation(mask, iterations=n_erode_dilate)
    return mask


def resize_mask(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour mask resize (host-side, tiny arrays)."""
    src_h, src_w = mask.shape
    ys = (np.arange(h) * src_h // h).clip(0, src_h - 1)
    xs = (np.arange(w) * src_w // w).clip(0, src_w - 1)
    return mask[np.ix_(ys, xs)]


def select_mask(masks: np.ndarray, conf_scores: np.ndarray,
                coarse_ious: np.ndarray | None, cfg: RefineConfig) -> np.ndarray:
    """largest_over_conf selection rule (sam.py:67-111)."""
    sizes = masks.sum(axis=(1, 2)).astype(np.float64)
    max_size = sizes.max() if len(sizes) else 0.0
    scores = sizes - (conf_scores < cfg.discourage_mask_below_confidence) * max_size
    if coarse_ious is not None:
        scores = scores - (coarse_ious < cfg.discourage_mask_below_coarse_iou) * max_size
    return masks[int(np.argmax(scores))]


def _segment_many(segmenter: Segmenter, images, latent_hw,
                  input_points=None, input_boxes=None):
    """One prompt per image; uses the segmenter's batched forward when it has
    one (SamSegmenter: the 1024² encoder passes in chunks of four images),
    else falls back to per-item segment. Returns list of (masks, conf)."""
    batched = getattr(segmenter, "segment_batch", None)
    if batched is not None:
        return batched(images, input_points=input_points,
                       input_boxes=input_boxes, target_hw=latent_hw)
    n = len(images)
    return [
        segmenter.segment(
            images[i],
            input_points=None if input_points is None else input_points[i],
            input_boxes=None if input_boxes is None else input_boxes[i],
            target_hw=latent_hw)
        for i in range(n)
    ]


def refine_masks_from_attn(
    attn_maps,                  # list of (h, w) aggregated token attention
    images,                     # decoded per-box images (for real segmenters)
    latent_hw: tuple[int, int],
    segmenter: Segmenter,
    cfg: RefineConfig = RefineConfig(),
) -> list[np.ndarray]:
    """LMD mask path, batched over boxes: smooth -> threshold ->
    point-or-box prompt -> one batched segment -> IoU-guided selection per
    box (sam.py:125-172). Returns (H, W) float masks at latent resolution."""
    sigma = (cfg.gaussian_sigma_box if cfg.use_box_input
             else cfg.gaussian_sigma_point)
    coarses, prompts = [], []
    for attn_map in attn_maps:
        smooth = ndimage.gaussian_filter(attn_map.astype(float), sigma=sigma)
        if cfg.use_box_input:
            coarse = preprocess_mask(smooth, cfg.mask_th_for_box,
                                     cfg.n_erode_dilate_mask_for_box)
            ch, cw = coarse.shape
            x0, y0, x1, y1 = boxlib.mask_to_box(coarse)
            prompts.append([(x0 / cw, y0 / ch, x1 / cw, y1 / ch)])
        else:
            coarse = preprocess_mask(smooth, cfg.mask_th_for_point)
            py, px = np.unravel_index(int(np.argmax(smooth)), smooth.shape)
            prompts.append([(px / smooth.shape[1], py / smooth.shape[0])])
        coarses.append(coarse)

    results = _segment_many(
        segmenter, images, latent_hw,
        input_points=None if cfg.use_box_input else prompts,
        input_boxes=prompts if cfg.use_box_input else None)

    out = []
    for coarse, (masks, conf) in zip(coarses, results):
        coarse_resized = resize_mask(coarse, *latent_hw).astype(bool)
        ious = boxlib.mask_iou(coarse_resized, masks)
        selected = select_mask(masks, conf, ious, cfg)
        if (cfg.use_box_input is False
                and isinstance(segmenter, CoarseSegmenter)):
            # The fallback point-disk carries no shape information; intersect
            # with the thresholded attention for a tighter weightless mask.
            selected = selected & coarse_resized
            if not selected.any():
                selected = coarse_resized
        out.append(selected.astype(np.float32))
    return out


def refine_masks_from_boxes(
    boxes,                      # list of normalized xyxy
    images,
    latent_hw: tuple[int, int],
    segmenter: Segmenter,
    cfg: RefineConfig = RefineConfig(),
) -> list[np.ndarray]:
    """LMD+ mask path, batched over boxes: each target box is its prompt
    (sam.py:182-213); all boxes segment in one batched forward."""
    h, w = latent_hw
    results = _segment_many(segmenter, images, latent_hw,
                            input_boxes=[[b] for b in boxes])
    out = []
    for box, (masks, conf) in zip(boxes, results):
        coarse = boxlib.box_to_mask(box, h, w) > 0
        ious = boxlib.mask_iou(coarse, masks)
        out.append(select_mask(masks, conf, ious, cfg).astype(np.float32))
    return out


def refine_mask_from_attn(attn_map, image, latent_hw, segmenter,
                          cfg: RefineConfig = RefineConfig()) -> np.ndarray:
    """Single-box convenience wrapper over refine_masks_from_attn."""
    [mask] = refine_masks_from_attn([attn_map], [image], latent_hw,
                                    segmenter, cfg)
    return mask


def refine_mask_from_box(box, image, latent_hw, segmenter,
                         cfg: RefineConfig = RefineConfig()) -> np.ndarray:
    """Single-box convenience wrapper over refine_masks_from_boxes."""
    [mask] = refine_masks_from_boxes([box], [image], latent_hw,
                                     segmenter, cfg)
    return mask
