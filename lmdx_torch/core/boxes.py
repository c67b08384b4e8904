"""Normalized bounding-box and binary-mask algebra (host-side, numpy).

These are the geometric primitives shared by layout parsing, latent
composition, guidance-mask construction, and evaluation. They run on the host
once per image (never inside the jitted denoising loop), so plain numpy is the
right tool; torch counterparts for device code live in `lmdx_torch.sampling`.

Behavioral parity notes (reference: utils/utils.py):
- `scale_proportion` rounds the box *size* separately from the origin so box
  sizes are shift-invariant (utils.py:57-70).
- `binary_mask_to_box` enlarges the box by one pixel on each side by default
  (utils.py:72-88).
- `shift_tensor` aligns normalized offsets on a base 8x8 grid so the same
  normalized shift lands on exact texel boundaries at every attention
  resolution (utils.py:145-180).
"""

from __future__ import annotations

import numpy as np

Box = tuple[float, float, float, float]  # normalized (x_min, y_min, x_max, y_max)


def convert_box_xywh_to_xyxy_norm(box, height: int, width: int) -> Box:
    """Pixel (x, y, w, h) on the 512-grid -> normalized (x0, y0, x1, y1).

    Parity: utils/parse.py:304-311.
    """
    x_min, y_min = box[0] / width, box[1] / height
    w, h = box[2] / width, box[3] / height
    return (x_min, y_min, x_min + w, y_min + h)


def scale_proportion(box: Box, H: int, W: int) -> tuple[int, int, int, int]:
    """Normalized box -> integer pixel box on an (H, W) grid.

    Rounds the origin and the *size* independently so that shifting a box by a
    whole number of pixels never changes its rasterized size.
    """
    x_min, y_min = round(box[0] * W), round(box[1] * H)
    box_w = round((box[2] - box[0]) * W)
    box_h = round((box[3] - box[1]) * H)
    x_max, y_max = x_min + box_w, y_min + box_h
    x_min, y_min = max(x_min, 0), max(y_min, 0)
    x_max, y_max = min(x_max, W), min(y_max, H)
    return x_min, y_min, x_max, y_max


def box_to_mask(box: Box, H: int, W: int, dtype=np.float32) -> np.ndarray:
    """Rasterize a normalized box into a binary (H, W) mask."""
    x_min, y_min, x_max, y_max = scale_proportion(box, H, W)
    mask = np.zeros((H, W), dtype=dtype)
    mask[y_min:y_max, x_min:x_max] = 1.0
    return mask


def get_centered_box(
    box: Box,
    horizontal_center_only: bool = True,
    vertical_placement: str = "centered",
    vertical_center: float = 0.5,
    floor_padding: float | None = None,
) -> list[float]:
    """Move a box to the image center, preserving its size.

    Used for single-object generation so the object is rendered centered and
    later shifted into place during latent composition.
    """
    x_min, y_min, x_max, y_max = box
    w = x_max - x_min
    x_min_new, x_max_new = 0.5 - w / 2, 0.5 + w / 2
    if horizontal_center_only:
        return [x_min_new, y_min, x_max_new, y_max]

    h = y_max - y_min
    if vertical_placement == "centered":
        if floor_padding is not None:
            raise ValueError("floor_padding requires vertical_placement='floor_padding'")
        y_min_new = vertical_center - h / 2
        y_max_new = vertical_center + h / 2
    elif vertical_placement == "floor_padding":
        y_max_new = 1 - floor_padding
        y_min_new = y_max_new - h
    else:
        raise ValueError(f"Unknown vertical placement: {vertical_placement}")
    return [x_min_new, y_min_new, x_max_new, y_max_new]


def mask_to_box(mask: np.ndarray, enlarge_box_by_one: bool = True):
    """Tight integer pixel box (x_min, y_min, x_max, y_max) around a binary mask."""
    mask = np.asarray(mask)
    ys, xs = np.where(mask)
    if ys.size == 0:
        raise ValueError("The mask is empty")
    height, width = mask.shape
    if enlarge_box_by_one:
        y_min, y_max = max(int(ys.min()) - 1, 0), min(int(ys.max()) + 1, height)
        x_min, x_max = max(int(xs.min()) - 1, 0), min(int(xs.max()) + 1, width)
    else:
        y_min, y_max = int(ys.min()), int(ys.max())
        x_min, x_max = int(xs.min()), int(xs.max())
    return [x_min, y_min, x_max, y_max]


def mask_to_box_mask(mask: np.ndarray) -> np.ndarray:
    """Replace a binary mask with the filled rectangle of its bounding box.

    Note the +1 on the max corner: the rectangle is inclusive of the enlarged
    box edge, matching utils.py:90-100.
    """
    x_min, y_min, x_max, y_max = mask_to_box(mask)
    out = np.zeros_like(np.asarray(mask), dtype=np.float32)
    out[y_min : y_max + 1, x_min : x_max + 1] = 1.0
    return out


def mask_center(mask: np.ndarray, normalize: bool = False):
    """Mass center (x, y) of a binary/soft mask.

    An all-zero mask (degenerate segmentation) returns the geometric center
    rather than NaN; the resulting alignment shift is harmless because an
    empty mask contributes nothing to latent composition."""
    mask = np.asarray(mask, dtype=np.float64)
    h, w = mask.shape
    total = mask.sum()
    if total == 0:
        return (0.5, 0.5) if normalize else ((w - 1) / 2, (h - 1) / 2)
    x = float(mask.sum(axis=0) @ np.arange(w)) / total
    y = float(mask.sum(axis=1) @ np.arange(h)) / total
    if normalize:
        x, y = x / w, y / h
    return x, y


def mask_iou(mask: np.ndarray, masks: np.ndarray, eps: float = 1e-6) -> np.ndarray:
    """IoU of one (h, w) mask against a stack of (n, h, w) masks."""
    mask = np.asarray(mask).astype(bool)[None]
    masks = np.asarray(masks).astype(bool)
    inter = (mask & masks).sum(axis=(1, 2))
    union = (mask | masks).sum(axis=(1, 2))
    return inter / (union + eps)


def expand_overall_bboxes(overall_bboxes):
    """Flatten [[boxes for phrase 1], [boxes for phrase 2], ...] -> [box, ...]."""
    return sum(overall_bboxes, start=[])


def snap_offset_to_grid(
    x_offset: float, y_offset: float, base_h: int = 8, base_w: int = 8
) -> tuple[int, int]:
    """Quantize a normalized (x, y) offset to whole texels of a base grid.

    All spatial tensors we shift (64x64 latents, 64x64/32x32/16x16/8x8
    attention maps) are multiples of 8, so snapping the normalized offset to
    the 8x8 grid guarantees the *same* physical shift at every resolution.
    """
    return round(x_offset * base_w), round(y_offset * base_h)


def shift_tensor(
    tensor: np.ndarray,
    x_offset: float,
    y_offset: float,
    base_w: int = 8,
    base_h: int = 8,
    offset_normalized: bool = False,
    ignore_last_dim: bool = False,
) -> np.ndarray:
    """Shift the trailing 2D (or 2D-before-last) dims, zero-filling the border.

    With `offset_normalized`, the offset is first snapped to the base grid
    (see `snap_offset_to_grid`) then scaled to this tensor's resolution.
    """
    if ignore_last_dim:
        tensor_h, tensor_w = tensor.shape[-3:-1]
    else:
        tensor_h, tensor_w = tensor.shape[-2:]
    if offset_normalized:
        if tensor_h % base_h or tensor_w % base_w:
            raise ValueError(f"({tensor_h}, {tensor_w}) not a multiple of ({base_h}, {base_w})")
        bx, by = snap_offset_to_grid(x_offset, y_offset, base_h=base_h, base_w=base_w)
        x_offset = bx * (tensor_w // base_w)
        y_offset = by * (tensor_h // base_h)
    x_offset, y_offset = int(x_offset), int(y_offset)

    new_tensor = np.zeros_like(tensor)
    overlap_w = tensor_w - abs(x_offset)
    overlap_h = tensor_h - abs(y_offset)
    if overlap_w <= 0 or overlap_h <= 0:
        return new_tensor

    y_src, y_dst = (0, y_offset) if y_offset >= 0 else (-y_offset, 0)
    x_src, x_dst = (0, x_offset) if x_offset >= 0 else (-x_offset, 0)

    if ignore_last_dim:
        new_tensor[..., y_dst : y_dst + overlap_h, x_dst : x_dst + overlap_w, :] = tensor[
            ..., y_src : y_src + overlap_h, x_src : x_src + overlap_w, :
        ]
    else:
        new_tensor[..., y_dst : y_dst + overlap_h, x_dst : x_dst + overlap_w] = tensor[
            ..., y_src : y_src + overlap_h, x_src : x_src + overlap_w
        ]
    return new_tensor


def box_iou_xyxy(box1, box2) -> float:
    """IoU of two (x0, y0, x1, y1) boxes (pixel or normalized, consistent units)."""
    x0 = max(box1[0], box2[0])
    y0 = max(box1[1], box2[1])
    x1 = min(box1[2], box2[2])
    y1 = min(box1[3], box2[3])
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    a1 = max(0.0, box1[2] - box1[0]) * max(0.0, box1[3] - box1[1])
    a2 = max(0.0, box2[2] - box2[0]) * max(0.0, box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0
