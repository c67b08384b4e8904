"""Plain reference of what a grounded-generation call derives on the host
from its layout spec, and of the step from the segmenter's logits to the
latent masks.

- `plan`: the per-box prompts, phrases, guidance words and boxes (sorted by
  name, centered with floor padding where the method centers them), and the
  overall prompt with one phrase per distinct name ("two cats" for two "a
  cat" boxes) and its boxes;
- `positions`: a phrase's token positions in a prompt and its guidance
  word's, under the word-level tokenizer (one word, one token, BOS first);
- `tables`: the guidance tables of one image: token positions, box rasters
  at each tapped resolution, top-k sizes, and the reference-attention
  tables (one row per box);
- `sam_prompt` and `latent_masks`: the segmenter's prompt for a box (the box
  itself, or the peak of the smoothed aggregated attention) and the mask it
  keeps: logits resized to the image and thresholded, resized to the latent
  grid, and picked by size, penalised below a confidence and below an IoU
  with the coarse mask.

The settings are the LMD paper's code's defaults for its two methods.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from .sd import _WORD_RE

CANVAS = 512
TOP_P = 0.2                  # fg_top_p and bg_top_p, per-box and overall
REF_CA_WEIGHT = 2.0
ATTN_START = 10              # first step of the aggregated attention
SIGMA_POINT = 1.5
MASK_TH_POINT = 0.25
MIN_CONF, MIN_COARSE_IOU = 0.85, 0.25
METHODS = {
    # per-box boxes centered (floor padding 0.2) and per-box guidance; the
    # segmenter prompted by the attention's peak; no GLIGEN
    "lmd": {"center": True, "floor_padding": 0.2, "per_box_guidance": True,
            "prompt": "attention", "gligen": False},
    # boxes kept in place, no per-box guidance; the box prompts the segmenter;
    # GLIGEN grounds both passes
    "lmd_plus": {"center": False, "per_box_guidance": False, "prompt": "box", "gligen": True},
}
NUMBERS = ("zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
           "ten")


def words(text: str) -> list[str]:
    return _WORD_RE.findall(" ".join(text.split()).lower())


def _plural(phrase: str) -> str:
    parts = phrase.split(" ")
    if parts[0] in ("a", "an"):
        parts = parts[1:]
    w = parts[-1]
    if w.endswith(("s", "x", "z", "ch", "sh", "o")):
        raise ValueError(f"the reference pluralises regular nouns only, not {w!r}")
    parts[-1] = w[:-1] + "ies" if w.endswith("y") and w[-2] not in "aeiou" else w + "s"
    return " ".join(parts)


def _box(xywh):
    x, y, w, h = xywh
    return (x / CANVAS, y / CANVAS, x / CANVAS + w / CANVAS, y / CANVAS + h / CANVAS)


def _center(box, floor_padding):
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    return [0.5 - w / 2, 1 - floor_padding - h, 0.5 + w / 2, 1 - floor_padding]


def plan(spec: dict, method: str) -> dict:
    s = METHODS[method]
    bg = spec["bg_prompt"]
    named = sorted(((name, _box(b)) for name, b in spec["gen_boxes"]), key=lambda nb: nb[0])
    per_box = []
    for name, box in named:
        if s["center"]:
            box = _center(box, s["floor_padding"])
        per_box.append((f"{bg} with {name}" if bg else name, name, name.split(" ")[-1], box))
    overall = []
    for name in sorted({n for n, _ in named}):
        boxes = [b for n, b in named if n == name]
        phrase = f"{NUMBERS[len(boxes)]} {_plural(name)}" if len(boxes) > 1 else name
        overall.append((phrase, phrase.split(" ")[-1], boxes))
    objects = ", ".join(p for p, _, _ in overall)
    prompt = (f"{bg} with {objects}" if bg else objects) if objects else bg
    return {"per_box": per_box, "overall": overall, "overall_prompt": prompt}


def positions(prompt: str, phrase: str, word: str) -> tuple[list[int], int]:
    """(the phrase's token positions in the prompt, the guidance word's)."""
    toks = ["<bos>", *words(prompt)]
    ph = words(phrase)
    for i in range(len(toks) - len(ph) + 1):
        if toks[i:i + len(ph)] == ph:
            return list(range(i, i + len(ph))), i + ph.index(words(word)[-1])
    raise ValueError(f"{phrase!r} is not in {prompt!r}")


def raster(box, h: int, w: int) -> np.ndarray:
    """A normalised box on an (h, w) grid: origin and size rounded apart."""
    x0, y0 = round(box[0] * w), round(box[1] * h)
    x1, y1 = x0 + round((box[2] - box[0]) * w), y0 + round((box[3] - box[1]) * h)
    m = np.zeros((h, w), bool)
    m[max(y0, 0):min(y1, h), max(x0, 0):min(x1, w)] = True
    return m


def tables(objects, resolutions: dict, ref_ca: bool) -> dict:
    """One image's guidance tables. `objects`: [(boxes, positions, word)];
    `resolutions`: {key: (h, w)}."""
    out = {"positions": [p for _, p, _ in objects], "masks": {}, "kfg": {}, "kbg": {}}
    for key, (h, w) in resolutions.items():
        ms = [np.logical_or.reduce([raster(b, h, w) for b in boxes]) for boxes, _, _ in objects]
        out["masks"][key] = ms
        out["kfg"][key] = [max(int(int(m.sum()) * TOP_P), 1) for m in ms]
        out["kbg"][key] = [max(int(int((~m).sum()) * TOP_P), 1) for m in ms]
    if ref_ca:
        flat = [(b, word, len(boxes)) for boxes, _, word in objects for b in boxes]
        out["box_word_idx"] = [word for _, word, _ in flat]
        out["box_weight"] = [REF_CA_WEIGHT / n for _, _, n in flat]
        out["ref_masks"] = {key: [raster(b, h, w) for b, _, _ in flat]
                            for key, (h, w) in resolutions.items()}
    return out


def aggregate(stack: np.ndarray) -> np.ndarray:
    """A (steps, heads, n) single-token attention stack (or (steps, 1,
    heads, n, 1)) -> its (h, w) map: the mean over heads and over the steps
    from ATTN_START."""
    stack = np.asarray(stack, np.float32)
    if stack.ndim == 5:
        stack = stack[:, 0, :, :, 0]
    a = stack[min(ATTN_START, stack.shape[0] - 1):].mean(axis=0).mean(axis=0)
    side = int(round(a.shape[0] ** 0.5))
    return a.reshape(side, side)


def sam_prompt(method: str, box=None, attn_map=None):
    """(the segmenter's prompt, the coarse mask at the map's or no size):
    ("box", xyxy) or ("point", (x, y)), normalised."""
    if METHODS[method]["prompt"] == "box":
        return ("box", tuple(float(v) for v in box)), None
    smooth = ndimage.gaussian_filter(np.asarray(attn_map, np.float64), sigma=SIGMA_POINT)
    norm = smooth - smooth.min()
    if norm.max() > 0:
        norm = norm / norm.max()
    py, px = np.unravel_index(int(np.argmax(smooth)), smooth.shape)
    return ("point", (px / smooth.shape[1], py / smooth.shape[0])), norm > MASK_TH_POINT


def _nearest(mask: np.ndarray, h: int, w: int) -> np.ndarray:
    sh, sw = mask.shape
    return mask[np.ix_(np.arange(h) * sh // h, np.arange(w) * sw // w)]


def latent_masks(logits: torch.Tensor, size: int, image_hw, latent_hw) -> np.ndarray:
    """(n, k, s, s) low-resolution logits -> (n, k, h, w) bool latent masks."""
    def up(x, hw):
        return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)

    x = up(up(logits.float(), (size, size)), tuple(image_hw))
    return (up((x > 0).float(), tuple(latent_hw)) != 0).cpu().numpy()


def select(masks: np.ndarray, iou: np.ndarray, coarse: np.ndarray) -> np.ndarray:
    """The kept one of k (h, w) masks: the largest, less the largest's size
    where its confidence or its IoU with the coarse mask is low."""
    sizes = masks.sum(axis=(1, 2)).astype(np.float64)
    inter = (masks & coarse[None]).sum(axis=(1, 2))
    union = (masks | coarse[None]).sum(axis=(1, 2))
    ious = inter / (union + 1e-6)
    scores = sizes - (iou < MIN_CONF) * sizes.max() - (ious < MIN_COARSE_IOU) * sizes.max()
    return masks[int(np.argmax(scores))]


def coarse_mask(method: str, box, point_coarse, latent_hw) -> np.ndarray:
    h, w = latent_hw
    if METHODS[method]["prompt"] == "box":
        return raster(box, h, w)
    return _nearest(point_coarse, h, w).astype(bool)
