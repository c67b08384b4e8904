"""Cross-attention energy guidance: losses over attention taps and the
per-step latent update loop (port of the JAX package's sampling/guidance.py).

- Per-prompt structure (token positions, rasterized box masks, top-k sizes)
  is precomputed on the host into padded arrays (`make_guidance_data`), then
  moved to the device as one image's data (`guidance_data_to_device`) or
  stacked along a leading image axis (`stack_guidance_data`).
- `ca_loss_batched` returns one loss per image; the summed loss decomposes
  per image, so one `torch.autograd.grad` gives every image's exact gradient.
- `guidance_update_batched` is the JAX `lax.while_loop` as a Python loop:
  each image's update is gated on the loss carried into the iteration, and
  the loop runs while any image is above the threshold and the iteration
  budget lasts (the JAX side's guidance.py:397-411).
- `ca_loss` and `guidance_update` are the single-image forms (unstacked
  data, a scalar loss): the batched ones at one image, which the JAX side
  states is the same function (its guidance.py:382-386).

Loss semantics follow the reference's max-based foreground/background loss
and reference-CA transfer loss, normalized over objects x attention keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import boxes as boxlib
from ..nn.attention import AttnKey, TapSpec
from ..utils import trace

DEFAULT_GUIDANCE_ATTN_KEYS: tuple[AttnKey, ...] = (
    ("mid", 0, 0, 0), ("up", 1, 0, 0), ("up", 1, 1, 0), ("up", 1, 2, 0),
)


def default_guidance_keys(ucfg) -> tuple[AttnKey, ...]:
    """The mid block's attention plus every attention of the first
    cross-attention up block (for SD1.x: DEFAULT_GUIDANCE_ATTN_KEYS)."""
    keys: list[AttnKey] = [("mid", 0, 0, 0)]
    for i, block_type in enumerate(ucfg.up_block_types):
        if block_type == "CrossAttnUpBlock2D":
            for j in range(ucfg.layers_per_block + 1):
                keys.append(("up", i, j, 0))
            break
    return tuple(keys)


def default_obj_attn_key(ucfg) -> AttnKey:
    """The last attention of the last cross-attention down block (for SD1.x:
    ("down", 2, 1, 0))."""
    for i in reversed(range(len(ucfg.down_block_types))):
        if ucfg.down_block_types[i] == "CrossAttnDownBlock2D":
            return ("down", i, ucfg.layers_per_block - 1, 0)
    raise ValueError("UNet has no cross-attention down blocks")


@dataclass(frozen=True)
class GuidanceSpec:
    keys: tuple[AttnKey, ...] = DEFAULT_GUIDANCE_ATTN_KEYS
    loss_scale: float = 30.0
    loss_threshold: float = 0.2
    max_index_step: int = 10
    fg_top_p: float = 0.2
    bg_top_p: float = 0.2
    fg_weight: float = 1.0
    bg_weight: float = 1.0
    use_ref_ca: bool = False
    ref_ca_loss_weight: float = 2.0

    @property
    def tap_spec(self) -> TapSpec:
        # Untapped layers of the guidance forward take the flash kernel, and
        # its backward kernel carries their gradient.
        return TapSpec(keys=self.keys)


def key_resolution(key: AttnKey, latent_hw: tuple[int, int], num_levels: int):
    """Spatial resolution (H, W) of the attention map at `key`."""
    place, idx = key[0], key[1]
    h, w = latent_hw
    if place == "down":
        f = 2**idx
    elif place == "mid":
        f = 2 ** (num_levels - 1)
    elif place == "up":
        f = 2 ** (num_levels - 1 - idx)
    else:
        raise ValueError(place)
    return h // f, w // f


def _boxes_to_mask(obj_boxes, H, W):
    mask = np.zeros((H, W), np.float32)
    for box in obj_boxes:
        mask = np.maximum(mask, boxlib.box_to_mask(box, H, W))
    return mask


def bucket(n: int) -> int:
    """Smallest power of two >= n (minimum 1): the shared pad sizes."""
    b = 1
    while b < n:
        b *= 2
    return b


def make_guidance_data(bboxes, object_positions, spec: GuidanceSpec,
                       latent_hw: tuple[int, int], num_levels: int,
                       word_token_indices=None, ref_box_to_obj=None,
                       max_objs: int | None = None, max_positions: int | None = None,
                       max_ref_boxes: int | None = None) -> dict:
    """Padded host-side (numpy) guidance arrays for one image, the same
    fields as the JAX side's make_guidance_data. Images stacked into one
    batch must share the pad sizes; None pads to the bucket of the actual
    object and position counts and to the actual number of reference boxes,
    as on the JAX side."""
    num_objects = len(bboxes)
    if max_objs is None:
        max_objs = bucket(max(num_objects, 1))
    if max_positions is None:
        max_positions = bucket(max((len(p) for p in object_positions), default=1))
    O = max_objs
    if num_objects > O:
        raise ValueError(f"{num_objects} objects > max_objs={O}; raise max_objs")

    norm_boxes = [b if b and isinstance(b[0], (list, tuple)) else [b] for b in bboxes]

    positions = np.zeros((O, max_positions), np.int64)
    pos_count = np.ones((O,), np.float32)
    obj_valid = np.zeros((O,), np.float32)
    for i, pos in enumerate(object_positions):
        pos = list(pos)[:max_positions]
        positions[i, : len(pos)] = pos
        pos_count[i] = max(len(pos), 1)
        obj_valid[i] = 1.0
    pos_valid = (np.arange(max_positions)[None] < pos_count[:, None]).astype(np.float32)
    pos_valid *= obj_valid[:, None]

    data = dict(positions=positions, pos_valid=pos_valid, pos_count=pos_count,
                obj_valid=obj_valid,
                num_objects=np.float32(max(num_objects, 1)),
                masks={}, kfg={}, kbg={})
    for key in spec.keys:
        H, W = key_resolution(key, latent_hw, num_levels)
        masks = np.zeros((O, H * W), np.float32)
        kfg = np.ones((O,), np.int64)
        kbg = np.ones((O,), np.int64)
        for i, obj_boxes in enumerate(norm_boxes):
            m = _boxes_to_mask(obj_boxes, H, W)
            masks[i] = m.reshape(-1)
            kfg[i] = max(int(m.sum() * spec.fg_top_p), 1)
            kbg[i] = max(int((1 - m).sum() * spec.bg_top_p), 1)
        data["masks"][key] = masks
        data["kfg"][key] = kfg
        data["kbg"][key] = kbg

    if spec.use_ref_ca:
        if word_token_indices is None or ref_box_to_obj is None:
            raise ValueError("ref-CA needs word_token_indices and ref_box_to_obj")
        flat_boxes = [b for obj_boxes in norm_boxes for b in obj_boxes]
        Bx = max_ref_boxes if max_ref_boxes is not None else len(flat_boxes)
        if len(flat_boxes) > Bx:
            raise ValueError(f"{len(flat_boxes)} ref boxes > {Bx}")
        boxes_per_obj = np.bincount(ref_box_to_obj, minlength=num_objects)
        box_word_idx = np.zeros((Bx,), np.int64)
        box_weight = np.zeros((Bx,), np.float32)
        for b, obj in enumerate(ref_box_to_obj):
            box_word_idx[b] = word_token_indices[obj]
            box_weight[b] = spec.ref_ca_loss_weight / max(int(boxes_per_obj[obj]), 1)
        data["ref_masks"] = {}
        for key in spec.keys:
            H, W = key_resolution(key, latent_hw, num_levels)
            masks = np.zeros((Bx, H * W), np.float32)
            for b, box in enumerate(flat_boxes):
                masks[b] = boxlib.box_to_mask(box, H, W).reshape(-1)
            data["ref_masks"][key] = masks
        data["box_word_idx"] = box_word_idx
        data["box_weight"] = box_weight
    return data


def stack_guidance_data(datas: list, device) -> dict:
    """Stack per-image guidance dicts along a new leading image axis as
    device tensors. All images must share the pad sizes."""

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return trace.to_device(np.stack(xs, axis=0), device, "tables_to_device")

    return stack(*datas)


def guidance_data_to_device(data: dict, device) -> dict:
    """One image's guidance dict as device tensors (no image axis), the
    data of `ca_loss` and of `sample(..., guidance_batched=False)`."""
    if isinstance(data, dict):
        return {k: guidance_data_to_device(v, device) for k, v in data.items()}
    return trace.to_device(np.asarray(data), device, "tables_to_device")


def _with_image_axis(tree):
    if isinstance(tree, dict):
        return {k: _with_image_axis(v) for k, v in tree.items()}
    return tree[None]


def _topk_mean(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mean of the k largest entries along the last axis; k broadcasts to
    x.shape[:-1] (a per-row top-k size)."""
    s = torch.sort(x, dim=-1, descending=True).values
    c = torch.cumsum(s, dim=-1)
    k = torch.broadcast_to(k, x.shape[:-1])
    kth = torch.gather(c, -1, (k - 1)[..., None])[..., 0]
    return kth / k.to(x.dtype)


def ca_loss_batched(taps: dict, data: dict, spec: GuidanceSpec,
                    ref_taps: dict | None = None) -> torch.Tensor:
    """Per-image unscaled losses (G,) for a batched guidance forward.

    taps: {AttnKey: (G, heads, n, L)}; data: stacked guidance tensors;
    ref_taps: {AttnKey: (G, Bx, heads, n)} reference maps for this step."""
    positions = data["positions"]                     # (G, O, P)
    G, O, P = positions.shape
    total = torch.zeros(G, dtype=torch.float32, device=positions.device)
    for key in spec.keys:
        attn = taps[key].float()                      # (G, heads, n, L)
        _, heads, n, _ = attn.shape
        idx = positions.reshape(G, 1, 1, O * P).expand(G, heads, n, O * P)
        sel = torch.gather(attn, -1, idx).reshape(G, heads, n, O, P)
        sel = sel.permute(0, 3, 4, 1, 2)              # (G, O, P, heads, n)
        m = data["masks"][key][:, :, None, None, :]   # (G, O, 1, 1, n)
        fg_mean = _topk_mean(sel * m, data["kfg"][key][:, :, None, None])
        bg_mean = _topk_mean(sel * (1.0 - m), data["kbg"][key][:, :, None, None])
        per_pos = ((1.0 - fg_mean).sum(-1) * spec.fg_weight
                   + bg_mean.sum(-1) * spec.bg_weight)            # (G, O, P)
        per_obj = (per_pos * data["pos_valid"]).sum(-1) / data["pos_count"]
        total = total + (per_obj * data["obj_valid"]).sum(-1)

    num_attn = len(spec.keys)
    total = total / (data["num_objects"] * num_attn)

    if spec.use_ref_ca and ref_taps is not None:
        ref_total = torch.zeros_like(total)
        eps = 1e-5
        bw = data["box_word_idx"]                     # (G, Bx)
        Bx = bw.shape[1]
        for key in spec.keys:
            attn = taps[key].float()                  # (G, heads, n, L)
            _, heads, n, _ = attn.shape
            tgt = torch.gather(attn, -1, bw.reshape(G, 1, 1, Bx).expand(G, heads, n, Bx))
            tgt = tgt.permute(0, 3, 1, 2)             # (G, Bx, heads, n)
            ref = ref_taps[key].float()
            mask = data["ref_masks"][key][:, :, None, :]  # (G, Bx, 1, n)
            tgt_m = tgt * mask
            tgt_norm = tgt_m / (tgt_m.sum(-1, keepdim=True) + eps)
            ref_m = ref * mask
            ref_norm = ref_m / (ref_m.sum(-1, keepdim=True) + eps)
            act = (tgt_norm - ref_norm).abs().sum(-1)     # (G, Bx, heads)
            ref_total = ref_total + (act.mean(-1) * data["box_weight"]).sum(-1)
        total = total + ref_total / (data["num_objects"] * num_attn)
    return total


def guidance_update_batched(unet_taps, latents: torch.Tensor, loss_in: torch.Tensor,
                            step_size: float, max_iter: int, data: dict,
                            spec: GuidanceSpec, ref_taps: dict | None = None):
    """Per-step guidance over a batch of independent images.

    unet_taps: latents -> taps dict (cond-only early-exit forward).
    latents (G, H, W, C) f32; loss_in (G,) the loss carried into this step.
    Returns (latents, last per-image loss). An image whose carried loss is
    at or below the threshold takes no update (it is frozen) while the others
    keep optimizing: the same result as running each image's loop alone."""
    lat, per_prev = latents, loss_in
    for _ in range(max_iter):
        with trace.wait("guidance_threshold"):
            above = bool((per_prev / spec.loss_scale > spec.loss_threshold).any())
        if not above:
            break
        with trace.annotate("guidance_iter"):
            x = lat.detach().requires_grad_(True)
            with torch.enable_grad():
                taps = unet_taps(x)
                per = ca_loss_batched(taps, data, spec, ref_taps=ref_taps) * spec.loss_scale
                (grad,) = torch.autograd.grad(per.sum(), x)
            active = (per_prev / spec.loss_scale > spec.loss_threshold).to(lat.dtype)
            lat = lat - grad * step_size * active[:, None, None, None]
            per_prev = per.detach()
    return lat, per_prev


def ca_loss(taps: dict, data: dict, spec: GuidanceSpec,
            ref_taps: dict | None = None) -> torch.Tensor:
    """The unscaled loss () of one image's (cond-only) guidance forward.

    taps: {AttnKey: (1, heads, n, L)}; data: one image's guidance tensors
    (`guidance_data_to_device`); ref_taps: {AttnKey: (Bx, heads, n)}
    reference maps for this step."""
    return ca_loss_batched(taps, _with_image_axis(data), spec,
                           None if ref_taps is None else _with_image_axis(ref_taps))[0]


def guidance_update(unet_taps, latents: torch.Tensor, loss_in: torch.Tensor,
                    step_size: float, max_iter: int, data: dict,
                    spec: GuidanceSpec, ref_taps: dict | None = None):
    """Per-step guidance of one image: while the de-scaled loss carried into
    an iteration is above the threshold and the budget lasts, step the
    latents (1, H, W, C) down the gradient of the scaled loss. loss_in () is
    the loss carried into this step; returns (latents, last loss ())."""
    lat, loss = guidance_update_batched(
        unet_taps, latents, loss_in[None], step_size, max_iter,
        _with_image_axis(data), spec,
        None if ref_taps is None else _with_image_axis(ref_taps))
    return lat, loss[0]
