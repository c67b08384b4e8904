"""Random weights made on the device from the run's seed, in a few large
draws: one normal draw per part and storage dtype, cut into the parameters'
shapes and scaled in place. Both the program and the reference are handed
the same tensors.

Scales: weights N(0, 1/fan_in); biases N(0, 0.02^2); norm scales 1 +
N(0, 0.1^2) and norm shifts N(0, 0.1^2); GLIGEN's gates N(0, 1) (tanh of it
opens every fuser); embeddings and SAM's tables at the scales their models
are initialised with. Norm parameters, and SAM's tables, are stored in
float32, as the program keeps them; everything else in the served dtype.
"""

from __future__ import annotations

import math

import torch

# Parameters kept in float32 whatever the compute dtype: the SD modules'
# norms; SAM's norms, relative-position tables, prompt tables and tokens.
SD_F32 = ("norm",)
SAM_F32 = ("norm", "rel_pos", "prompt_encoder.", "iou_token", "mask_tokens")


def _rule(name: str, shape: tuple) -> tuple[float, float]:
    """(std, mean) of a parameter's draw."""
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name:
        return (0.1, 1.0) if leaf == "weight" else (0.1, 0.0)
    if name.endswith(("alpha_attn", "alpha_dense")):
        return 1.0, 0.0
    if leaf == "bias":
        return 0.02, 0.0
    if "position_embedding" in name:
        return 0.01, 0.0
    if leaf == "pos_embed":
        return 0.02, 0.0
    if "token_embedding" in name or "rel_pos" in name or name.startswith(
            ("prompt_encoder.point_embed", "prompt_encoder.not_a_point_embed",
             "prompt_encoder.no_mask_embed")):
        return shape[-1] ** -0.5, 0.0
    if name.startswith(("prompt_encoder.shared_embedding", "mask_decoder.iou_token",
                        "mask_decoder.mask_tokens")):
        return 1.0, 0.0
    if len(shape) < 2:
        return 0.1, 0.0
    if "upscale_conv" in name:                 # (in, out, kh, kw)
        return shape[0] ** -0.5, 0.0
    return (math.prod(shape) // shape[0]) ** -0.5, 0.0


def make_state(shapes: dict, dtype: torch.dtype, f32_markers, generator, device) -> dict:
    """{name: tensor} for {name: shape}: the float32-kept names in one draw,
    the rest in one draw of `dtype`."""
    state = {}
    groups = {}
    for name, shape in shapes.items():
        keep = any(m in name for m in f32_markers)
        groups.setdefault(torch.float32 if keep else dtype, []).append((name, shape))
    for dt in sorted(groups, key=str):
        items = groups[dt]
        total = sum(math.prod(s) for _, s in items)
        flat = torch.randn(total, generator=generator, device=device, dtype=dt)
        start = 0
        for name, shape in items:
            n = math.prod(shape)
            view = flat[start:start + n].view(shape)
            std, mean = _rule(name, shape)
            view.mul_(std)
            if mean:
                view.add_(mean)
            state[name] = view
            start += n
    return state
