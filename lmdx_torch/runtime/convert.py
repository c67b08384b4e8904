"""JAX parameter trees -> the port's state dicts (diffusers / transformers key
names), so that both packages can run the same weights.

`from_jax_params(params, config)` takes the JAX bundle's parameter tree with
numpy leaves ({"unet", "text", "vae", "position_net"}) and returns
{"unet", "text", "vae", "position_net"} state dicts of f32 tensors:

- Dense kernel (in, out)   -> Linear weight (out, in)
- Conv kernel HWIO         -> Conv2d weight OIHW
- norm `scale`             -> `weight`; Embed `embedding` -> `weight`
- GLIGEN `alpha_attn` / `alpha_dense` and PositionNet null features as they are

Only the VAE's decode half is converted (the port has no encoder yet).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..config import SDConfig

_INDEXED = re.compile(r"(down_blocks|up_blocks|resnets|attentions|linears)_(\d+)")
_SEGMENTS = {
    "downsample": "downsamplers.0",
    "upsample": "upsamplers.0",
    "to_out": "to_out.0",
    "mid": "mid_block",
    "token_embedding": "text_model.embeddings.token_embedding",
    "final_layer_norm": "text_model.final_layer_norm",
    "fc1": "mlp.fc1",
    "fc2": "mlp.fc2",
}
_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def _segment(seg: str) -> str:
    if m := _INDEXED.fullmatch(seg):
        return f"{m[1]}.{m[2]}"
    if m := re.fullmatch(r"blocks_(\d+)", seg):
        return f"transformer_blocks.{m[1]}"
    if m := re.fullmatch(r"net_(\d+)", seg):
        return f"net.{m[1]}"
    if m := re.fullmatch(r"layers_(\d+)", seg):
        return f"text_model.encoder.layers.{m[1]}"
    if m := re.fullmatch(r"up_(\d+)_resnets_(\d+)", seg):
        return f"up_blocks.{m[1]}.resnets.{m[2]}"
    if m := re.fullmatch(r"up_(\d+)_upsample", seg):
        return f"up_blocks.{m[1]}.upsamplers.0.conv"
    return _SEGMENTS.get(seg, seg)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple[str, ...], value) -> tuple[str, torch.Tensor]:
    arr = np.asarray(value, np.float32)
    *mods, leaf = path
    if leaf == "position_embedding":
        mods, leaf = mods + ["text_model.embeddings.position_embedding"], "weight"
    elif leaf == "kernel":
        arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
    name = ".".join([_segment(m) for m in mods] + [_LEAVES.get(leaf, leaf)])
    return name, torch.tensor(arr)


def state_dict_from_tree(tree) -> dict[str, torch.Tensor]:
    return dict(_leaf(path, v) for path, v in _flatten(tree))


def from_jax_params(params: dict, config: SDConfig) -> dict:
    """The JAX bundle's params -> {"unet", "text", "vae", "position_net"}
    state dicts for `runtime.models.build_bundle`."""
    vae = {"decoder": params["vae"]["decoder"],
           "post_quant_conv": params["vae"]["post_quant_conv"]}
    out = {"unet": state_dict_from_tree(params["unet"]),
           "text": state_dict_from_tree(params["text"]),
           "vae": state_dict_from_tree(vae)}
    if config.unet.use_gligen:
        out["position_net"] = state_dict_from_tree(params["position_net"])
    return out
