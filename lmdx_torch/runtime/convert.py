"""JAX parameter trees -> the port's state dicts (diffusers / transformers key
names), so that both packages can run the same weights.

`from_jax_params(params, config)` takes the JAX bundle's parameter tree with
numpy leaves ({"unet", "text", "vae", "position_net"}) and returns
{"unet", "text", "vae", "position_net"} state dicts of f32 tensors:

- Dense kernel (in, out)   -> Linear weight (out, in)
- Conv kernel HWIO         -> Conv2d weight OIHW
- norm `scale`             -> `weight`; Embed `embedding` -> `weight`
- GLIGEN `alpha_attn` / `alpha_dense` and PositionNet null features as they are

The VAE is converted whole: encoder, quant_conv, decoder, post_quant_conv.

`sam_from_jax_params(tree)` takes the JAX package's SAM parameter tree and
returns the state dict with transformers `SamModel` key names that the JAX
side's `convert_sam` maps onto that tree: its exact inverse.
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
    if m := re.fullmatch(r"down_(\d+)_resnets_(\d+)", seg):
        return f"down_blocks.{m[1]}.resnets.{m[2]}"
    if m := re.fullmatch(r"down_(\d+)_downsample", seg):
        return f"down_blocks.{m[1]}.downsamplers.0.conv"
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
    vae = {k: params["vae"][k]
           for k in ("encoder", "quant_conv", "decoder", "post_quant_conv")}
    out = {"unet": state_dict_from_tree(params["unet"]),
           "text": state_dict_from_tree(params["text"]),
           "vae": state_dict_from_tree(vae)}
    if config.unet.use_gligen:
        out["position_net"] = state_dict_from_tree(params["position_net"])
    return out


def sam_from_jax_params(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX package's SAM params ({"image_encoder", "prompt_encoder",
    "mask_decoder"}) -> a state dict of f32 tensors for `runtime.models.
    build_sam`. Layouts: Dense (in, out) -> Linear (out, in); Conv HWIO ->
    OIHW; the decoder's ConvTranspose (kh, kw, in, out) -> (in, out, kh, kw),
    the inverse of `convert_sam`'s transpose(2, 3, 0, 1) (not HWIO -> OIHW)."""
    sd = {}

    def put(name, arr):
        sd[name] = torch.tensor(np.asarray(arr, np.float32))

    def lin(prefix, t):
        put(f"{prefix}.weight", np.asarray(t["kernel"]).T)
        if "bias" in t:
            put(f"{prefix}.bias", t["bias"])

    def norm(prefix, t):
        put(f"{prefix}.weight", t["scale"])
        put(f"{prefix}.bias", t["bias"])

    def conv(prefix, t):
        put(f"{prefix}.weight", np.asarray(t["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in t:
            put(f"{prefix}.bias", t["bias"])

    def ffn3(prefix, t):  # transformers SamFeedForward
        for j, name in enumerate(("proj_in", "layers.0", "proj_out")):
            lin(f"{prefix}.{name}", t[f"layers_{j}"])

    def dec_attn(prefix, t):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{prefix}.{name}", t[name])

    enc, ve = tree["image_encoder"], "vision_encoder"
    conv(f"{ve}.patch_embed.projection", enc["patch_embed"])
    put(f"{ve}.pos_embed", enc["pos_embed"])
    conv(f"{ve}.neck.conv1", enc["neck_conv1"])
    norm(f"{ve}.neck.layer_norm1", enc["neck_ln1"])
    conv(f"{ve}.neck.conv2", enc["neck_conv2"])
    norm(f"{ve}.neck.layer_norm2", enc["neck_ln2"])
    for name, block in enc.items():
        if not name.startswith("layers_"):
            continue
        p = f"{ve}.layers.{name.split('_')[-1]}"
        norm(f"{p}.layer_norm1", block["layer_norm1"])
        norm(f"{p}.layer_norm2", block["layer_norm2"])
        lin(f"{p}.attn.qkv", block["attn"]["qkv"])
        lin(f"{p}.attn.proj", block["attn"]["proj"])
        put(f"{p}.attn.rel_pos_h", block["attn"]["rel_pos_h"])
        put(f"{p}.attn.rel_pos_w", block["attn"]["rel_pos_w"])
        lin(f"{p}.mlp.lin1", block["lin1"])
        lin(f"{p}.mlp.lin2", block["lin2"])

    pr, pe = tree["prompt_encoder"], "prompt_encoder"
    put(f"{pe}.shared_embedding.positional_embedding", pr["positional_embedding"])
    put(f"{pe}.not_a_point_embed.weight", pr["not_a_point_embed"]["embedding"])
    put(f"{pe}.no_mask_embed.weight", pr["no_mask_embed"]["embedding"])
    for i in range(4):
        put(f"{pe}.point_embed.{i}.weight", pr[f"point_embed_{i}"]["embedding"])

    dec, md = tree["mask_decoder"], "mask_decoder"
    put(f"{md}.iou_token.weight", dec["iou_token"])
    put(f"{md}.mask_tokens.weight", dec["mask_tokens"])
    norm(f"{md}.transformer.layer_norm_final_attn", dec["layer_norm_final"])
    dec_attn(f"{md}.transformer.final_attn_token_to_image", dec["final_attn_token_to_image"])
    for i in (1, 2):
        t = dec[f"upscale_conv{i}"]
        put(f"{md}.upscale_conv{i}.weight", np.asarray(t["kernel"]).transpose(2, 3, 0, 1))
        put(f"{md}.upscale_conv{i}.bias", t["bias"])
    norm(f"{md}.upscale_layer_norm", dec["upscale_ln"])
    ffn3(f"{md}.iou_prediction_head", dec["iou_prediction_head"])
    for name, block in dec.items():
        i = name.split("_")[-1]
        if name.startswith("hypernet_"):
            ffn3(f"{md}.output_hypernetworks_mlps.{i}", block)
        elif name.startswith("layers_"):
            p = f"{md}.transformer.layers.{i}"
            for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
                dec_attn(f"{p}.{attn}", block[attn])
            for k in range(1, 5):
                norm(f"{p}.layer_norm{k}", block[f"layer_norm{k}"])
            lin(f"{p}.mlp.lin1", block["mlp_lin1"])
            lin(f"{p}.mlp.lin2", block["mlp_lin2"])
    return sd
