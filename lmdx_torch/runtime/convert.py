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

Checkpoint directories (diffusers / transformers layout, `<dir>/unet`,
`<dir>/text_encoder`, `<dir>/vae`; SAM in one directory):
`load_checkpoint(config, dir)` reads them into state dicts named as the
port's modules name their parameters, in the file's dtype and still on the
host (a safetensors file is mapped, not copied: `safetensors_io`);
`load_sam_state_dict(dir)` does the same for SAM; `validate_checkpoint`
diffs a directory against the manifests in `manifests/` (key names and
shapes of the published checkpoints), with the JAX side's report.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from ..config import SDConfig
from . import safetensors_io

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


# ---- checkpoint directories -------------------------------------------------

# Weight file names a component directory may hold, in the order probed.
_WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "model.safetensors",
                "diffusion_pytorch_model.bin", "pytorch_model.bin",
                "pytorch_model.safetensors")


def _load_state_dict(component_dir: str) -> dict[str, torch.Tensor]:
    """The first weight file of _WEIGHT_FILES in `component_dir`, as host
    tensors in the file's dtype (mapped, not read, where the format allows)."""
    for name in _WEIGHT_FILES:
        path = os.path.join(component_dir, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".safetensors"):
            return safetensors_io.read(path)
        return torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    raise FileNotFoundError(f"no weight file in {component_dir}")


MANIFEST_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "manifests")

# checkpoint component -> manifest file, per SD model key.
_COMPONENT_MANIFESTS = {
    "runwayml/stable-diffusion-v1-5": {
        "unet": "unet_sd15", "text_encoder": "text_encoder_clip_vit_l",
        "vae": "vae_sd"},
    "gligen/diffusers-generation-text-box": {
        "unet": "unet_gligen", "text_encoder": "text_encoder_clip_vit_l",
        "vae": "vae_sd"},
}
SAM_MANIFEST = "sam_vit_base"

# Keys that may differ from the manifest: buffers some transformers versions
# persist, and the VAE attention's two naming eras (the manifest holds the
# legacy names, the port's modules the modern ones).
_IGNORABLE_SUBSTRINGS = ("position_ids",)
_VAE_ERA_RENAMES = {"to_q": "query", "to_k": "key", "to_v": "value",
                    "to_out.0": "proj_attn"}
_VAE_LEGACY = re.compile(r"(.*\.attentions\.0\.)(query|key|value|proj_attn)(\.\w+)")
# SamModel parameters no path of the port reads (the JAX side's convert_sam
# skips them too): the mask-prompt encoder and the top-level copy of the
# prompt encoder's shared positional embedding.
SAM_UNUSED_PREFIXES = ("prompt_encoder.mask_embed.", "shared_image_embedding.")


def load_manifest(name: str) -> dict[str, list[int]]:
    with open(os.path.join(MANIFEST_DIR, f"{name}.json")) as f:
        return json.load(f)


def _ignorable(key: str) -> bool:
    return any(s in key for s in _IGNORABLE_SUBSTRINGS)


def validate_checkpoint(model_key: str, checkpoint_dir: str) -> dict:
    """Diff a checkpoint directory against the manifests.

    Returns {component: {"missing": [...], "extra": [...], "shape": [...]}}
    with empty lists on a clean match. The VAE check accepts both attention
    naming eras and legacy (C, C, 1, 1) attention weights."""
    manifests = _COMPONENT_MANIFESTS.get(model_key)
    if manifests is None:
        raise KeyError(f"no manifests for model key {model_key!r}; known: "
                       f"{sorted(_COMPONENT_MANIFESTS)}")
    report = {}
    for component, manifest_name in manifests.items():
        manifest = load_manifest(manifest_name)
        actual = {}
        for k, v in _load_state_dict(os.path.join(checkpoint_dir, component)).items():
            if _ignorable(k):
                continue
            shape = list(v.shape)
            if component == "vae":
                for new, old in _VAE_ERA_RENAMES.items():
                    marker = f".attentions.0.{new}."
                    if marker in k:
                        k = k.replace(marker, f".attentions.0.{old}.")
                        break
                if ".attentions.0." in k and len(shape) == 4:
                    shape = [shape[0], shape[1] * shape[2] * shape[3]]
            actual[k] = shape
        want = {k: v for k, v in manifest.items() if not _ignorable(k)}
        report[component] = {
            "missing": sorted(set(want) - set(actual)),
            "extra": sorted(set(actual) - set(want)),
            "shape": sorted(k for k in set(want) & set(actual) if want[k] != actual[k]),
        }
    return report


def _modern_vae(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Legacy VAE attention names to the modern ones, (C, C, 1, 1) weights
    to (C, C)."""
    modern = {old: new for new, old in _VAE_ERA_RENAMES.items()}
    out = {}
    for k, v in sd.items():
        if m := _VAE_LEGACY.fullmatch(k):
            k = m[1] + modern[m[2]] + m[3]
        if ".attentions.0." in k and v.dim() == 4:
            v = v.reshape(v.shape[0], -1)
        out[k] = v
    return out


def load_checkpoint(config: SDConfig, checkpoint_dir: str) -> dict:
    """A diffusers checkpoint directory -> {"unet", "text", "vae"[,
    "position_net"]} state dicts for `runtime.models.build_bundle`, named as
    the port's modules name their parameters: `*.position_ids` dropped, the
    VAE attention in the modern names, GLIGEN's `position_net.*` split off
    the UNet's file. Tensors stay on the host in the file's dtype; the
    strict load into the modules refuses anything else missing or extra."""
    def load(component):
        sd = _load_state_dict(os.path.join(checkpoint_dir, component))
        return {k: v for k, v in sd.items() if not _ignorable(k)}

    unet = load("unet")
    out = {"unet": unet, "text": load(config.text_encoder_dir),
           "vae": _modern_vae(load("vae"))}
    if config.unet.use_gligen:
        prefix = "position_net."
        out["position_net"] = {k[len(prefix):]: v for k, v in unet.items()
                               if k.startswith(prefix)}
        if not out["position_net"]:
            raise ValueError(f"{checkpoint_dir} has no GLIGEN position_net weights but "
                             f"config.unet.use_gligen is set")
        out["unet"] = {k: v for k, v in unet.items() if not k.startswith(prefix)}
    return out


def load_sam_state_dict(component_dir: str) -> dict[str, torch.Tensor]:
    """A transformers `SamModel` checkpoint directory -> the state dict of the
    port's `Sam` (SAM_UNUSED_PREFIXES dropped), on the host in the file's
    dtype."""
    return {k: v for k, v in _load_state_dict(component_dir).items()
            if not k.startswith(SAM_UNUSED_PREFIXES)}
