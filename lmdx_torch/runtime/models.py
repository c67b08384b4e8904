"""Model bundle: modules + tokenizer for one SD configuration (port of the JAX
package's runtime/models.py).

`load_bundle` builds a bundle with deterministic random weights drawn from a
seeded `torch.Generator` (weightless mode: timing, smoke runs); `build_bundle`
takes converted state dicts (`runtime/convert.py::from_jax_params`), which
is how the tests run both packages on the same weights. Entry points run on
`cuda` unless the caller passes `device="cpu"`; without a card and without
that request they raise.

Storage follows the JAX side's inference cast: weights in the compute dtype,
every parameter whose name contains "norm" in f32.

`build_sam` builds the SAM segmenter's network the same way (random weights
from a seed, or a state dict with transformers `SamModel` key names).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from ..config import SD_CONFIGS, KernelOptions, SDConfig
from ..nn.clip import CLIPTextEncoder
from ..nn.sam import Sam, SamConfig, sam_vit_base
from ..nn.unet import PositionNet, UNet2DCondition
from ..nn.vae import ENCODE_HALF, AutoencoderKL
from ..text import tokens as toklib

F32_PARAM_NAME_MARKERS = ("norm",)


@dataclass
class ModelBundle:
    config: SDConfig
    tokenizer: Any
    unet: UNet2DCondition
    text_encoder: CLIPTextEncoder
    vae: AutoencoderKL
    position_net: PositionNet | None
    device: torch.device


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    return torch.device(device)


def _random_init(named_parameters, generator: torch.Generator) -> None:
    """Flax-default-like init of (name, parameter) pairs, in their order:
    weights ~ N(0, 1/fan_in), biases and GLIGEN gates 0, norm scales 1,
    position embeddings N(0, 0.01^2)."""
    for name, p in named_parameters:
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if any(m in name for m in F32_PARAM_NAME_MARKERS):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or p.dim() < 2:
                p.zero_()
            elif "position_embedding" in name:
                p.normal_(0.0, 0.01, generator=generator)
            elif "token_embedding" in name:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)


def cast_for_inference(module: nn.Module, dtype: torch.dtype) -> None:
    """Weights to the compute dtype; "norm" parameters stay f32."""
    for name, p in module.named_parameters():
        if not any(m in name for m in F32_PARAM_NAME_MARKERS):
            p.data = p.data.to(dtype)


def build_bundle(config: SDConfig, state_dicts: dict | None = None, seed: int = 0,
                 device=None, kernels: KernelOptions | None = None) -> ModelBundle:
    """Bundle from converted state dicts ({"unet", "text", "vae",
    "position_net"}) or, when None, from seeded random weights. `kernels`
    chooses the UNet's opt-in kernels (None: all off, the default path); the
    weights and their names are the same under every choice."""
    device = resolve_device(device)
    dtype = config.torch_dtype()
    with torch.device(device):
        unet = UNet2DCondition(config.unet, dtype=dtype,
                               kernels=kernels or KernelOptions())
        text = CLIPTextEncoder(config.clip, dtype=dtype)
        vae = AutoencoderKL(config.vae)
        pn = (PositionNet(config.clip.hidden_size, config.unet.cross_attention_dim,
                          config.unet.gligen_fourier_freqs)
              if config.unet.use_gligen else None)
    parts = {"unet": unet, "text": text, "vae": vae, "position_net": pn}
    if state_dicts is None:
        # The VAE's encode half draws last, after PositionNet, so that every
        # other weight is what the same seed drew before the encoder existed.
        vae_params = list(vae.named_parameters())
        encode_half = [(n, p) for n, p in vae_params if n.startswith(ENCODE_HALF)]
        order = [unet.named_parameters(), text.named_parameters(),
                 [(n, p) for n, p in vae_params if not n.startswith(ENCODE_HALF)],
                 pn.named_parameters() if pn is not None else [], encode_half]
        generator = torch.Generator(device=device).manual_seed(seed)
        for named in order:
            _random_init(named, generator)
    for key, module in parts.items():
        if module is None:
            continue
        if state_dicts is not None:
            module.load_state_dict(state_dicts[key], strict=True)
        cast_for_inference(module, dtype)
        module.eval().requires_grad_(False)
    return ModelBundle(config=config, tokenizer=toklib.default_tokenizer(),
                       unet=unet, text_encoder=text, vae=vae, position_net=pn,
                       device=device)


def load_bundle(model_key: str = "gligen/diffusers-generation-text-box",
                seed: int = 0, device=None,
                kernels: KernelOptions | None = None) -> ModelBundle:
    """Weightless bundle for `model_key` (random weights from `seed`)."""
    return build_bundle(SD_CONFIGS[model_key](), None, seed=seed, device=device,
                        kernels=kernels)


# SAM parameters kept in f32 whatever the compute dtype, as the JAX segmenter
# computes: norms, the rel-pos tables (f32 bias), the prompt encoder's tables
# and Gaussian, and the decoder's output tokens.
SAM_F32_MARKERS = ("norm", "rel_pos", "prompt_encoder.", "iou_token", "mask_tokens")


_SAM_TABLES = ("prompt_encoder.point_embed", "prompt_encoder.not_a_point_embed",
               "prompt_encoder.no_mask_embed")
_SAM_GAUSSIAN = ("prompt_encoder.shared_embedding", "mask_decoder.iou_token",
                 "mask_decoder.mask_tokens")


def _random_init_sam(model: Sam, generator: torch.Generator) -> None:
    """Weights ~ N(0, 1/fan_in), biases 0, norm scales 1; the tokens and
    the Fourier Gaussian ~ N(0, 1) and the point tables ~ N(0, 1/dim), as
    flax initializes them; rel-pos tables ~ N(0, 1/head_dim), not the JAX
    side's zeros, so that the bias carries real numbers; position
    embeddings N(0, 0.02^2)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if "norm" in name:
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif "rel_pos" in name or name.startswith(_SAM_TABLES):
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
            elif name.startswith(_SAM_GAUSSIAN):
                p.normal_(0.0, 1.0, generator=generator)
            elif leaf == "pos_embed":
                p.normal_(0.0, 0.02, generator=generator)
            elif "upscale_conv" in name:  # (in, out, kh, kw): fan_in = in
                p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)


def build_sam(config: SamConfig | None = None, state_dict: dict | None = None,
              seed: int = 0, device=None, dtype: torch.dtype = torch.bfloat16) -> Sam:
    """SAM (ViT-B unless `config` says otherwise) from a state dict with
    transformers `SamModel` key names or, when None, seeded random weights.
    Linear/Conv weights are stored in `dtype`, SAM_F32_MARKERS in f32."""
    device = resolve_device(device)
    config = config or sam_vit_base()
    with torch.device(device):
        model = Sam(config, dtype)
    if state_dict is None:
        _random_init_sam(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    for name, p in model.named_parameters():
        if not any(m in name for m in SAM_F32_MARKERS):
            p.data = p.data.to(dtype)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def encode_text(bundle: ModelBundle, texts: list[str]):
    """Raw texts -> (hidden (N, 77, D) f32, pooled (N, D) f32) on the device."""
    ids = np.asarray(
        [bundle.tokenizer.encode(t, pad_to=toklib.MAX_LENGTH) for t in texts], np.int64)
    # Reduced-vocab test configs only: fold ids into the model's vocab.
    vocab = bundle.config.clip.vocab_size
    eos_id = bundle.tokenizer.eos_id
    if vocab < toklib.BOS_ID:
        ids = ids % vocab
        eos_id = eos_id % vocab
    hidden, pooled = bundle.text_encoder(
        torch.from_numpy(ids).to(bundle.device), eos_token_id=eos_id)
    return hidden.float(), pooled.float()


def encode_prompts(bundle: ModelBundle, prompts: list[str], negative_prompt: str = "",
                   one_uncond_input_only: bool = False):
    """(uncond, cond) embeddings for CFG sampling: uncond is the embedding of
    `negative_prompt`, repeated once per prompt unless one_uncond_input_only."""
    cond, _ = encode_text(bundle, prompts)
    uncond, _ = encode_text(bundle, [negative_prompt])
    if not one_uncond_input_only:
        uncond = uncond.repeat(len(prompts), 1, 1)
    return uncond, cond


@torch.no_grad()
def gligen_objs(bundle: ModelBundle, boxes, masks, phrase_embeddings):
    """PositionNet forward: packed GLIGEN condition -> grounding tokens."""
    if bundle.position_net is None:
        raise ValueError("model has no GLIGEN adapters")

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=bundle.device)

    return bundle.position_net(dev(boxes), dev(masks), dev(phrase_embeddings))
