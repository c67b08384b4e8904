"""Model bundle: modules + tokenizer for one SD configuration (port of the JAX
package's runtime/models.py).

`load_bundle` reads a diffusers checkpoint directory (`checkpoint_dir`, else
`$LMDX_CHECKPOINT_DIR/<model--key>` when that exists) or, without one,
draws deterministic random weights from a seeded `torch.Generator`
(weightless mode: timing, smoke runs); `build_bundle` takes state dicts
(`runtime/convert.py::load_checkpoint`, or `from_jax_params`, which is how
the tests run both packages on the same weights). Entry points run on
`cuda` unless the caller passes `device="cpu"`; without a card and without
that request they raise.

Storage follows the JAX side's inference cast: weights in the compute dtype,
every parameter whose name contains "norm" in f32. Weights from a state dict
go into modules built on the `meta` device, one tensor at a time: placed on
the device, cast there, assigned; nothing is allocated twice.

`build_train_unet` builds the UNet alone with float32 parameters, for the
training step (`training/train.py`).

`build_sam` builds the SAM segmenter's network the same way (random weights
from a seed, or a state dict with transformers `SamModel` key names);
`load_segmenter` reads it from a checkpoint directory. `build_owlvit` does
the same for the stage-2 eval's OWL-ViT detector, in float32.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from ..config import SD_CONFIGS, KernelOptions, SDConfig
from ..nn.clip import CLIPTextEncoder
from ..nn.owlvit import OwlViT, OwlViTConfig, box_bias, owlvit_base_patch32
from ..nn.sam import Sam, SamConfig, SamSegmenter, sam_vit_base
from ..nn.unet import PositionNet, UNet2DCondition
from ..nn.vae import ENCODE_HALF, AutoencoderKL
from ..text import tokens as toklib
from ..utils import trace
from . import convert
from .precision import set_full_f32

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
    # The checkpoint directory the weights came from; None = random weights.
    checkpoint_dir: str | None = None
    # The SDXL base's second tower (bigG): `encode_text` concats both towers'
    # hidden states and takes the pooled vector from this one.
    text_encoder_2: CLIPTextEncoder | None = None


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


def _assign(module: nn.Module, state_dict: dict, device: torch.device, dtype_of) -> None:
    """Loads `state_dict` into `module`, built on the `meta` device: every name
    and shape must match (checked before anything moves); then each tensor
    is placed on `device` and cast to `dtype_of(name)` on its own (on a card:
    the file's bytes go up, the cast runs there) and assigned."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    missing, extra = sorted(want.keys() - have.keys()), sorted(have.keys() - want.keys())
    shape = sorted(k for k in want.keys() & have.keys() if want[k] != have[k])
    if missing or extra or shape:
        raise KeyError(f"{type(module).__name__}: state dict does not match: missing "
                       f"{missing[:8]}, unexpected {extra[:8]}, shape {shape[:8]} "
                       f"({len(missing)}, {len(extra)}, {len(shape)} in all)")
    placed = {}
    for name, t in state_dict.items():
        dtype = dtype_of(name)
        if device.type == "cpu":
            placed[name] = t.to(dtype=dtype, copy=True,
                                memory_format=torch.contiguous_format)
        else:
            placed[name] = t.to(device).to(dtype).contiguous()
    module.load_state_dict(placed, strict=True, assign=True)


def build_text_encoder_2(config: SDConfig) -> CLIPTextEncoder | None:
    """The second tower of `config` (the SDXL base's bigG), or None."""
    if config.clip2 is None:
        return None
    return CLIPTextEncoder(config.clip2, dtype=config.torch_dtype())


def build_modules(config: SDConfig, kernels: KernelOptions | None = None) -> dict:
    """{"unet", "text", "vae", "position_net" (None without GLIGEN), "text2"
    (None with one tower)} of `config`, on the current default device (`with
    torch.device("meta")`: shapes and names only, nothing allocated)."""
    dtype = config.torch_dtype()
    return {"unet": UNet2DCondition(config.unet, dtype=dtype,
                                    kernels=kernels or KernelOptions()),
            "text": CLIPTextEncoder(config.clip, dtype=dtype),
            "vae": AutoencoderKL(config.vae),
            "position_net": (PositionNet(config.clip.hidden_size,
                                         config.unet.cross_attention_dim,
                                         config.unet.gligen_fourier_freqs)
                             if config.unet.use_gligen else None),
            "text2": build_text_encoder_2(config)}


def build_bundle(config: SDConfig, state_dicts: dict | None = None, seed: int = 0,
                 device=None, kernels: KernelOptions | None = None, *,
                 tokenizer=None, checkpoint_dir: str | None = None) -> ModelBundle:
    """Bundle from state dicts ({"unet", "text", "vae"[, "position_net"][,
    "text2"]}, any dtype, on the host) or, when None, from seeded random
    weights.
    `kernels` chooses the UNet's opt-in kernels (None: all off, the default
    path); the weights and their names are the same under every choice.
    `tokenizer` defaults to `text.tokens.default_tokenizer()`."""
    device = resolve_device(device)
    dtype = config.torch_dtype()
    with torch.device(device if state_dicts is None else "meta"):
        parts = build_modules(config, kernels)
    unet, text, vae, pn, text2 = (parts[k] for k in ("unet", "text", "vae", "position_net",
                                                     "text2"))
    if state_dicts is None:
        # The VAE's encode half draws after PositionNet and the second tower
        # last, so that every other weight is what the same seed drew before
        # the encoder and the second tower existed.
        vae_params = list(vae.named_parameters())
        encode_half = [(n, p) for n, p in vae_params if n.startswith(ENCODE_HALF)]
        order = [unet.named_parameters(), text.named_parameters(),
                 [(n, p) for n, p in vae_params if not n.startswith(ENCODE_HALF)],
                 pn.named_parameters() if pn is not None else [], encode_half,
                 text2.named_parameters() if text2 is not None else []]
        generator = torch.Generator(device=device).manual_seed(seed)
        for named in order:
            _random_init(named, generator)

    def dtype_of(name):
        return torch.float32 if any(m in name for m in F32_PARAM_NAME_MARKERS) else dtype

    for key, module in parts.items():
        if module is None:
            continue
        if state_dicts is None:
            cast_for_inference(module, dtype)
        else:
            _assign(module, state_dicts[key], device, dtype_of)
        module.eval().requires_grad_(False)
    return ModelBundle(config=config, tokenizer=tokenizer or toklib.default_tokenizer(),
                       unet=unet, text_encoder=text, vae=vae, position_net=pn,
                       device=device, checkpoint_dir=checkpoint_dir, text_encoder_2=text2)


def build_train_unet(config: SDConfig, state_dict: dict | None = None, seed: int = 0,
                     device=None) -> UNet2DCondition:
    """The UNet of `config` for training (`training/train.py`): built for the
    config's compute dtype (its `compute_dtype`, which the train step
    reads), every parameter kept in float32 (the masters; no
    `cast_for_inference`), in train mode with gradients on. From a state dict
    (any dtype, on the host) or, when None, seeded random weights drawn as
    `build_bundle` draws them: the UNet comes first in its order, so the same
    seed gives the bundle's UNet before the cast."""
    device = resolve_device(device)
    with torch.device(device if state_dict is None else "meta"):
        unet = UNet2DCondition(config.unet, dtype=config.torch_dtype())
    if state_dict is None:
        _random_init(unet.named_parameters(), torch.Generator(device=device).manual_seed(seed))
    else:
        _assign(unet, state_dict, device, lambda name: torch.float32)
    return unet.train().requires_grad_(True)


def load_bundle(model_key: str = "gligen/diffusers-generation-text-box",
                checkpoint_dir: str | None = None, seed: int = 0, dtype: str | None = None,
                *, device=None, kernels: KernelOptions | None = None) -> ModelBundle:
    """Bundle for `model_key`, the JAX side's `load_bundle` on the port.

    checkpoint_dir: a diffusers checkpoint directory (`unet/`, `vae/`,
    `text_encoder/` or the config's `text_encoder_dir`, the SDXL refiner's
    `text_encoder_2/`; the SDXL base has both; optionally `tokenizer/`, the
    only tokenizer directory read, as on the JAX side: both of the SDXL
    base's towers take it); when None,
    `$LMDX_CHECKPOINT_DIR/<model_key with / as -->` if that directory exists,
    else random weights from `seed`. The tokenizer is the CLIP BPE of
    `<checkpoint>/tokenizer/vocab.json` when there is one; a checkpoint of a
    real-vocabulary model without it is refused before any weight is read
    (the hash-based WordTokenizer would scramble every prompt), unless
    LMDX_ALLOW_WORD_TOKENIZER is set.
    dtype: compute-dtype override ("bfloat16", "float32"): "float32" is the
    reference's no-autocast precision, the one published for training-free
    LMD. On a card every attention kernel, the opt-in ones included, exists
    for bfloat16 and float32; any other dtype there is refused here, before
    the load, not in the middle of a run. A float32 bundle turns TF32 off
    (`precision.set_full_f32`), as the JAX package's float32 function has
    none."""
    config = SD_CONFIGS[model_key]()
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    device = resolve_device(device)
    if config.torch_dtype() == torch.float32:
        set_full_f32()
    if device.type == "cuda":
        torch_dtype = config.torch_dtype()
        if torch_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(
                f"dtype {config.dtype} on {device}: the port's CUDA attention kernels "
                f"take bfloat16 or float32; run {config.dtype} with device='cpu'")
    if checkpoint_dir is None:
        root = os.environ.get("LMDX_CHECKPOINT_DIR", "")
        candidate = os.path.join(root, model_key.replace("/", "--")) if root else ""
        if candidate and os.path.isdir(candidate):
            checkpoint_dir = candidate
    if checkpoint_dir is None:
        return build_bundle(config, None, seed=seed, device=device, kernels=kernels)

    tokenizer = toklib.default_tokenizer()
    tok_dir = os.path.join(checkpoint_dir, "tokenizer")
    if os.path.exists(os.path.join(tok_dir, "vocab.json")):
        tokenizer = toklib.ClipBpeTokenizer.from_dir(tok_dir)
    elif (config.clip.vocab_size >= toklib.BOS_ID
          and not os.environ.get("LMDX_ALLOW_WORD_TOKENIZER")):
        raise ValueError(
            f"checkpoint {checkpoint_dir!r} has no tokenizer/vocab.json; "
            "refusing to pair converted real-vocab weights with the "
            "hash-based WordTokenizer. Copy the CLIP tokenizer files "
            "(vocab.json + merges.txt) into <checkpoint>/tokenizer/, or "
            "set LMDX_ALLOW_WORD_TOKENIZER=1 to override for debugging.")
    return build_bundle(config, convert.load_checkpoint(config, checkpoint_dir),
                        device=device, kernels=kernels, tokenizer=tokenizer,
                        checkpoint_dir=checkpoint_dir)


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

    def dtype_of(name):
        return torch.float32 if any(m in name for m in SAM_F32_MARKERS) else dtype

    with torch.device(device if state_dict is None else "meta"):
        model = Sam(config, dtype)
    if state_dict is None:
        _random_init_sam(model, torch.Generator(device=device).manual_seed(seed))
        for name, p in model.named_parameters():
            p.data = p.data.to(dtype_of(name))
    else:
        _assign(model, state_dict, device, dtype_of)
    return model.eval().requires_grad_(False)


def discover_sam_checkpoint() -> str | None:
    """`$LMDX_CHECKPOINT_DIR/facebook--sam-vit-base` when that directory
    exists (the JAX CLI wires SAM from there without a flag)."""
    root = os.environ.get("LMDX_CHECKPOINT_DIR", "")
    candidate = os.path.join(root, "facebook--sam-vit-base") if root else ""
    return candidate if candidate and os.path.isdir(candidate) else None


def load_segmenter(sam_checkpoint: str, device=None) -> SamSegmenter:
    """The SAM ViT-B segmenter on the weights of a transformers `SamModel`
    checkpoint directory."""
    return SamSegmenter(build_sam(state_dict=convert.load_sam_state_dict(sam_checkpoint),
                                  device=device))


def build_owlvit(config: OwlViTConfig | None = None, state_dict: dict | None = None,
                 seed: int = 0, device=None) -> OwlViT:
    """OWL-ViT (base-patch32 unless `config` says otherwise) in float32, from
    a state dict with transformers `OwlViTForObjectDetection` key names
    (`convert.load_owlvit_state_dict`) or, when None, seeded random weights
    drawn from an explicit generator: weights ~ N(0, 1/fan_in), biases 0,
    norm scales 1, the class, position and token embeddings N(0, 0.02^2).
    Being float32, it turns TF32 off (`precision.set_full_f32`): its patch
    embedding is a convolution."""
    device = resolve_device(device)
    set_full_f32()
    config = config or owlvit_base_patch32()
    with torch.device(device if state_dict is None else "meta"):
        model = OwlViT(config)
    if state_dict is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            with torch.no_grad():
                if "norm" in name:
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf == "bias":
                    p.zero_()
                elif "embedding" in name and "patch" not in name:
                    p.normal_(0.0, 0.02, generator=generator)
                else:
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    else:
        _assign(model, state_dict, device, lambda name: torch.float32)
        model.box_bias = torch.from_numpy(box_bias(config.grid)).to(device)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def encode_text(bundle: ModelBundle, texts: list[str]):
    """Raw texts -> (hidden (N, 77, D) f32, pooled (N, Dp) f32) on the device,
    as the config's tower gives them: the last hidden state and the pooled
    EOS embedding (SD1.x, SD2.1's ViT-H), or the penultimate hidden state and
    the projected pooled embedding (the SDXL refiner's bigG). Two towers (the
    SDXL base): hidden is the feature concat of both towers' states (768 |
    1280 = 2048), pooled the second tower's; both take the same ids. (The
    JAX side pads the batch to a power of two with EOS rows and slices them
    off; each row is independent, so the port pads nothing.)"""
    with trace.annotate("text"):
        ids = np.asarray(
            [bundle.tokenizer.encode(t, pad_to=toklib.MAX_LENGTH) for t in texts], np.int64)
        # Reduced-vocab test configs only: fold ids into the model's vocab.
        vocab = bundle.config.clip.vocab_size
        eos_id = bundle.tokenizer.eos_id
        if vocab < toklib.BOS_ID:
            ids = ids % vocab
            eos_id = eos_id % vocab
        ids = trace.to_device(ids, bundle.device, "text_to_device")
        hidden, pooled = bundle.text_encoder(ids, eos_token_id=eos_id)
        if bundle.text_encoder_2 is not None:
            hidden2, pooled = bundle.text_encoder_2(ids, eos_token_id=eos_id)
            hidden = torch.cat([hidden, hidden2], dim=-1)
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
        return trace.to_device(np.asarray(x, np.float32), bundle.device, "gligen_to_device")

    with trace.annotate("gligen"):
        return bundle.position_net(dev(boxes), dev(masks), dev(phrase_embeddings))
