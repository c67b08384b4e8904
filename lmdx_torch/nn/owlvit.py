"""OWL-ViT open-vocabulary detector, the stage-2 evaluation model (port of
the JAX package's nn/owlvit.py).

google/owlvit-base-patch32 as the reference's eval uses it: a CLIP ViT-B/32
vision tower whose patch tokens become detection queries, a CLIP text tower
whose pooled EOS embeddings become class queries, a box-regression MLP with
a grid-position bias, and a scaled similarity class head. The towers reuse
the port's `CLIPLayer` and `CLIPTextEncoder` (nn/clip.py).

Parameter names are transformers' `OwlViTForObjectDetection` names
(`owlvit.vision_model.*`, `owlvit.text_model.*`, `owlvit.text_projection`,
`layer_norm`, `class_head.*`, `box_head.*`), so a checkpoint loads with no
conversion step; the two tensors no path reads (`owlvit.logit_scale`,
`owlvit.visual_projection`) have no module here. The model computes in
float32. The vision tower's and the merge LayerNorms take flax's default
epsilon 1e-6, as the JAX modules do (transformers uses 1e-5 there); the
transformer layers take CLIP's 1e-5.

Public layouts are the JAX side's: pixels (B, S, S, 3) channels last,
boxes (B, N, 4) cxcywh in [0, 1], logits (B, N, Q).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextConfig
from .attention import Conv2d, Embedding, LayerNorm, Linear
from .clip import CLIPLayer, CLIPTextEncoder

# flax.linen.LayerNorm's default epsilon, which the JAX OwlViT modules keep.
_FLAX_LN_EPS = 1e-6


@dataclass(frozen=True)
class OwlViTConfig:
    image_size: int = 768
    patch_size: int = 32
    vision_hidden: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    projection_dim: int = 512
    text: CLIPTextConfig = field(default_factory=lambda: CLIPTextConfig(
        vocab_size=49408, hidden_size=512, intermediate_size=2048,
        num_layers=12, num_heads=8, max_length=16))

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def owlvit_base_patch32() -> OwlViTConfig:
    return OwlViTConfig()


def tiny_owlvit() -> OwlViTConfig:
    return OwlViTConfig(
        image_size=64, patch_size=16, vision_hidden=32, vision_layers=2,
        vision_heads=2, vision_mlp=64, projection_dim=16,
        text=CLIPTextConfig(vocab_size=1024, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2,
                            max_length=16),
    )


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: OwlViTConfig):
        super().__init__()
        d = cfg.vision_hidden
        self.patch_embedding = Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = Embedding(cfg.grid ** 2 + 1, d)


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: OwlViTConfig):
        super().__init__()
        text_like = CLIPTextConfig(hidden_size=cfg.vision_hidden,
                                   intermediate_size=cfg.vision_mlp,
                                   num_heads=cfg.vision_heads)
        self.layers = nn.ModuleList([CLIPLayer(text_like, torch.float32)
                                     for _ in range(cfg.vision_layers)])


class VisionTower(nn.Module):
    def __init__(self, cfg: OwlViTConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layernorm = LayerNorm(cfg.vision_hidden, _FLAX_LN_EPS, torch.float32)
        self.encoder = _VisionEncoder(cfg)
        self.post_layernorm = LayerNorm(cfg.vision_hidden, _FLAX_LN_EPS, torch.float32)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels (B, H, W, 3) -> patch-token features (B, 1+N, D)."""
        emb = self.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(x.dtype)
        x = self.pre_layernorm(x)
        for layer in self.encoder.layers:  # no mask: every token sees every token
            x = layer(x, 0.0)
        return self.post_layernorm(x)


class BoxHead(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense0, self.dense1 = Linear(hidden, hidden), Linear(hidden, hidden)
        self.dense2 = Linear(hidden, 4)

    def forward(self, x):
        x = F.gelu(self.dense0(x))
        x = F.gelu(self.dense1(x))
        return self.dense2(x)


class ClassHead(nn.Module):
    def __init__(self, hidden: int, projection_dim: int):
        super().__init__()
        self.dense0 = Linear(hidden, projection_dim)
        self.logit_shift = Linear(hidden, 1)
        self.logit_scale = Linear(hidden, 1)

    def forward(self, image_embeds, query_embeds):
        class_embeds = self.dense0(image_embeds)
        class_embeds = class_embeds / (class_embeds.norm(dim=-1, keepdim=True) + 1e-6)
        query = query_embeds / (query_embeds.norm(dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("bnd,bqd->bnq", class_embeds, query)
        shift = self.logit_shift(image_embeds)
        scale = F.elu(self.logit_scale(image_embeds)) + 1
        return (logits + shift) * scale


def box_bias(grid: int) -> np.ndarray:
    """Grid-position bias added to box-head outputs before the sigmoid."""
    coords = (np.stack(np.meshgrid(np.arange(1, grid + 1),
                                   np.arange(1, grid + 1)), -1)
              .astype(np.float32) / grid)
    coords = coords.reshape(-1, 2).clip(0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full((grid * grid, 2), 1.0 / grid, np.float32)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1)


class OwlViTBackbone(CLIPTextEncoder):
    """transformers' `owlvit` submodule: the text tower (`text_model`, this
    class's own forward), the vision tower (`vision_model`) and the text
    projection."""

    def __init__(self, cfg: OwlViTConfig):
        super().__init__(cfg.text, torch.float32)
        self.vision_model = VisionTower(cfg)
        self.text_projection = Linear(cfg.text.hidden_size, cfg.projection_dim, bias=False)


class OwlViT(nn.Module):
    def __init__(self, config: OwlViTConfig):
        super().__init__()
        self.config = config
        self.owlvit = OwlViTBackbone(config)
        self.layer_norm = LayerNorm(config.vision_hidden, _FLAX_LN_EPS, torch.float32)
        self.class_head = ClassHead(config.vision_hidden, config.projection_dim)
        self.box_head = BoxHead(config.vision_hidden)
        self.register_buffer("box_bias", torch.from_numpy(box_bias(config.grid)),
                             persistent=False)

    def image_embedder(self, pixels):
        feats = self.owlvit.vision_model(pixels)
        cls = feats[:, :1]
        patches = feats[:, 1:] * cls          # class-token broadcast merge
        return self.layer_norm(patches)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor):
        """pixels (B, S, S, 3) in CLIP normalization; input_ids (Q, L) for one
        query set shared across the batch, or (B, Q, L) for per-image query
        sets (the batched eval path: each benchmark prompt carries its own
        query texts).

        Returns (pred_boxes (B, N, 4) cxcywh in [0,1], logits (B, N, Q))."""
        image_embeds = self.image_embedder(pixels)
        eos = self.config.text.vocab_size - 1
        if input_ids.dim() == 3:
            b, qn, length = input_ids.shape
            _, pooled = self.owlvit(input_ids.reshape(b * qn, length), eos_token_id=eos)
            query = self.owlvit.text_projection(pooled).reshape(b, qn, -1).float()
        else:
            _, pooled = self.owlvit(input_ids, eos_token_id=eos)
            query = self.owlvit.text_projection(pooled)[None].float()
            query = query.expand(pixels.shape[0], *query.shape[1:])
        logits = self.class_head(image_embeds, query)
        boxes = torch.sigmoid(self.box_head(image_embeds) + self.box_bias)
        return boxes, logits


CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def resize_image(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (size, size, 3), PIL BICUBIC (the protocol's
    resize: transformers OwlViTProcessor)."""
    from PIL import Image as PILImage

    img = PILImage.fromarray(image).convert("RGB").resize(
        (size, size), PILImage.BICUBIC)
    return np.asarray(img, np.uint8)


@functools.lru_cache(maxsize=16)
def pil_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """One-axis PIL BICUBIC resample matrix (out_size, in_size).

    Reproduces Pillow's precompute_coeffs + 8bpc normalization
    (src/libImaging/Resample.c): Keys cubic a=-0.5, support 2 scaled by the
    downscale factor, window [center-support+0.5, center+support+0.5),
    weights normalized then quantized to 22 fixed-point bits. A matmul by
    this matrix followed by round-half-up + clip to [0,255] reproduces one
    PIL uint8 resample pass to <=1 LSB (a sum taken another way than PIL's
    int32 accumulator lands a hair off only when the true value sits exactly
    on a rounding boundary)."""
    a = -0.5
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ss = 1.0 / filterscale
    m = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        t = np.abs((np.arange(xmin, xmax) - center + 0.5) * ss)
        w = np.where(
            t < 1.0, ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0,
            np.where(t < 2.0, a * (((t - 5.0) * t + 8.0) * t - 4.0), 0.0))
        w = w / w.sum()
        m[xx, xmin:xmax] = np.round(w * (1 << 22)) / (1 << 22)
    return np.ascontiguousarray(m, np.float32)


def device_resize_bicubic(x_u8: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor):
    """(B, H, W, 3) uint8 -> (B, S, S, 3) float32 in [0, 255] with PIL BICUBIC
    semantics, on x's device: horizontal then vertical separable pass
    (Pillow's order), each followed by round-half-up + clip, which
    replicates the uint8 intermediate store that clamps bicubic overshoot
    between passes. The JAX side runs both products at float32 with
    Precision.HIGHEST; here they run in float64, so no TF32 setting can
    reach them, and the integer results are cast to float32."""
    x = x_u8.to(torch.float64)
    t = torch.einsum("bhwc,ow->bhoc", x, wx.to(device=x.device, dtype=torch.float64))
    t = torch.clamp(torch.floor(t + 0.5), 0.0, 255.0)
    t = torch.einsum("bhoc,ph->bpoc", t, wy.to(device=x.device, dtype=torch.float64))
    return torch.clamp(torch.floor(t + 0.5), 0.0, 255.0).to(torch.float32)


def preprocess_image(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> normalized (1, size, size, 3) float32."""
    x = resize_image(image, size).astype(np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD)[None]
