"""Segment Anything (SAM ViT-B) for mask refinement (port of the JAX package's
nn/sam.py: the modules, `SAM_MEAN`/`SAM_STD`, the mask postprocess and
`FlaxSamSegmenter` as `SamSegmenter`).

Image encoder (ViTDet: windowed attention, decomposed relative positions,
conv neck), prompt encoder (Fourier point embeddings, point and box labels)
and the two-way-transformer mask decoder with three candidate masks and IoU
scores. Tensors are NHWC at the public functions, as on the JAX side. Every
encoder attention (the 14x14 windows and the 64x64 global grid) goes through
the SAM attention kernel (`kernels/sam_attention.py`); the decoder's small
attentions are plain math.

Parameters carry the key names of transformers' `SamModel`, so a
`facebook/sam-vit-base` state dict maps onto them; `runtime/convert.py::
sam_from_jax_params` turns the JAX package's parameter tree into one. The
port computes the JAX package's function, which departs from transformers'
SamModel in two places that a random-init comparison cannot see (its masks
are ~1e-5): the first two-way block adds its self-attention residual, and the
two up-scaling transposed convolutions apply their 2x2 kernels mirrored (flax
`ConvTranspose` without `transpose_kernel`, under `convert_sam`'s layout).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import boxes as boxlib
from ..utils import trace
from .attention import Conv2d, Embedding, LayerNorm, Linear
from .kernels import sam_attention as sam_kernel


@dataclass(frozen=True)
class SamConfig:
    image_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 768
    encoder_layers: int = 12
    encoder_heads: int = 12
    window_size: int = 14
    global_attn_layers: tuple[int, ...] = (2, 5, 8, 11)
    out_dim: int = 256
    decoder_layers: int = 2
    decoder_heads: int = 8
    num_multimask: int = 3

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def sam_vit_base() -> SamConfig:
    return SamConfig()


def tiny_sam() -> SamConfig:
    return SamConfig(image_size=64, patch_size=8, encoder_dim=32,
                     encoder_layers=2, encoder_heads=2, window_size=4,
                     global_attn_layers=(1,), out_dim=16, decoder_heads=2)


# ---- image encoder ---------------------------------------------------------

def _rel_pos_bias(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Decomposed relative position lookup (ViTDet): (q, k, dim) table."""
    coords_q = torch.arange(q_size, device=rel_pos.device)[:, None]
    coords_k = torch.arange(k_size, device=rel_pos.device)[None, :]
    return rel_pos[coords_q - coords_k + (k_size - 1)]


class SamAttention(nn.Module):
    """Self-attention over an (H, W) grid with the decomposed rel-pos bias
    bias_h = q . Rh and bias_w = q . Rw, computed here in f32 and added to
    the scores inside the kernel."""

    def __init__(self, dim: int, heads: int, input_size: tuple[int, int]):
        super().__init__()
        head_dim = dim // heads
        self.dim, self.heads = dim, heads
        self.qkv = Linear(dim, dim * 3)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):  # (B, H, W, C)
        b, h, w, _ = x.shape
        head_dim = self.dim // self.heads
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        rh = _rel_pos_bias(h, h, self.rel_pos_h.float())
        rw = _rel_pos_bias(w, w, self.rel_pos_w.float())
        q_sp = q.reshape(b, self.heads, h, w, head_dim).float()
        bias_h = torch.einsum("bnhwd,hkd->bnhwk", q_sp, rh).reshape(
            b, self.heads, h * w, h).contiguous()
        bias_w = torch.einsum("bnhwd,wkd->bnhwk", q_sp, rw).reshape(
            b, self.heads, h * w, w).contiguous()
        if sam_kernel.kernel_supported(q, h, w):
            out = sam_kernel.sam_attention(q, k, v, bias_h, bias_w)
        else:
            out = sam_kernel.sam_attention_plain(q, k, v, bias_h, bias_w)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, self.dim))


def _window_partition(x, win: int):
    b, h, w, c = x.shape
    pad_h = (win - h % win) % win
    pad_w = (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c), (hp, wp)


def _window_unpartition(x, win: int, padded, orig):
    hp, wp = padded
    h, w = orig
    b = x.shape[0] // ((hp // win) * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)


class SamEncoderBlock(nn.Module):
    def __init__(self, config: SamConfig, window: int, dtype):  # window 0 = global
        super().__init__()
        dim = config.encoder_dim
        self.window = window
        size = (window, window) if window else (config.grid, config.grid)
        self.layer_norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn = SamAttention(dim, config.encoder_heads, size)
        self.layer_norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp = _MLPBlock(dim, dim * 4)

    def forward(self, x):
        residual = x
        x = self.layer_norm1(x)
        if self.window:
            x, padded = _window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = _window_unpartition(x, self.window, padded, residual.shape[1:3])
        x = residual + x
        y = self.layer_norm2(x)
        return x + self.mlp.lin2(F.gelu(self.mlp.lin1(y)))


class _PatchEmbed(nn.Module):
    def __init__(self, config: SamConfig):
        super().__init__()
        p = config.patch_size
        self.projection = Conv2d(3, config.encoder_dim, p, stride=p)


class _Neck(nn.Module):
    def __init__(self, config: SamConfig):
        super().__init__()
        dim, out = config.encoder_dim, config.out_dim
        self.conv1 = Conv2d(dim, out, 1, bias=False)
        self.layer_norm1 = LayerNorm(out, 1e-6, torch.float32)
        self.conv2 = Conv2d(out, out, 3, padding=1, bias=False)
        self.layer_norm2 = LayerNorm(out, 1e-6, torch.float32)


def _nhwc_conv(conv, x):
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamImageEncoder(nn.Module):
    def __init__(self, config: SamConfig, dtype):
        super().__init__()
        g = config.grid
        self.patch_embed = _PatchEmbed(config)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, config.encoder_dim))
        self.layers = nn.ModuleList([
            SamEncoderBlock(config, 0 if i in config.global_attn_layers
                            else config.window_size, dtype)
            for i in range(config.encoder_layers)])
        self.neck = _Neck(config)

    def forward(self, pixels):  # (B, S, S, 3) normalized -> (B, g, g, out_dim) f32
        x = _nhwc_conv(self.patch_embed.projection, pixels)
        x = x + self.pos_embed.to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        x = self.neck.layer_norm1(_nhwc_conv(self.neck.conv1, x))
        return self.neck.layer_norm2(_nhwc_conv(self.neck.conv2, x))


# ---- prompt encoder --------------------------------------------------------

class _PositionalEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.zeros(2, dim // 2))


class SamPromptEncoder(nn.Module):
    """Points/boxes -> sparse prompt embeddings + dense positional grid.

    Point labels: 1 foreground, 0 background, 2/3 box corners, -1 pad."""

    def __init__(self, config: SamConfig):
        super().__init__()
        dim = config.out_dim
        self.grid = config.grid
        self.shared_embedding = _PositionalEmbedding(dim)
        self.point_embed = nn.ModuleList([Embedding(1, dim) for _ in range(4)])
        self.not_a_point_embed = Embedding(1, dim)
        self.no_mask_embed = Embedding(1, dim)

    def _pe(self, coords):  # coords in [0, 1], (..., 2)
        x = (2.0 * coords - 1.0) @ self.shared_embedding.positional_embedding
        x = 2.0 * math.pi * x
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)

    def dense_pe(self):
        g = self.grid
        c = (torch.arange(g, device=self.no_mask_embed.weight.device) + 0.5) / g
        return self._pe(torch.stack(torch.meshgrid(c, c, indexing="xy"), dim=-1))

    def no_mask_dense(self):
        """Dense embedding for "no mask prompt" (added to image embeds)."""
        return self.no_mask_embed.weight[0]

    def forward(self, points, labels):
        """points (B, N, 2) in [0, 1] xy; labels (B, N) int."""
        emb = self._pe(points)
        pad = (labels == -1)[..., None]
        not_a_point = self.not_a_point_embed.weight[0]
        emb = torch.where(pad, not_a_point, emb)
        for i in range(4):
            emb = torch.where((labels == i)[..., None], emb + self.point_embed[i].weight[0],
                              emb)
        return torch.where(pad, not_a_point, emb)


# ---- mask decoder ----------------------------------------------------------

class _DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = Linear(dim, inner)
        self.k_proj = Linear(dim, inner)
        self.v_proj = Linear(dim, inner)
        self.out_proj = Linear(inner, dim)

    def forward(self, q, k, v):
        b = q.shape[0]

        def split(x):
            return x.reshape(b, x.shape[1], self.heads, -1).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        head_dim = qh.shape[-1]
        attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) / math.sqrt(head_dim)
        probs = torch.softmax(attn, dim=-1).to(vh.dtype)
        out = torch.matmul(probs, vh).transpose(1, 2).reshape(b, q.shape[1], -1)
        return self.out_proj(out)


class _DecoderMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)


class TwoWayBlock(nn.Module):
    def __init__(self, config: SamConfig, skip_first_pe: bool, dtype):
        super().__init__()
        dim, heads = config.out_dim, config.decoder_heads
        self.skip_first_pe = skip_first_pe
        self.self_attn = _DecoderAttention(dim, heads)
        self.layer_norm1 = LayerNorm(dim, 1e-6, dtype)
        self.cross_attn_token_to_image = _DecoderAttention(dim, heads, downsample=2)
        self.layer_norm2 = LayerNorm(dim, 1e-6, dtype)
        self.mlp = _DecoderMLP(dim, dim * 8)
        self.layer_norm3 = LayerNorm(dim, 1e-6, dtype)
        self.cross_attn_image_to_token = _DecoderAttention(dim, heads, downsample=2)
        self.layer_norm4 = LayerNorm(dim, 1e-6, dtype)

    def forward(self, tokens, image, token_pe, image_pe):
        q = tokens if self.skip_first_pe else tokens + token_pe
        tokens = self.layer_norm1(tokens + self.self_attn(q, q, tokens))
        q = tokens + token_pe
        k = image + image_pe
        tokens = self.layer_norm2(tokens + self.cross_attn_token_to_image(q, k, image))
        tokens = self.layer_norm3(tokens + self.mlp.lin2(F.relu(self.mlp.lin1(tokens))))
        q = tokens + token_pe
        image = self.layer_norm4(image + self.cross_attn_image_to_token(k, q, tokens))
        return tokens, image


class _FeedForward(nn.Module):
    """Three-layer relu MLP (transformers' SamFeedForward key names)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.proj_in = Linear(dim, hidden)
        self.layers = nn.ModuleList([Linear(hidden, hidden)])
        self.proj_out = Linear(hidden, out)

    def forward(self, x):
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        return self.proj_out(x)


class _TwoWayTransformer(nn.Module):
    def __init__(self, config: SamConfig, dtype):
        super().__init__()
        dim = config.out_dim
        self.layers = nn.ModuleList([TwoWayBlock(config, i == 0, dtype)
                                     for i in range(config.decoder_layers)])
        self.final_attn_token_to_image = _DecoderAttention(dim, config.decoder_heads,
                                                           downsample=2)
        self.layer_norm_final_attn = LayerNorm(dim, 1e-6, dtype)


class MirroredConvTranspose2d(nn.ConvTranspose2d):
    """2x2 stride-2 up-sampling as the JAX package computes it: flax's
    `ConvTranspose` applies the kernel mirrored relative to torch's, and
    `convert_sam` keeps torch's layout, so the kernel is flipped here. NHWC
    in and out; the input is cast to the weight dtype."""

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(self.weight.dtype),
                               self.weight.flip((-2, -1)), self.bias, self.stride)
        return y.permute(0, 2, 3, 1)


class SamMaskDecoder(nn.Module):
    def __init__(self, config: SamConfig, dtype):
        super().__init__()
        dim = config.out_dim
        tokens = config.num_multimask + 1
        self.iou_token = Embedding(1, dim)
        self.mask_tokens = Embedding(tokens, dim)
        self.transformer = _TwoWayTransformer(config, dtype)
        self.upscale_conv1 = MirroredConvTranspose2d(dim, dim // 4, 2, stride=2)
        self.upscale_layer_norm = LayerNorm(dim // 4, 1e-6, torch.float32)
        self.upscale_conv2 = MirroredConvTranspose2d(dim // 4, dim // 8, 2, stride=2)
        self.output_hypernetworks_mlps = nn.ModuleList([
            _FeedForward(dim, dim, dim // 8) for _ in range(tokens)])
        self.iou_prediction_head = _FeedForward(dim, dim, tokens)

    def forward(self, image_embeds, image_pe, sparse_prompt):
        """image_embeds (B, g, g, D); image_pe (1, g, g, D); sparse_prompt
        (B, N, D). Returns (masks (B, 3, 4g, 4g) logits, iou (B, 3))."""
        b, g, _, dim = image_embeds.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens.expand(b, -1, -1), sparse_prompt], dim=1)
        image = image_embeds.reshape(b, g * g, dim)
        pe = image_pe.reshape(1, g * g, dim).expand(image.shape)
        token_pe = tokens

        x_tokens, x_image = tokens, image
        for layer in self.transformer.layers:
            x_tokens, x_image = layer(x_tokens, x_image, token_pe, pe)
        t = self.transformer
        x_tokens = t.layer_norm_final_attn(
            x_tokens + t.final_attn_token_to_image(x_tokens + token_pe, x_image + pe, x_image))

        iou_out = x_tokens[:, 0]
        mask_out = x_tokens[:, 1:1 + self.mask_tokens.num_embeddings]
        img = self.upscale_conv1(x_image.reshape(b, g, g, dim))
        img = F.gelu(self.upscale_layer_norm(img))
        img = F.gelu(self.upscale_conv2(img))             # (B, 4g, 4g, dim/8)
        hyper = torch.stack([mlp(mask_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("btc,bhwc->bthw", hyper, img)
        iou = self.iou_prediction_head(iou_out)
        # Multimask outputs are tokens 1..3 (token 0 is the single-mask path).
        return masks[:, 1:], iou[:, 1:]


class Sam(nn.Module):
    """dtype: the compute dtype of the Linear/Conv layers and of the
    encoder's and decoder's LayerNorm outputs (bf16 on the card)."""

    def __init__(self, config: SamConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.vision_encoder = SamImageEncoder(config, dtype)
        self.prompt_encoder = SamPromptEncoder(config)
        self.mask_decoder = SamMaskDecoder(config, dtype)

    def forward(self, pixels, points, labels):
        """pixels (B, S, S, 3); points (B, N, 2) xy in [0, 1]; labels (B, N).

        Returns (mask logits (B, 3, S/4, S/4), iou scores (B, 3))."""
        image_embeds = self.vision_encoder(pixels)
        sparse = self.prompt_encoder(points, labels)
        # No mask prompt: the learned no-mask embedding is added densely.
        image_embeds = image_embeds + self.prompt_encoder.no_mask_dense()
        dense_pe = self.prompt_encoder.dense_pe()[None]
        return self.mask_decoder(image_embeds, dense_pe, sparse)


SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _bilinear(x, oh: int, ow: int):
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                         antialias=False)


def postprocess_masks(masks, size: int, oh: int, ow: int, th: int, tw: int):
    """Low-res logits -> bilinear to the model size -> bilinear to the
    original image size -> threshold at 0 -> bilinear to the target latent
    size -> nonzero (the JAX side's `_postprocess_masks`)."""
    up = _bilinear(masks.float(), size, size)
    orig = (_bilinear(up, oh, ow) > 0.0).float()
    return _bilinear(orig, th, tw) != 0.0


def _host_rgb(image) -> np.ndarray:
    """A host image (numpy, PIL, or a tensor copied back) as HxWx3 uint8 RGB,
    through PIL as the JAX segmenter converts it."""
    from PIL import Image

    if torch.is_tensor(image):
        image = image.cpu().numpy()
    return np.asarray(Image.fromarray(np.asarray(image)).convert("RGB"), np.uint8)


class SamSegmenter:
    """masking.Segmenter backed by the port's SAM (`runtime.models.build_sam`).

    `segment_batch` runs the boxes of a pipeline batch in forwards of at most
    CHUNK images, resizing (bilinear, an upscale on every path: 512 -> 1024
    on the card) and normalizing on the device; the JAX side's
    `jax.image.resize` antialiases only on a downscale, which no path does.
    The JAX side also pads each chunk to a power of two to bound its XLA
    compiles; the port runs the real rows only, which the batch-independent
    forward leaves unchanged.

    Images are taken chunk by chunk by the JAX segmenter's rule. A chunk of
    tensors (the pipelines' decoded images, on the model's device) must be
    HxWx3 uint8 of one size, and goes up as it is. Any other chunk is host
    input: each image becomes RGB uint8 through PIL (`.convert("RGB")`:
    grayscale, RGBA and the other modes PIL reads), and a chunk whose sizes
    differ is resized to the model size with PIL's bilinear filter, after
    which the boxes are placed and the masks taken at that size.
    """

    CHUNK = 4

    def __init__(self, model: Sam):
        self.model = model
        self.config = model.config
        self.device = model.prompt_encoder.no_mask_embed.weight.device

    def segment(self, image, input_points=None, input_boxes=None, target_hw=None):
        [(masks, iou)] = self.segment_batch(
            [image],
            input_points=None if input_points is None else [input_points],
            input_boxes=None if input_boxes is None else [input_boxes],
            target_hw=target_hw)
        return masks, iou

    @torch.no_grad()
    def segment_batch(self, images, input_points=None, input_boxes=None,
                      target_hw=None):
        """One prompt per image: exactly one of input_points (B entries of
        [(x, y)]) and input_boxes (B entries of [(x0, y0, x1, y1)]),
        normalized. Returns a length-B list of (masks (3, h, w) bool, iou (3,)
        f32) at target_hw."""
        if (input_points is None) == (input_boxes is None):
            raise ValueError("need exactly one of input_points and input_boxes")
        if not images:
            return []
        with trace.annotate("segment"):
            chunks = []
            for s in range(0, len(images), self.CHUNK):
                with trace.annotate("sam_pixels"):
                    pixels = self._pixels(images[s:s + self.CHUNK])
                with trace.annotate("sam_chunk"):
                    chunks.append(self._segment_chunk(
                        pixels,
                        None if input_points is None else input_points[s:s + self.CHUNK],
                        None if input_boxes is None else input_boxes[s:s + self.CHUNK],
                        target_hw))
            masks = trace.to_host(torch.cat([m for m, _ in chunks]), "sam_masks_to_host")
            iou = trace.to_host(torch.cat([i for _, i in chunks]).float(), "sam_masks_to_host")
        return [(masks[i], iou[i]) for i in range(len(images))]

    def _pixels(self, images) -> torch.Tensor:
        """One chunk of images -> (n, H, W, 3) uint8 on the model's device."""
        if all(torch.is_tensor(im) for im in images):
            shapes = {tuple(im.shape) for im in images}
            if len(shapes) > 1:
                raise ValueError(f"a batch of tensors must share one size, got {shapes}")
            (shape,) = shapes
            if len(shape) != 3 or shape[2] != 3:
                raise ValueError(f"tensor images must be HxWx3, got {shape}")
            if any(im.dtype != torch.uint8 for im in images):
                raise ValueError("tensor images must be uint8")
            return torch.stack([im.to(self.device) for im in images])
        arrs = [_host_rgb(im) for im in images]
        if len({a.shape for a in arrs}) > 1:
            from PIL import Image

            size = self.config.image_size
            arrs = [np.asarray(Image.fromarray(a).resize((size, size), Image.BILINEAR),
                               np.uint8) for a in arrs]
        return trace.to_device(np.stack(arrs), self.device, "sam_to_device")

    def _segment_chunk(self, pixels, input_points, input_boxes, target_hw):
        n, oh, ow = pixels.shape[:3]
        size = self.config.image_size
        # Both prompt kinds share the 2-slot layout: a lone point rides slot
        # 0 with slot 1 "not a point" (label -1). Coordinates follow the
        # reference chain: normalized box -> integer pixels in image space ->
        # rescaled to the model size -> +0.5 pixel-center shift, normalized.
        points = np.zeros((n, 2, 2), np.float32)
        labels = np.full((n, 2), -1, np.int64)
        if input_boxes is not None:
            for i, [box] in enumerate(input_boxes):
                x0, y0, x1, y1 = boxlib.scale_proportion(box, oh, ow)
                sx, sy = size / ow, size / oh
                points[i] = [((x0 * sx + 0.5) / size, (y0 * sy + 0.5) / size),
                             ((x1 * sx + 0.5) / size, (y1 * sy + 0.5) / size)]
                labels[i] = (2, 3)
        else:
            for i, [(px, py)] in enumerate(input_points):
                points[i, 0] = ((px * size + 0.5) / size, (py * size + 0.5) / size)
                labels[i, 0] = 1

        x = _bilinear(pixels.permute(0, 3, 1, 2).float(), size, size).permute(0, 2, 3, 1)
        mean = trace.to_device(SAM_MEAN, self.device, "sam_to_device")
        std = trace.to_device(SAM_STD, self.device, "sam_to_device")
        masks, iou = self.model((x - mean) / std,
                                trace.to_device(points, self.device, "sam_to_device"),
                                trace.to_device(labels, self.device, "sam_to_device"))
        th, tw = target_hw
        return postprocess_masks(masks, size, oh, ow, th, tw), iou
