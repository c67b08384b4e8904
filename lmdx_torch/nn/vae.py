"""SD VAE decoder (port of the decode half of the JAX package's nn/vae.py),
diffusers key names (decoder.*, post_quant_conv). NHWC at the interface. The
encoder (img2img) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig
from .attention import Conv2d, GroupNorm, Linear
from .blocks import ResnetBlock, Upsample


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the mid block (plain math, as on
    the JAX side)."""

    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels), nn.Identity()])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / c**0.5
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        y = self.to_out[0](torch.matmul(probs, v))
        return x + y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, None, norm_num_groups, eps=1e-6)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_num_groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _UpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int, upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch, None, groups, eps=1e-6)
            for j in range(layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_ch)]) if upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _UpBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1, g,
                     upsample=i < len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    """post_quant_conv + decoder: scaled latents (B, h, w, 4) NHWC -> images
    (B, H, W, 3) in [-1, 1]."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)

    def forward(self, latents):
        z = latents.permute(0, 3, 1, 2) / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8 (clip, scale, round in f32)."""
    images = torch.clamp(images.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(images * 255.0).to(torch.uint8)
