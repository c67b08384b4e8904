"""The SD VAE, AutoencoderKL (port of the JAX package's nn/vae.py): the
encoder (images -> latent posterior; MultiDiffusion's bootstrap backgrounds,
img2img) and the decoder (latents -> images). Diffusers key names
(encoder.*, quant_conv, decoder.*, post_quant_conv); NHWC at the interface,
NCHW inside. The mid blocks' single-head attention is plain math, as on the
JAX side.
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


class _Downsample(nn.Module):
    """The encoder's downsampler: an asymmetric (0, 1) pad on the right and
    bottom, then a 3x3 stride-2 conv without padding (diffusers)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, groups: int,
                 downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if j == 0 else out_ch, out_ch, None, groups, eps=1e-6)
            for j in range(layers)])
        self.downsamplers = nn.ModuleList([_Downsample(out_ch)]) if downsample else None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    """Images (B, 3, H, W) -> moments (B, 2 * latent_channels, h, w)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], c, cfg.layers_per_block, g,
                       downsample=i < len(ch) - 1)
            for i, c in enumerate(ch)])
        self.mid_block = VAEMidBlock(ch[-1], g)
        self.conv_norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


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


# Parameter-name prefixes of the encode half (drawn after every other
# weight by `runtime.models.build_bundle`).
ENCODE_HALF = ("encoder.", "quant_conv.")


class AutoencoderKL(nn.Module):
    """The SD VAE. `decode` (also the module's call): scaled latents
    (B, h, w, 4) NHWC -> images (B, H, W, 3) in [-1, 1]; `encode_moments`
    and `encode`: images (B, H, W, 3) in [-1, 1] -> latents."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        # The decode half first: its parameters lead in registration order.
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)
        self.encoder = Encoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def decode(self, latents):
        z = latents.permute(0, 3, 1, 2) / self.config.scaling_factor
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)

    def forward(self, latents):
        return self.decode(latents)

    def encode_moments(self, images):
        """(mean, logvar) of the latent posterior, each (B, h, w, 4) in the
        compute dtype (as the JAX side's); logvar clipped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(images.permute(0, 3, 1, 2)))
        moments = moments.permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, images, noise=None):
        """A posterior sample (the mean when `noise` is None) times the SD
        scaling factor."""
        mean, logvar = self.encode_moments(images)
        z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise
        return z * self.config.scaling_factor


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images -> uint8 (clip, scale, round in f32)."""
    images = torch.clamp(images.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(images * 255.0).to(torch.uint8)
