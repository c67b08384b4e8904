"""UNet building blocks (port of the JAX package's nn/blocks.py), NCHW inside,
diffusers key names. Each cross-attention layer carries the static tap name
"<place>_<block>_<attention>_<transformer>" that `TapSpec` matches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import KernelOptions
from .attention import (
    NO_TAPS,
    Conv2d,
    Linear,
    TapSpec,
    Transformer2D,
    group_norm,
    norm_silu,
)


def timestep_embedding(timesteps: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class TimestepEmbedding(nn.Module):
    tp_split = None  # dist/mesh.py: linear_1 column-split, linear_2 row-split

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, t_feat):
        if self.tp_split is not None:
            t_feat = self.tp_split.copy_in(t_feat)
        return self.linear_2(F.silu(self.linear_1(t_feat)))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int | None,
                 norm_num_groups: int = 32, eps: float = 1e-5,
                 options: KernelOptions = KernelOptions()):
        super().__init__()
        self.norm1 = group_norm(norm_num_groups, in_channels, eps, options, silu=True)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_channels) if temb_dim else None
        self.norm2 = group_norm(norm_num_groups, out_channels, eps, options, silu=True)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, t_emb=None):
        h = self.conv1(norm_silu(self.norm1, x))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(t_emb))[:, :, None, None]
        h = self.conv2(norm_silu(self.norm2, h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class CrossAttnDownBlock(nn.Module):
    def __init__(self, in_channels, out_channels, temb_dim, num_layers, heads,
                 context_dim, depth=1, norm_num_groups=32, add_downsample=True,
                 use_gated_attention=False, tap_place="down_0", dtype=torch.float32,
                 options=KernelOptions(), use_linear_projection=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        temb_dim, norm_num_groups, options=options)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, context_dim, depth, norm_num_groups,
                          tap_prefix=f"{tap_place}_{i}",
                          use_gated_attention=use_gated_attention, dtype=dtype,
                          options=options, use_linear_projection=use_linear_projection)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x, t_emb, context, objs=None, taps: TapSpec = NO_TAPS,
                tap_token_index=None, taps_out=None):
        residuals = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = resnet(x, t_emb)
            x = attn(x, context, objs=objs, taps=taps,
                     tap_token_index=tap_token_index, taps_out=taps_out)
            residuals.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            residuals.append(x)
        return x, residuals


class DownBlock(nn.Module):
    def __init__(self, in_channels, out_channels, temb_dim, num_layers,
                 norm_num_groups=32, add_downsample=True, options=KernelOptions()):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        temb_dim, norm_num_groups, options=options)
            for i in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x, t_emb):
        residuals = []
        for resnet in self.resnets:
            x = resnet(x, t_emb)
            residuals.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            residuals.append(x)
        return x, residuals


class MidBlock(nn.Module):
    def __init__(self, channels, temb_dim, heads, context_dim, depth=1,
                 norm_num_groups=32, use_gated_attention=False, dtype=torch.float32,
                 options=KernelOptions(), use_linear_projection=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, temb_dim, norm_num_groups, options=options)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, context_dim, depth, norm_num_groups,
                          tap_prefix="mid_0_0",
                          use_gated_attention=use_gated_attention, dtype=dtype,
                          options=options, use_linear_projection=use_linear_projection)])

    def forward(self, x, t_emb, context, objs=None, taps: TapSpec = NO_TAPS,
                tap_token_index=None, taps_out=None):
        x = self.resnets[0](x, t_emb)
        x = self.attentions[0](x, context, objs=objs, taps=taps,
                               tap_token_index=tap_token_index, taps_out=taps_out)
        return self.resnets[1](x, t_emb)


class CrossAttnUpBlock(nn.Module):
    def __init__(self, out_channels, prev_channels, temb_dim,
                 num_layers, heads, context_dim, depth=1, norm_num_groups=32,
                 add_upsample=True, use_gated_attention=False, tap_place="up_0",
                 dtype=torch.float32, skip_channels=None, options=KernelOptions(),
                 use_linear_projection=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock((prev_channels if i == 0 else out_channels) + skip_channels[i],
                        out_channels, temb_dim, norm_num_groups, options=options)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, context_dim, depth, norm_num_groups,
                          tap_prefix=f"{tap_place}_{i}",
                          use_gated_attention=use_gated_attention, dtype=dtype,
                          options=options, use_linear_projection=use_linear_projection)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, t_emb, context, objs=None,
                taps: TapSpec = NO_TAPS, tap_token_index=None, taps_out=None):
        for resnet, attn in zip(self.resnets, self.attentions):
            x = torch.cat([x, res_samples.pop()], dim=1)
            x = resnet(x, t_emb)
            x = attn(x, context, objs=objs, taps=taps,
                     tap_token_index=tap_token_index, taps_out=taps_out)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UpBlock(nn.Module):
    def __init__(self, out_channels, prev_channels, temb_dim,
                 num_layers, norm_num_groups=32, add_upsample=True,
                 skip_channels=None, options=KernelOptions()):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock((prev_channels if i == 0 else out_channels) + skip_channels[i],
                        out_channels, temb_dim, norm_num_groups, options=options)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_samples, t_emb):
        for resnet in self.resnets:
            x = torch.cat([x, res_samples.pop()], dim=1)
            x = resnet(x, t_emb)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x
