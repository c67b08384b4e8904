"""Conditional 2D UNet with attention taps and GLIGEN grounding (port of the
JAX package's nn/unet.py).

    eps, taps = apply_unet(unet, latents_nhwc, t, context, objs=...,
                           taps=TapSpec(...), tap_token_index=...,
                           added_text_embeds=..., added_time_ids=...,
                           stop_after_taps=...)

Latents are NHWC at the interface (as on the JAX side) and NCHW inside. `taps`
is {AttnKey: (B, heads, n, L or 1)} f32 for the requested keys. With
`stop_after_taps` the forward ends after the last block holding a tapped
layer and eps is None: guidance passes read only the taps. A UNet with
text_time conditioning (SDXL) takes the pooled text embedding and the
micro-conditioning ids (`added_text_embeds`, `added_time_ids`): each id is
Fourier-embedded, concatenated after the pooled embedding and projected by
`add_embedding` into the time embedding. The transformer depth is per level
(`UNetConfig.transformer_depth`; the mid block takes the last level's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import KernelOptions, UNetConfig
from ..utils import trace
from .attention import NO_TAPS, Conv2d, Linear, TapSpec, group_norm, norm_silu
from .blocks import (
    CrossAttnDownBlock,
    CrossAttnUpBlock,
    DownBlock,
    MidBlock,
    TimestepEmbedding,
    UpBlock,
    timestep_embedding,
)


class FourierEmbedder(nn.Module):
    """Sin/cos features of box coordinates, ordered (freq, sin/cos, coord)."""

    def __init__(self, num_freqs: int = 8, temperature: float = 100.0):
        super().__init__()
        self.num_freqs = num_freqs
        self.temperature = temperature

    def forward(self, x):
        bands = self.temperature ** (
            torch.arange(self.num_freqs, dtype=torch.float32, device=x.device)
            / self.num_freqs)
        emb = bands[None, None, None, :] * x[..., None]              # (B, N, 4, F)
        emb = torch.stack([torch.sin(emb), torch.cos(emb)], dim=-1)  # (B, N, 4, F, 2)
        return emb.permute(0, 1, 3, 4, 2).reshape(*x.shape[:2], -1)


class PositionNet(nn.Module):
    """Grounding-token MLP: (boxes, validity masks, phrase embeddings) -> objs."""

    def __init__(self, positive_len: int, out_dim: int, fourier_freqs: int = 8):
        super().__init__()
        position_dim = fourier_freqs * 2 * 4
        self.fourier = FourierEmbedder(fourier_freqs)
        self.null_positive_feature = nn.Parameter(torch.zeros(positive_len))
        self.null_position_feature = nn.Parameter(torch.zeros(position_dim))
        self.linears = nn.ModuleList([
            Linear(positive_len + position_dim, 512), nn.SiLU(),
            Linear(512, 512), nn.SiLU(), Linear(512, out_dim)])

    def forward(self, boxes, masks, phrase_embeddings):
        xyxy = self.fourier(boxes)
        m = masks[..., None]
        phrase = phrase_embeddings * m + (1 - m) * self.null_positive_feature[None, None]
        xyxy = xyxy * m + (1 - m) * self.null_position_feature[None, None]
        h = torch.cat([phrase, xyxy], dim=-1)
        h = self.linears[2](F.silu(self.linears[0](h)))
        return self.linears[4](F.silu(h))


class UNet2DCondition(nn.Module):
    def __init__(self, cfg: UNetConfig, dtype=torch.float32,
                 kernels: KernelOptions = KernelOptions()):
        super().__init__()
        self.config = cfg
        self.compute_dtype = dtype
        ch = cfg.block_out_channels
        temb = cfg.time_embed_dim
        linear = cfg.use_linear_projection
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = (
            TimestepEmbedding(cfg.projection_class_embeddings_input_dim, temb)
            if cfg.addition_embed_type == "text_time" else None)

        skips = [ch[0]]  # channels of every residual, in push order
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, block_type in enumerate(cfg.down_block_types):
            last = i == len(cfg.down_block_types) - 1
            if block_type == "CrossAttnDownBlock2D":
                block = CrossAttnDownBlock(
                    prev, ch[i], temb, cfg.layers_per_block, cfg.num_attention_heads[i],
                    cfg.cross_attention_dim, cfg.transformer_depth(i), cfg.norm_num_groups,
                    add_downsample=not last, use_gated_attention=cfg.use_gligen,
                    tap_place=f"down_{i}", dtype=dtype, options=kernels,
                    use_linear_projection=linear)
            elif block_type == "DownBlock2D":
                block = DownBlock(prev, ch[i], temb, cfg.layers_per_block,
                                  cfg.norm_num_groups, add_downsample=not last,
                                  options=kernels)
            else:
                raise ValueError(block_type)
            self.down_blocks.append(block)
            skips += [ch[i]] * (cfg.layers_per_block + (0 if last else 1))
            prev = ch[i]

        self.mid_block = MidBlock(ch[-1], temb, cfg.num_attention_heads[-1],
                                  cfg.cross_attention_dim, cfg.transformer_depth(len(ch) - 1),
                                  cfg.norm_num_groups, use_gated_attention=cfg.use_gligen,
                                  dtype=dtype, options=kernels, use_linear_projection=linear)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        n_up = cfg.layers_per_block + 1
        for i, block_type in enumerate(cfg.up_block_types):
            level = len(ch) - 1 - i
            last = i == len(cfg.up_block_types) - 1
            block_skips = [skips.pop() for _ in range(n_up)]
            if block_type == "CrossAttnUpBlock2D":
                block = CrossAttnUpBlock(
                    rev[i], prev, temb, n_up, cfg.num_attention_heads[level],
                    cfg.cross_attention_dim, cfg.transformer_depth(level),
                    cfg.norm_num_groups, add_upsample=not last,
                    use_gated_attention=cfg.use_gligen, tap_place=f"up_{i}", dtype=dtype,
                    skip_channels=block_skips, options=kernels,
                    use_linear_projection=linear)
            elif block_type == "UpBlock2D":
                block = UpBlock(rev[i], prev, temb, n_up, cfg.norm_num_groups,
                                add_upsample=not last, skip_channels=block_skips,
                                options=kernels)
            else:
                raise ValueError(block_type)
            self.up_blocks.append(block)
            prev = rev[i]

        self.conv_norm_out = group_norm(cfg.norm_num_groups, ch[0], 1e-5, kernels,
                                        silu=True)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states, objs=None,
                taps: TapSpec = NO_TAPS, tap_token_index=None,
                stop_after_taps: bool = False, taps_out: dict | None = None,
                added_text_embeds=None, added_time_ids=None):
        cfg = self.config
        stop_point = _last_tap_point(taps) if stop_after_taps else None
        dtype = self.conv_in.weight.dtype
        timesteps = trace.to_device(timesteps, sample.device, "timesteps_to_device")
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_feat = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                    cfg.flip_sin_to_cos, cfg.freq_shift)
        t_emb = self.time_embedding(t_feat)
        if self.add_embedding is not None:
            if added_text_embeds is None or added_time_ids is None:
                raise ValueError("text_time conditioning needs added_text_embeds and "
                                 "added_time_ids")
            id_emb = timestep_embedding(
                added_time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift).reshape(added_time_ids.shape[0], -1)
            aug = torch.cat([added_text_embeds.to(id_emb.dtype), id_emb], dim=-1)
            t_emb = t_emb + self.add_embedding(aug)

        x = self.conv_in(sample.permute(0, 3, 1, 2).to(dtype))
        context = encoder_hidden_states.to(dtype)
        kw = dict(objs=objs, taps=taps, tap_token_index=tap_token_index,
                  taps_out=taps_out)

        residuals = [x]
        for i, block in enumerate(self.down_blocks):
            if isinstance(block, CrossAttnDownBlock):
                x, res = block(x, t_emb, context, **kw)
            else:
                x, res = block(x, t_emb)
            residuals.extend(res)
            if stop_point == ("down", i):
                return None

        x = self.mid_block(x, t_emb, context, **kw)
        if stop_point == ("mid", 0):
            return None

        for i, block in enumerate(self.up_blocks):
            n = len(block.resnets)
            res = residuals[-n:]
            del residuals[-n:]
            if isinstance(block, CrossAttnUpBlock):
                x = block(x, res, t_emb, context, **kw)
            else:
                x = block(x, res, t_emb)
            if stop_point == ("up", i):
                return None

        x = self.conv_out(norm_silu(self.conv_norm_out, x))
        return x.float().permute(0, 2, 3, 1)


def _last_tap_point(taps: TapSpec):
    """The last (place, block) holding a tapped layer, in forward order."""
    if not taps:
        return None
    down = [k[1] for k in taps.keys if k[0] == "down"]
    mid = [k for k in taps.keys if k[0] == "mid"]
    up = [k[1] for k in taps.keys if k[0] == "up"]
    if up:
        return ("up", max(up))
    if mid:
        return ("mid", 0)
    return ("down", max(down))


def apply_unet(unet: UNet2DCondition, sample, timesteps, encoder_hidden_states,
               objs=None, taps: TapSpec = NO_TAPS, tap_token_index=None,
               stop_after_taps: bool = False, added_text_embeds=None,
               added_time_ids=None):
    """Returns (eps (B, H, W, C) f32 or None, {AttnKey: probs})."""
    taps_out: dict = {}
    eps = unet(sample, timesteps, encoder_hidden_states, objs=objs, taps=taps,
               tap_token_index=tap_token_index, stop_after_taps=stop_after_taps,
               taps_out=taps_out, added_text_embeds=added_text_embeds,
               added_time_ids=added_time_ids)
    return eps, taps_out
