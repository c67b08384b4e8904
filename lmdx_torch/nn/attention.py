"""Attention layers of the grounded-diffusion UNet (port of the JAX package's
nn/attention.py), plus the dtype-following Linear/Conv/norm layers every
module of the port is built from.

Taps are functional, as on the JAX side: the UNet forward takes a static
`TapSpec` naming the cross-attention layers to export, and a tapped layer
writes its probability map into the `taps_out` dict it is handed (the JAX
side `sow`s into a "taps" collection). The maps keep their autograd graph, so
the guidance loss back-propagates through them into the latents.

Dispatch is the JAX side's. With `KernelOptions()` (all off, the default):
untapped layers whose KV has >= 256 tokens go through the flash-attention
kernel (`kernels/flash_attention.py`); tapped layers, the 77-token
cross-attention and the 64-token mid block stay plain math (matmul + f32
softmax). With `fused_heads` an untapped layer hands its projections unsplit
to `flash_attention_hd`: every 77-token cross-attention and the self and
fuser attention of the 1024-, 256- and 64-token levels run the fused-heads
kernel, the 4096-token self and fuser attention fall to the per-head flash
kernel; tapped layers stay plain math. With `packed_attention` the per-head
flash forward is the head-packed kernel. With `fused_group_norm` the UNet's
GroupNorms are `FusedGroupNorm` (`kernels/group_norm.py`), the SiLU that
follows a resnet norm fused into it. SAM's encoder attention (nn/sam.py)
dispatches through its own kernel (`kernels/sam_attention.py`): every grid
of >= 196 tokens (the 14x14 windows, the 64x64 global layers) takes it; its
mask decoder's attentions stay plain math.

Dtypes: Linear/Conv weights are stored in the compute dtype and cast their
input to it (flax `Dense(dtype=...)`); norm parameters stay f32 and norms
compute in f32, LayerNorm returning the compute dtype and GroupNorm f32, as
the flax modules are configured.

Tensor split (`dist/mesh.py::shard_params`): an attention or feed-forward
split over a tp mesh holds its `TensorSplit` in `tp_split` and the rank's
heads (or GEGLU's paired slices of h and gate); its input passes
`copy_in`, its row-split output layer all-reduces, and a tapped layer
gathers its maps over heads before it exports them. Without a mesh
`tp_split` is None and none of this runs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..config import KernelOptions
from .kernels import flash_attention as fa
from .kernels.flash_attention import merge_heads, split_heads
from .kernels.group_norm import FusedGroupNorm

AttnKey = tuple[str, int, int, int]


def key_name(key: AttnKey) -> str:
    return "_".join(str(part) for part in key)


def name_to_key(name: str) -> AttnKey:
    place, a, b, c = name.split("_")
    return (place, int(a), int(b), int(c))


@dataclass(frozen=True)
class TapSpec:
    """Which cross-attention maps to export.

    cond_only: export only the conditional half of a CFG-doubled batch.
    single_token: export only each batch row's token column, given per call
        by `tap_token_index` (one index per exported row).
    fused: the untapped layers that receive this spec (the cross-attentions)
        take the kernels' route. False sends them to plain math in forward
        and backward (`attention_plain`), skipping the fused-heads and flash
        routes: the JAX side's `_xla_attention`, the reference's routing of
        BoxDiff's guidance gradient (flash attention off under guidance).
        It is a choice of route, not a fallback; the self-attentions, which
        receive no spec, route as always.
    """

    keys: tuple[AttnKey, ...] = ()
    cond_only: bool = False
    single_token: bool = False
    fused: bool = True

    def __bool__(self) -> bool:
        return bool(self.keys)

    @property
    def names(self) -> frozenset[str]:
        return frozenset(key_name(k) for k in self.keys)


NO_TAPS = TapSpec()


class Linear(nn.Linear):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Embedding(nn.Embedding):
    """nn.Embedding without its N(0, 1) draw at construction: a bundle's
    weights are drawn by `runtime.models` or loaded from a checkpoint into
    modules built on the `meta` device, where `normal_`'s first call in a
    process imports torch's Python meta kernels, which takes seconds."""

    def reset_parameters(self) -> None:
        pass


class LayerNorm(nn.LayerNorm):
    """f32 statistics and parameters; output in `out_dtype`."""

    def __init__(self, dim: int, eps: float, out_dtype: torch.dtype):
        super().__init__(dim, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.out_dtype)


class GroupNorm(nn.GroupNorm):
    """f32 GroupNorm over NCHW; returns f32 like the flax modules
    (`nn.GroupNorm(dtype=float32)`)."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


def group_norm(num_groups: int, channels: int, eps: float, options: KernelOptions,
               silu: bool = False) -> nn.Module:
    """The UNet's GroupNorm under `options`: `FusedGroupNorm` (with the SiLU
    that follows it fused in when `silu`) or the plain `GroupNorm`."""
    if options.fused_group_norm:
        return FusedGroupNorm(num_groups, channels, eps=eps, apply_silu=silu)
    return GroupNorm(num_groups, channels, eps=eps)


def norm_silu(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """SiLU(norm(x)); a `FusedGroupNorm` built with `apply_silu` has applied
    it already."""
    y = norm(x)
    return y if getattr(norm, "apply_silu", False) else F.silu(y)


def attention_probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Explicit softmax probabilities in f32: (B, h, Lq, Lk)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.softmax(scores, dim=-1)


class CrossAttention(nn.Module):
    """Multi-head attention (self when context is None); diffusers key names
    (to_q, to_k, to_v, to_out.0)."""

    tp_split = None

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: int | None = None, tap_name: str | None = None,
                 options: KernelOptions = KernelOptions()):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.tap_name = tap_name
        self.options = options
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim), nn.Identity()])

    def forward(self, x, context=None, taps: TapSpec = NO_TAPS,
                tap_token_index=None, taps_out: dict | None = None):
        if self.tp_split is not None:
            x = self.tp_split.copy_in(x)
            context = None if context is None else self.tp_split.copy_in(context)
        ctx = x if context is None else context
        qf, kf, vf = self.to_q(x), self.to_k(ctx), self.to_v(ctx)

        tapped = self.tap_name is not None and self.tap_name in taps.names
        if self.options.fused_heads and not tapped and taps.fused:
            # Projection layout: no head-split copies around the kernel.
            return self.to_out[0](fa.flash_attention_hd(qf, kf, vf, self.heads,
                                                        self.options))

        q, k, v = (split_heads(t, self.heads) for t in (qf, kf, vf))
        if tapped:
            probs = attention_probs(q, k)
            export = probs
            if taps.cond_only:
                # CFG convention: [uncond..., cond...] along the batch axis.
                export = export[export.shape[0] // 2:]
            if taps.single_token:
                if tap_token_index is None:
                    raise ValueError("TapSpec.single_token requires tap_token_index")
                idx = torch.as_tensor(tap_token_index, device=export.device)
                idx = idx.long().view(-1, 1, 1, 1).expand(*export.shape[:-1], 1)
                export = torch.gather(export, -1, idx)
            if taps_out is not None:
                if self.tp_split is not None:
                    export = self.tp_split.gather_heads(export)
                taps_out[name_to_key(self.tap_name)] = export
            out = torch.matmul(probs.to(v.dtype), v)
        elif taps.fused and fa.kernel_supported(q, k):
            out = fa.flash_attention(q, k, v, packed=self.options.packed_attention)
        else:
            out = fa.attention_plain(q, k, v)
        return self.to_out[0](merge_heads(out))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    tp_split = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x):
        if self.tp_split is not None:
            x = self.tp_split.copy_in(x)
        return self.net[2](self.net[0](x))


class GatedSelfAttention(nn.Module):
    """GLIGEN's gated self-attention fuser: the visual tokens attend over
    [visual ‖ grounding tokens] and the result enters through tanh gates.
    Only the visual rows are queried (identical for those rows to the
    reference's full self-attention followed by a slice), which keeps Lq at
    the latent token count and Lk = Lq + max_objs on the flash kernel."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 head_dim: int, dtype=torch.float32,
                 options: KernelOptions = KernelOptions()):
        super().__init__()
        self.linear = Linear(context_dim, query_dim)
        self.attn = CrossAttention(query_dim, heads, head_dim, options=options)
        self.ff = FeedForward(query_dim)
        self.norm1 = LayerNorm(query_dim, 1e-6, dtype)
        self.norm2 = LayerNorm(query_dim, 1e-6, dtype)
        self.alpha_attn = nn.Parameter(torch.zeros(()))
        self.alpha_dense = nn.Parameter(torch.zeros(()))

    def forward(self, x, objs):
        n_visual = x.shape[1]
        objs = self.linear(objs)
        h = self.norm1(torch.cat([x, objs.to(x.dtype)], dim=1))
        h = self.attn(h[:, :n_visual], context=h)
        x = x + torch.tanh(self.alpha_attn) * h
        return x + torch.tanh(self.alpha_dense) * self.ff(self.norm2(x))


class BasicTransformerBlock(nn.Module):
    """Self-attention -> (GLIGEN fuser) -> cross-attention -> feed-forward."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 tap_name: str | None = None, use_gated_attention: bool = False,
                 dtype=torch.float32, options: KernelOptions = KernelOptions()):
        super().__init__()
        self.norm1 = LayerNorm(dim, 1e-6, dtype)
        self.attn1 = CrossAttention(dim, heads, head_dim, options=options)
        self.fuser = (GatedSelfAttention(dim, context_dim, heads, head_dim, dtype,
                                         options=options)
                      if use_gated_attention else None)
        self.norm2 = LayerNorm(dim, 1e-6, dtype)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim=context_dim,
                                    tap_name=tap_name, options=options)
        self.norm3 = LayerNorm(dim, 1e-6, dtype)
        self.ff = FeedForward(dim)

    def forward(self, x, context, objs=None, taps: TapSpec = NO_TAPS,
                tap_token_index=None, taps_out=None):
        x = x + self.attn1(self.norm1(x))
        if self.fuser is not None and objs is not None:
            x = self.fuser(x, objs)
        x = x + self.attn2(self.norm2(x), context=context, taps=taps,
                           tap_token_index=tap_token_index, taps_out=taps_out)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm -> proj_in -> transformer blocks over the H*W tokens ->
    proj_out, residual. NCHW in and out; tokens are taken in (h, w) row-major
    order, the order of the JAX side's NHWC reshape. The projections are 1x1
    convolutions, or under `use_linear_projection` (SD2 / SDXL) `Linear`
    layers on the token layout."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1, norm_num_groups: int = 32,
                 tap_prefix: str | None = None,
                 use_gated_attention: bool = False, dtype=torch.float32,
                 options: KernelOptions = KernelOptions(),
                 use_linear_projection: bool = False):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        self.norm = group_norm(norm_num_groups, channels, 1e-6, options)
        proj = Linear if use_linear_projection else (lambda i, o: Conv2d(i, o, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                channels, heads, channels // heads, context_dim,
                tap_name=f"{tap_prefix}_{k}" if tap_prefix else None,
                use_gated_attention=use_gated_attention, dtype=dtype,
                options=options)
            for k in range(depth)])
        self.proj_out = proj(channels, channels)

    def forward(self, x, context, objs=None, taps: TapSpec = NO_TAPS,
                tap_token_index=None, taps_out=None):
        b, c, h, w = x.shape
        residual = x
        if self.use_linear_projection:
            y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            y = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context, objs=objs, taps=taps,
                      tap_token_index=tap_token_index, taps_out=taps_out)
        if self.use_linear_projection:
            return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + residual
