"""GroupNorm (+ SiLU) whose statistics come from one reduction kernel (port of
the JAX package's nn/pallas/group_norm.py: `pair_stats`, `_group_moments`,
`group_norm` with `_gn_fwd` / `_gn_bwd`, `FusedGroupNorm`).

One hand-written CUDA kernel for Hopper (`lmdx_torch/csrc/pair_stats.cu`; its
source says what bounds it) sits behind the wrapper, with its plain PyTorch
version beside it:

- `pair_stats(a, b) -> (sum(a), sum(a * b))` over the last axis, f32.

Given CPU tensors the wrapper computes the plain version; given CUDA tensors
it launches the kernel or raises. The port is NCHW inside, so the inputs are
`(B, C, N)` views (the JAX side reduces `(B, N, C)` over N) and every output
is the sum of one contiguous row. The forward calls it with `(x, x)` on x in
its own dtype, the backward with `(g * silu', x_hat)` in f32: dbeta, dgamma
and both group moments of the dx formula come from that one pass. The
normalize, affine and SiLU stay elementwise torch ops, as they stay XLA on
the JAX side. `var = m2 - mean^2` in f32 is the reference's formula.

`GroupNormFn` is the autograd Function (guidance differentiates through every
norm of the UNet); `FusedGroupNorm` the module, with `GroupNorm`'s parameter
names and f32 output.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from . import build as buildlib

# Launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one exactly where it launches it.
LAUNCHES = {"pair_stats": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pair_stats_plain(a, b):
    """(sum(a), sum(a * b)) over the last axis, accumulated in f32."""
    af = a.float()
    return af.sum(-1), (af * b.float()).sum(-1)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    fn = buildlib.library("pair_stats").lmdx_pair_stats
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 4 + [_INT] * 3 + [_PTR]
        fn.restype = _INT
    return fn


def pair_stats(a, b):
    """Per-(B, C) sum(a) and sum(a * b) over the last axis of (B, C, N)
    tensors, each (B, C) f32; the CUDA kernel for CUDA tensors (both bf16 or
    both f32, contiguous; `b is a` is read once), the plain version for CPU
    tensors."""
    if a.device.type == "cpu":
        return pair_stats_plain(a, b)
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be (B, C, N) alike, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise ValueError(f"a {a.dtype} and b {b.dtype}: the kernel takes both bf16 "
                         "or both f32")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    bsz, c, n = a.shape
    sum_a, sum_ab = torch.empty((2, bsz, c), device=a.device, dtype=torch.float32)
    rc = _lib()(a.data_ptr(), b.data_ptr(), sum_a.data_ptr(), sum_ab.data_ptr(),
                bsz * c, n, int(a.dtype == torch.bfloat16),
                _PTR(torch.cuda.current_stream(a.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"pair_stats launch failed: CUDA error {rc}")
    LAUNCHES["pair_stats"] += 1
    return sum_a, sum_ab


def _group_moments(sum_c, sumsq_c, groups: int, n: int):
    """(B, C) channel sums -> per-group mean and raw second moment (B, G)."""
    bsz, c = sum_c.shape
    count = float(n * (c // groups))
    m1 = sum_c.reshape(bsz, groups, c // groups).sum(-1) / count
    m2 = sumsq_c.reshape(bsz, groups, c // groups).sum(-1) / count
    return m1, m2


def _per_channel(v, c: int):
    """(B, G) -> (B, C, 1): each group's value over its channels."""
    return v.repeat_interleave(c // v.shape[1], dim=1)[:, :, None]


class GroupNormFn(torch.autograd.Function):
    """GroupNorm over the channel axis of (B, C, ...) input with an optional
    trailing SiLU, f32 output (the port's `GroupNorm` returns f32); forward
    and backward statistics from `pair_stats`."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups: int, eps: float, apply_silu: bool):
        x = x.contiguous()
        bsz, c = x.shape[:2]
        x3 = x.reshape(bsz, c, -1)
        s, sq = pair_stats(x3, x3)
        mean, m2 = _group_moments(s, sq, groups, x3.shape[2])
        rstd = torch.rsqrt(m2 - mean.square() + eps)
        y = (x3.float() - _per_channel(mean, c)).mul_(_per_channel(rstd, c))
        y = y.mul_(weight.float()[None, :, None]).add_(bias.float()[None, :, None])
        if apply_silu:
            y = y.mul_(torch.sigmoid(y))
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.apply_silu = groups, apply_silu
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        groups = ctx.groups
        bsz, c = x.shape[:2]
        x3 = x.reshape(bsz, c, -1)
        n = x3.shape[2]
        w = weight.float()[None, :, None]
        rstd_c = _per_channel(rstd, c)
        x_hat = (x3.float() - _per_channel(mean, c)).mul_(rstd_c)
        g3 = g.reshape(bsz, c, n).float()
        if ctx.apply_silu:
            y_pre = x_hat * w + bias.float()[None, :, None]
            sig = torch.sigmoid(y_pre)
            g3 = g3 * (sig * (1.0 + y_pre * (1.0 - sig)))
        # One pass over (g3, x_hat): per channel, dbeta = sum g3 and
        # dgamma = sum g3 * x_hat; per group, the means of dx_hat and
        # dx_hat * x_hat with dx_hat = g3 * weight, the channel's weight
        # folded into its sums.
        s_g, s_gx = pair_stats(g3.contiguous(), x_hat)
        dbias = s_g.sum(0).to(bias.dtype)
        dweight = s_gx.sum(0).to(weight.dtype)
        m1, m2 = _group_moments(s_g * w[..., 0], s_gx * w[..., 0], groups, n)
        dx = rstd_c * (g3 * w - _per_channel(m1, c) - x_hat * _per_channel(m2, c))
        return dx.to(x.dtype).reshape(x.shape), dweight, dbias, None, None, None


class FusedGroupNorm(nn.Module):
    """Drop-in for the port's `GroupNorm` (parameters `weight`, `bias`; f32
    output) on `GroupNormFn`; `apply_silu` fuses the SiLU that follows the
    norm in the resnet blocks and before `conv_out`."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5,
                 apply_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.apply_silu = apply_silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return GroupNormFn.apply(x, self.weight, self.bias, self.num_groups, self.eps,
                                 self.apply_silu)
