"""SAM ViT attention with the decomposed relative-position bias (port of the
JAX package's nn/pallas/sam_attention.py: `xla_sam_attention`,
`_pallas_sam_attention`, `_kernel_supported`).

Two hand-written CUDA kernels for Hopper, one per dtype of q, k and v
(`lmdx_torch/csrc/sam_attention.cu` for bf16, `attention_f32.cu` for float32;
their sources say what bounds them), sit behind the wrapper, with its plain
PyTorch version beside it:

- `sam_attention(q, k, v, bias_h, bias_w) -> o`

computes softmax(q k^T / sqrt(d) + bias_h[q, k // gw] + bias_w[q, k % gw]) v
over (B, H, N, d) tensors with N = gh * gw tokens in row-major (kh, kw)
order; the bias is added unscaled (ViTDet / SAM) and is float32 in both
forms. Given CPU tensors the
wrapper computes the plain version; given CUDA tensors it launches the
kernel or raises. Forward only: SAM runs under no_grad on every path.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as buildlib

# Launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one exactly where it launches it.
LAUNCHES = {"sam_attention": 0, "sam_attention_f32": 0}

_MIN_TOKENS = 196  # the 14x14 windows of SAM ViT; smaller grids take plain math


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sam_attention_plain(q, k, v, bias_h, bias_w):
    """Materialized scores (the JAX side's `xla_sam_attention`): f32 scores
    of the scaled q k^T, the decomposed bias added unscaled in f32, f32
    softmax, probabilities cast to v's dtype for the AV product.

    q, k, v: (B, H, N, d); bias_h: (B, H, N, gh); bias_w: (B, H, N, gw)."""
    b, h, n, d = q.shape
    gh, gw = bias_h.shape[-1], bias_w.shape[-1]
    s = torch.matmul(q.float() * d ** -0.5, k.float().transpose(-1, -2))
    s = s.reshape(b, h, n, gh, gw)
    s = s + bias_h.float()[..., :, None] + bias_w.float()[..., None, :]
    p = torch.softmax(s.reshape(b, h, n, n), dim=-1).to(v.dtype)
    return torch.matmul(p, v)


def kernel_supported(q, gh: int, gw: int) -> bool:
    """The JAX dispatch gate without its VMEM budget and environment
    override: N = gh * gw, head_dim <= 128 and a multiple of 8, N >= 196
    (every SAM ViT-B layer: the 14x14 windows and the 64x64 global grid)."""
    *_, n, d = q.shape
    return n == gh * gw and d <= 128 and d % 8 == 0 and n >= _MIN_TOKENS


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib(dtype):
    """The C entry point for q's dtype, and its LAUNCHES key."""
    source, symbol, key = {
        torch.bfloat16: ("sam_attention", "lmdx_sam_attention", "sam_attention"),
        torch.float32: ("attention_f32", "lmdx_sam_attention_f32", "sam_attention_f32"),
    }[dtype]
    fn = getattr(buildlib.library(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 6 + [_INT] * 5 + [_PTR]
        fn.restype = _INT
    return fn, key


def _check(q, k, v, bias_h, bias_w) -> tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or bias_h.dim() != 4 or bias_w.dim() != 4:
        raise ValueError("q, k, v must be (B, heads, N, d), the biases (B, heads, N, g)")
    b, h, n, d = q.shape
    gh, gw = bias_h.shape[-1], bias_w.shape[-1]
    if (k.shape != q.shape or v.shape != q.shape or bias_h.shape != (b, h, n, gh)
            or bias_w.shape != (b, h, n, gw)):
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} bias_h {tuple(bias_h.shape)} "
                         f"bias_w {tuple(bias_w.shape)}")
    if n != gh * gw or d > 128 or d % 8 or b * h > 65535:
        raise ValueError(f"N={n} grid {gh}x{gw} head_dim {d} batch*heads {b * h} "
                         "outside the kernel")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes torch.bfloat16 or "
                         "torch.float32")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, q.dtype),
                           ("v", v, q.dtype), ("bias_h", bias_h, torch.float32),
                           ("bias_w", bias_w, torch.float32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, h, n, d, gh, gw


def sam_attention(q, k, v, bias_h, bias_w):
    """SAM attention with the decomposed rel-pos bias; for CUDA tensors the
    kernel of q's dtype (q, k, v all bf16 or all float32, biases float32, all
    contiguous), for CPU tensors the plain version (q, k and v of one
    dtype)."""
    if q.device.type == "cpu":
        if not q.dtype == k.dtype == v.dtype:
            raise ValueError(f"mixed dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}")
        return sam_attention_plain(q, k, v, bias_h, bias_w)
    b, h, n, d, gh, gw = _check(q, k, v, bias_h, bias_w)
    fn, key = _lib(q.dtype)
    o = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
            bias_w.data_ptr(), o.data_ptr(), b * h, n, d, gh, gw,
            _PTR(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return o
