"""Flash attention for the UNet's untapped layers (port of the JAX package's
nn/pallas/flash_attention.py: `_pallas_attention`, `_pallas_attention_bwd`,
`_flash_attention_ad`, `flash_attention`, `_kernel_supported`).

Two hand-written CUDA kernels for Hopper (`lmdx_torch/csrc/flash_fwd.cu`,
`flash_bwd.cu`; their sources say what bounds them and how they are built)
sit behind two wrappers, each with its plain PyTorch version beside it:

- `flash_attention_fwd(q, k, v) -> (o, lse)`
- `flash_attention_bwd(q, k, v, lse, o, do) -> (dq, dk, dv)`

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its kernel or raises. `FlashAttention` wires both into autograd, as
`jax.custom_vjp` does on the JAX side, and `flash_attention` is the dispatch
the attention layers call.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as buildlib

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel.
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle the kernels are held against)
# ---------------------------------------------------------------------------


def attention_fwd_plain(q, k, v):
    """softmax(q k^T / sqrt(d)) v in f32 and the row log-sum-exp of the
    scaled scores. q: (B, h, Lq, d), k/v: (B, h, Lk, d). Returns o in q's
    dtype and lse (B, h, Lq) f32."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def attention_bwd_plain(q, k, v, lse, o, do):
    """dq, dk, dv of attention by recompute from the forward's lse, in f32,
    cast to the inputs' dtype (the math of the backward kernel)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (gf * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _fwd_lib():
    lib = buildlib.library("flash_fwd")
    fn = lib.lmdx_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 5 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    return fn


def _bwd_lib():
    lib = buildlib.library("flash_bwd")
    fn = lib.lmdx_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 10 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    return fn


def _check_cuda(named: dict, like: torch.Tensor, dtype) -> None:
    for name, t in named.items():
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected {like.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_qkv(q, k, v) -> tuple[int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, heads, L, head_dim)")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d > 256 or b * h > 65535:
        raise ValueError(f"head_dim {d} / batch*heads {b * h} outside the kernel")
    _check_cuda({"q": q, "k": k, "v": v}, q, torch.bfloat16)
    return b, h, lq, lk, d


def _stream(t: torch.Tensor) -> _PTR:
    return _PTR(torch.cuda.current_stream(t.device).cuda_stream)


def flash_attention_fwd(q, k, v):
    """(o, lse) of attention; the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    rc = _fwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), b * h, lq, lk, d, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, lse, o, do):
    """(dq, dk, dv) of attention from the forward's lse and o; the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, lse, o, do)
    b, h, lq, lk, d = _check_qkv(q, k, v)
    _check_cuda({"o": o, "do": do}, q, torch.bfloat16)
    _check_cuda({"lse": lse}, q, torch.float32)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, lq):
        raise ValueError("o/do must match q and lse must be (B, heads, Lq)")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    rc = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    b * h, lq, lk, d, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed: CUDA error {rc}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the flash backward (the port of
    `_flash_attention_ad`'s custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, lse, o, do.contiguous())


def kernel_supported(q, k) -> bool:
    """The JAX dispatch gate: KV >= 256 tokens, head_dim <= 256, Lq >= 8.
    Shorter KV (the 77-token cross-attention, the 64-token mid block) stays
    on plain math, as on the JAX side."""
    lq, d = q.shape[-2:]
    return d <= 256 and lq >= 8 and k.shape[2] >= 256


def flash_attention(q, k, v):
    """Fused attention over (B, heads, L, head_dim) tensors, differentiable;
    callers check `kernel_supported` first."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())
