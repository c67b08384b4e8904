"""Flash attention for the UNet's untapped layers (port of the JAX package's
nn/pallas/flash_attention.py: `_pallas_attention`, `_pallas_attention_bwd`,
`_pallas_attention_packed`, `_pallas_attention_fusedheads`,
`_flash_attention_ad`, `_fusedheads_ad`, `flash_attention`,
`flash_attention_hd`, `_kernel_supported`, `_fusedheads_supported`).

Hand-written CUDA kernels for Hopper (`lmdx_torch/csrc/flash_fwd.cu`,
`flash_bwd.cu`, `flash_fwd_packed.cu`, `flash_fwd_fusedheads.cu` for bf16;
`attention_f32.cu` for the float32 forms of all four; their sources say what
bounds them and how they are built) sit behind four wrappers, each with its
plain PyTorch version beside it. q's dtype chooses the kernel, and the other
inputs must match it:

- `flash_attention_fwd(q, k, v) -> (o, lse)` on (B, heads, L, head_dim),
  bf16 or float32
- `flash_attention_bwd(q, k, v, lse, o, do) -> (dq, dk, dv)`, likewise
- `flash_attention_fwd_packed(q, k, v) -> (o, lse)`: the same function from
  the reference's start values (row max -1e30, denominator clamped at
  1e-30); its plain version takes the heads in groups of
  `head_pack(head_dim)` as the reference does, its kernel one head a block
- `flash_attention_fwd_fusedheads(qf, kf, vf, heads) -> (o, lse)` on the
  projection layout (B, L, heads * head_dim), lse (B, heads, Lq)

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches its kernel or raises. `FlashAttention` and `FusedHeadsAttention` wire
them into autograd, as `jax.custom_vjp` does on the JAX side; both take their
gradient from `flash_attention_bwd` (the fused-heads one after a head split).
`attention_fwd_tiled_plain` repeats, step by step, the arithmetic of the
bf16 forward body that the three bf16 forward kernels and SAM's share
(`csrc/attention_fwd.cuh`), and `attention_bwd_tiled_plain` that of the bf16
backward's two kernels (`csrc/flash_bwd.cu`); the CPU tests hold them against
the plain versions. Every float32 kernel runs on the tensor cores in 3xTF32
(`csrc/attention_f32_tc.cuh`): `attention_fwd_tc_plain` repeats the steps of
the float32 forward body (kernels 1, 3, 4 and 5 at float32; the fused-heads
form is `attention_fwd_fusedheads_tc_plain`) and `attention_bwd_tc_plain`
those of the float32 backward (`matmul_3xtf32` over their tiles).

Dispatch (the attention layers call it for their untapped attentions):

- `KernelOptions()` (all off): `kernel_supported` (KV >= 256 tokens, inside
  the reference's size rule) sends a layer to `flash_attention` on split
  heads and `flash_attention_fwd`; the rest stays plain math.
- `packed_attention`: `flash_attention` takes `flash_attention_fwd_packed`
  in place of `flash_attention_fwd`.
- `fused_heads`: `flash_attention_hd` takes the projections unsplit. Where
  `fusedheads_supported` holds (every 77-token cross-attention and the self
  and fuser attention of the 256- and 64-token levels, and at bf16 those of
  the 1024-token level too, by the reference's size rule) it runs
  `FusedHeadsAttention`; otherwise it splits heads and dispatches as above.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import KernelOptions
from . import build as buildlib

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one exactly where it launches its kernel.
# `flash_attention_bwd` counts every bf16 backward, `flash_attention_bwd_sm90`
# those of them that ran the warpgroup-MMA kernels (`csrc/flash_bwd_sm90.cuh`:
# head dims that are a multiple of 8 and pad to 48 or 80).
LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_sm90": 0,
            "flash_attention_fwd_packed": 0, "flash_attention_fwd_fusedheads": 0,
            "flash_attention_fwd_f32": 0, "flash_attention_bwd_f32": 0,
            "flash_attention_fwd_packed_f32": 0, "flash_attention_fwd_fusedheads_f32": 0}


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


_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_KV_TILE = 64


def attention_fwd_tiled_plain(q, k, v, rel_pos=None, m_init=float("-inf"), l_min=0.0):
    """(o, lse) by the arithmetic of the CUDA forward body
    (`csrc/attention_fwd.cuh`), step by step: 64-row KV tiles; scores in log2
    units (`scale * log2(e)` folded into one multiply, `exp2` for `exp`); the
    row max started at `m_init`; the row sum taken on the unrounded
    probabilities and clamped from below at `l_min`; the probabilities
    rounded to v's dtype for the P V product; the LSE converted back to
    natural units. `rel_pos` is SAM's decomposed bias `(bias_h, bias_w)`,
    (B, h, Lq, gh) and (B, h, Lq, gw) with Lk = gh * gw, added unscaled in
    f32 (times log2(e), as every score). `(-inf, 0)` is the plain softmax;
    the head-packed kernel runs `(-1e30, 1e-30)`. q: (B, h, Lq, d), k/v:
    (B, h, Lk, d). This is the bf16 body's arithmetic; at float32 inputs it
    rounds nothing and is the one-pass function in 64-key tiles (the float32
    kernels' own steps, 3xTF32 products in 32-key tiles, are
    `attention_fwd_tc_plain`'s). The kernels are held to the one-pass plain
    versions; this one shows on the CPU that the body's steps give the same
    function."""
    lk, d = k.shape[2], q.shape[-1]
    scale_log2 = d ** -0.5 * _LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3], m_init, device=q.device, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, lk, _KV_TILE):
        k1 = min(k0 + _KV_TILE, lk)
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale_log2
        if rel_pos is not None:
            bias_h, bias_w = rel_pos
            cols = torch.arange(k0, k1, device=q.device)
            gw = bias_w.shape[-1]
            s = s + (bias_h.float()[..., cols // gw] + bias_w.float()[..., cols % gw]) * _LOG2E
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vf[:, :, k0:k1])
        m = m_new
    l = l.clamp_min(l_min)
    return (acc / l[..., None]).to(q.dtype), m * _LN2 + torch.log(l)


def attention_plain(q, k, v):
    """Materialized-probability attention (the JAX side's `_xla_attention`):
    f32 scores and softmax, probabilities rounded to v's dtype for the AV
    product, f32 accumulation."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def head_pack(d: int) -> int:
    """Heads per group of the packed forward: as many as fit 128 lanes, at
    most 3 (the reference's `_head_pack`)."""
    return max(1, min(3, 128 // d))


_PACKED_KV_CHUNK = 512


def attention_fwd_packed_plain(q, k, v):
    """(o, lse) as `attention_fwd_plain`, by the packed kernel's arithmetic:
    heads in groups of `head_pack(d)` (the last group short, its padding
    heads never computed), an online softmax over 512-row KV chunks with the
    row max started at -1e30 and the denominator clamped at 1e-30, the
    probabilities rounded to v's dtype for the AV product."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    pack = head_pack(d)
    scale = d ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    for h0 in range(0, h, pack):
        heads = slice(h0, min(h0 + pack, h))
        qg, kg, vg = q[:, heads].float(), k[:, heads].float(), v[:, heads].float()
        m = torch.full(qg.shape[:3], -1e30, device=q.device, dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qg)
        for c0 in range(0, lk, _PACKED_KV_CHUNK):
            kc, vc = kg[:, :, c0:c0 + _PACKED_KV_CHUNK], vg[:, :, c0:c0 + _PACKED_KV_CHUNK]
            s = torch.matmul(qg, kc.transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(), vc)
            m = m_new
        l = l.clamp_min(1e-30)
        o[:, heads] = (acc / l[..., None]).to(q.dtype)
        lse[:, heads] = m + torch.log(l)
    return o, lse


def split_heads(x, heads: int):
    """(B, L, heads * d) -> the (B, heads, L, d) view, no copy."""
    b, l, hd = x.shape
    return x.reshape(b, l, heads, hd // heads).transpose(1, 2)


def merge_heads(x):
    """(B, heads, L, d) -> (B, L, heads * d)."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def attention_fwd_fusedheads_plain(qf, kf, vf, heads: int):
    """(o, lse) on the projection layout: qf (B, Lq, heads * d), kf/vf
    (B, Lk, heads * d) -> o (B, Lq, heads * d) in qf's dtype and lse
    (B, heads, Lq) f32. Per head: f32 scores, row max, exp, the sum and the
    AV product in f32, divided by the sum (the fused-heads kernel's
    arithmetic)."""
    q, k, v = (split_heads(t, heads).float() for t in (qf, kf, vf))
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    o = torch.matmul(p, v) / denom
    return merge_heads(o).to(qf.dtype), (m + torch.log(denom))[..., 0]


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


def bwd_q_step(d: int) -> int:
    """q rows a step of the backward's dK/dV walk at head dim d (`bwd_bq` in
    `csrc/flash_bwd.cu`: 64 up to the padded head dim 80, 32 above)."""
    return 64 if d <= 80 else 32


def attention_bwd_tiled_plain(q, k, v, lse, o, do):
    """(dq, dk, dv) by the arithmetic of the bf16 CUDA backward
    (`csrc/flash_bwd.cu`), step by step: delta = rowsum(dO * O) in f32;
    scores in log2 units, p = exp2(s * scale * log2(e) - lse * log2(e)) (the
    LSE is in natural units); dS = p (dP - delta) scale in f32; p and dS
    rounded to the inputs' dtype for the products that read them, every sum
    in f32; dV and dK summed over q steps of `bwd_q_step(d)` rows (the dK/dV
    kernel's walk), dQ over 64-row KV tiles (the dQ kernel's walk); the
    outputs rounded once. q: (B, h, Lq, d), k/v: (B, h, Lk, d), lse (B, h,
    Lq). The kernel's masks (p = 0 for keys >= Lk and q rows >= Lq) have no
    counterpart here: the tensors have no such rows. At float32 inputs it
    rounds nothing and is the one-pass function in these tiles; the float32
    backward's own steps (3xTF32 products, its tiles) are
    `attention_bwd_tc_plain`'s. The kernel is held to `attention_bwd_plain`;
    this one shows on the CPU that its steps give the same function."""
    lq, lk, d = q.shape[2], k.shape[2], q.shape[-1]
    scale = d ** -0.5
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    delta = (gf * of).sum(-1)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp2(s * (scale * _LOG2E) - (lse.float() * _LOG2E)[..., None])
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    p_r, ds_r = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.zeros_like(qf)
    for k0 in range(0, lk, _KV_TILE):
        dq = dq + torch.matmul(ds_r[..., k0:k0 + _KV_TILE], kf[:, :, k0:k0 + _KV_TILE])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    step = bwd_q_step(d)
    for q0 in range(0, lq, step):
        rows = slice(q0, q0 + step)
        dv = dv + torch.matmul(p_r[:, :, rows].transpose(-1, -2), gf[:, :, rows])
        dk = dk + torch.matmul(ds_r[:, :, rows].transpose(-1, -2), qf[:, :, rows])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_round(x):
    """float32 rounded to TF32 as `cvt.rna.tf32.f32` does: to nearest, ties
    away from zero, the 13 low mantissa bits cleared (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def matmul_3xtf32(a, b):
    """a @ b as the float32 tensor-core kernels take it (3xTF32): each
    operand split into big = tf32(x) and small = tf32(x - big), the product
    summed in float32 as small_a big_b + big_a small_b + big_a big_b (the
    small_a small_b term, below 2^-22 of the product, dropped). Each partial
    product of two TF32 values is exact in float32."""
    a_big, b_big = tf32_round(a), tf32_round(b)
    a_small, b_small = tf32_round(a.float() - a_big), tf32_round(b.float() - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


# Tiles of the float32 tensor-core kernels (`csrc/attention_f32_tc.cuh`),
# which set the order of their sums: every float32 forward (kernels 1, 3, 4
# and 5) walks 32-key tiles over `f32_tc_fwd_kv_groups` warp groups, the dQ
# kernel tiles of `f32_tc_dq_kv_tile(d)` keys over `f32_tc_dq_kv_groups`
# groups, the dK/dV kernel q as `f32_tc_dkdv_walk` says.
F32_TC_FWD_KV_TILE = 32
_SMS = 132  # a grid below this many blocks splits its work further (kTcSplitBelow)


def f32_tc_fwd_kv_groups(batch: int, heads: int, lq: int, lk: int, d: int) -> int:
    """Warp groups that split a float32 forward's KV tiles over batch * heads
    heads (`tc_fwd_kv_groups`; the per-head, head-packed and SAM kernels pass
    batch 1 and B * heads): 1 where its grid of 32-row q tiles holds 132
    blocks or more, at Lq > 256 (64-row tiles), above head dim 160 and for one
    tile; else 4 for up to 4 tiles above head dim 80, else 2. Group w takes
    tiles w, w + groups, ... with its own online softmax; group 0 merges the
    others in order."""
    tiles = -(-lk // F32_TC_FWD_KV_TILE)
    if -(-lq // 32) * heads * batch >= _SMS or lq > 256 or d > 160 or tiles == 1:
        return 1
    return 4 if tiles <= 4 and d > 80 else 2


def f32_tc_dq_kv_groups(bh: int, lq: int, lk: int, d: int) -> int:
    """Warp groups that split the float32 dQ kernel's KV tiles
    (`tc_dq_kv_groups`), as the forward's: 1 where its grid of 32-row q
    tiles holds 132 blocks or more, outside head dims 81 to 160 (64-row q
    tiles up to 80) and for one tile; else 4 for up to 4 tiles, else 2. The
    groups' partial dQ are added in group order."""
    tiles = -(-lk // f32_tc_dq_kv_tile(d))
    if -(-lq // 32) * bh >= _SMS or d <= 80 or d > 160 or tiles == 1:
        return 1
    return 4 if tiles <= 4 else 2


def f32_tc_dq_kv_tile(d: int) -> int:
    """Keys a KV tile of the float32 dQ kernel (`tc_dq_bk`): 32 up to the
    padded head dim 80, 16 above."""
    return 32 if d <= 80 else 16


def f32_tc_dkdv_walk(lq: int, lk: int, d: int, bh: int) -> tuple[int, int]:
    """(q rows a warp takes a step, warps splitting the q walk) of the
    float32 dK/dV kernel at batch*heads `bh` (`TcDkdvWide` / `TcDkdvSplit`):
    the wide shape (64 keys a block up to the padded head dim 80, 32 above;
    32 or 16 q rows a step) where its grid holds 132 blocks or more,
    else 16 keys a block with 4 (2 above head dim 80) warps over 16-row
    slices, their partial sums added in warp order."""
    if -(-lk // (64 if d <= 80 else 32)) * bh >= _SMS:
        return (32 if d <= 80 else 16), 1
    return 16, (4 if d <= 80 else 2)


def attention_fwd_tc_plain(q, k, v, rel_pos=None, m_init=float("-inf"), l_min=0.0):
    """(o, lse) by the arithmetic of the float32 forward kernels
    (`csrc/attention_f32_tc.cuh`: kernels 1, 3, 4 and 5 at float32), step by
    step: per head, 32-key tiles dealt to `f32_tc_fwd_kv_groups(1, B * h, Lq,
    Lk, d)` groups; in each group scores by `matmul_3xtf32` in log2 units
    (`scale * log2(e)` folded into one multiply), `rel_pos` (SAM's
    `(bias_h, bias_w)`, (B, h, Lq, gh) and (B, h, Lq, gw) with Lk = gh * gw)
    added unscaled times log2(e), an online softmax from `m_init` with
    `exp2`, O += P V by `matmul_3xtf32` on the unrounded probabilities; the
    groups' (m, l, O) merged in group order; the denominator clamped from
    below at `l_min`; O times 1 / l; the LSE in natural units. `(-inf, 0)` is
    kernels 1, 4 and 5; the head-packed kernel 3 runs `(-1e30, 1e-30)`.
    q: (B, h, Lq, d), k/v: (B, h, Lk, d), float32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale_log2 = d ** -0.5 * _LOG2E
    qf, kf, vf = q.float(), k.float(), v.float()
    groups = f32_tc_fwd_kv_groups(1, b * h, lq, lk, d)
    states = []
    for w in range(groups):
        m = torch.full((b, h, lq), m_init, device=q.device, dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for k0 in range(w * F32_TC_FWD_KV_TILE, lk, groups * F32_TC_FWD_KV_TILE):
            tile = slice(k0, k0 + F32_TC_FWD_KV_TILE)
            s = matmul_3xtf32(qf, kf[:, :, tile].transpose(-1, -2)) * scale_log2
            if rel_pos is not None:
                bias_h, bias_w = rel_pos
                cols = torch.arange(k0, min(k0 + F32_TC_FWD_KV_TILE, lk), device=q.device)
                gw = bias_w.shape[-1]
                s = s + (bias_h.float()[..., cols // gw] + bias_w.float()[..., cols % gw]) * _LOG2E
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + matmul_3xtf32(p, vf[:, :, tile])
            m = m_new
        states.append((m, l, acc))
    m, l, acc = states[0]
    for m_w, l_w, acc_w in states[1:]:
        m_new = torch.maximum(m, m_w)
        a, b_ = torch.exp2(m - m_new), torch.exp2(m_w - m_new)
        l, acc, m = l * a + l_w * b_, acc * a[..., None] + acc_w * b_[..., None], m_new
    l = l.clamp_min(l_min)
    return (acc * (1.0 / l)[..., None]).to(q.dtype), m * _LN2 + torch.log(l)


def attention_fwd_fusedheads_tc_plain(qf, kf, vf, heads: int):
    """(o, lse) by the arithmetic of the float32 fused-heads kernel: per head
    of the projection layout, `attention_fwd_tc_plain`'s steps from
    `(-inf, 0)`. Shapes as `attention_fwd_fusedheads_plain`."""
    o, lse = attention_fwd_tc_plain(*(split_heads(t, heads) for t in (qf, kf, vf)))
    return merge_heads(o).to(qf.dtype), lse


def attention_bwd_tc_plain(q, k, v, lse, o, do):
    """(dq, dk, dv) by the arithmetic of the float32 backward
    (`csrc/attention_f32_tc.cuh`), step by step: delta = rowsum(dO * O);
    p = exp2(s * scale * log2(e) - lse * log2(e)); dS = p (dP - delta) scale;
    every product by `matmul_3xtf32` (S, dP, dQ += dS K over KV tiles of
    `f32_tc_dq_kv_tile(d)` keys dealt to `f32_tc_dq_kv_groups` groups, their
    partial dQ added in group order; S^T = K Q^T, dP^T = V dO^T, dV += P^T dO,
    dK += dS^T Q over the q slices of `f32_tc_dkdv_walk`, one partial sum a
    warp, the partials added in warp order). Shapes as `attention_bwd_plain`;
    float32."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    scale = d ** -0.5
    scale_log2 = scale * _LOG2E
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, o, do))
    lse2 = lse.float() * _LOG2E
    delta = (gf * of).sum(-1)
    step = f32_tc_dq_kv_tile(d)
    groups = f32_tc_dq_kv_groups(b * h, lq, lk, d)
    dq = torch.zeros_like(qf)
    for w in range(groups):
        dq_w = torch.zeros_like(qf)
        for k0 in range(w * step, lk, groups * step):
            kt, vt = kf[:, :, k0:k0 + step], vf[:, :, k0:k0 + step]
            p = torch.exp2(matmul_3xtf32(qf, kt.transpose(-1, -2)) * scale_log2
                           - lse2[..., None])
            ds = p * (matmul_3xtf32(gf, vt.transpose(-1, -2)) - delta[..., None]) * scale
            dq_w = dq_w + matmul_3xtf32(ds, kt)
        dq = dq_w if w == 0 else dq + dq_w
    qs, qw = f32_tc_dkdv_walk(lq, lk, d, b * h)
    parts = [(torch.zeros_like(kf), torch.zeros_like(vf)) for _ in range(qw)]
    for i, q0 in enumerate(range(0, lq, qs)):
        rows = slice(q0, q0 + qs)
        qt, gt = qf[:, :, rows], gf[:, :, rows]
        pt = torch.exp2(matmul_3xtf32(kf, qt.transpose(-1, -2)) * scale_log2
                        - lse2[:, :, None, rows])
        dst = pt * (matmul_3xtf32(vf, gt.transpose(-1, -2)) - delta[:, :, None, rows]) * scale
        dk_w, dv_w = parts[i % qw]
        parts[i % qw] = (dk_w + matmul_3xtf32(dst, qt), dv_w + matmul_3xtf32(pt, gt))
    dk, dv = parts[0]
    for dk_w, dv_w in parts[1:]:
        dk, dv = dk + dk_w, dv + dv_w
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


def _fwd5_lib(source: str, entry: str):
    """An entry point (q, k, v, o, lse, batch, heads, lq, lk, d, stream)."""
    fn = getattr(buildlib.library(source), entry)
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 5 + [_INT] * 5 + [_PTR]
        fn.restype = _INT
    return fn


def _bwd_lib():
    lib = buildlib.library("flash_bwd")
    fn = lib.lmdx_flash_bwd
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 10 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    return fn


def _bwd_sm90(d: int) -> bool:
    """Whether the bf16 backward's entry takes the warpgroup-MMA kernels at
    head dim d (the choice is the library's, by head dim alone)."""
    fn = buildlib.library("flash_bwd").lmdx_flash_bwd_sm90
    if fn.argtypes is None:
        fn.argtypes = [_INT]
        fn.restype = _INT
    return fn(d) == 1


def _fwd_f32_lib():
    fn = buildlib.library("attention_f32").lmdx_flash_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 5 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    return fn


def _bwd_f32_lib():
    fn = buildlib.library("attention_f32").lmdx_flash_bwd_f32
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 10 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    return fn


# The per-head kernels by q's dtype: (forward, backward, LAUNCHES keys).
_KERNELS = {torch.bfloat16: (_fwd_lib, _bwd_lib, "flash_attention_fwd", "flash_attention_bwd"),
            torch.float32: (_fwd_f32_lib, _bwd_f32_lib, "flash_attention_fwd_f32",
                            "flash_attention_bwd_f32")}
# The head-packed and fused-heads kernels by q's dtype: (source, entry point,
# LAUNCHES key).
_PACKED = {torch.bfloat16: ("flash_fwd_packed", "lmdx_flash_fwd_packed",
                            "flash_attention_fwd_packed"),
           torch.float32: ("attention_f32", "lmdx_flash_fwd_packed_f32",
                           "flash_attention_fwd_packed_f32")}
_FUSEDHEADS = {torch.bfloat16: ("flash_fwd_fusedheads", "lmdx_flash_fwd_fusedheads",
                                "flash_attention_fwd_fusedheads"),
               torch.float32: ("attention_f32", "lmdx_flash_fwd_fusedheads_f32",
                               "flash_attention_fwd_fusedheads_f32")}


def _check_cuda(named: dict, like: torch.Tensor, dtype) -> None:
    for name, t in named.items():
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, expected {like.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_qkv(q, k, v) -> tuple[int, int, int, int, int]:
    """Shapes of (B, heads, L, head_dim) q, k, v on one device, all bf16 or
    all float32, contiguous; returns (B, heads, Lq, Lk, head_dim)."""
    if q.dtype not in _KERNELS:
        raise ValueError(f"q has dtype {q.dtype}; the kernels take torch.bfloat16 or "
                         "torch.float32")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, heads, L, head_dim)")
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if d > 256 or b * h > 65535:
        raise ValueError(f"head_dim {d} / batch*heads {b * h} outside the kernel")
    _check_cuda({"q": q, "k": k, "v": v}, q, q.dtype)
    return b, h, lq, lk, d


def _stream(t: torch.Tensor) -> _PTR:
    return _PTR(torch.cuda.current_stream(t.device).cuda_stream)


def _check_cpu_dtypes(named: dict) -> None:
    """The CPU path takes what the card does: one dtype for all of `named`."""
    dtypes = {t.dtype for t in named.values()}
    if len(dtypes) != 1:
        raise ValueError("mixed dtypes " + ", ".join(f"{n} {t.dtype}" for n, t in named.items()))


def flash_attention_fwd(q, k, v):
    """(o, lse) of attention; for CUDA tensors the kernel of q's dtype (bf16:
    `csrc/flash_fwd.cu`; float32: `csrc/attention_f32.cu`), for CPU tensors
    the plain version. k and v must have q's dtype."""
    if q.device.type == "cpu":
        _check_cpu_dtypes({"q": q, "k": k, "v": v})
        return attention_fwd_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv(q, k, v)
    fwd_lib, _, key, _ = _KERNELS[q.dtype]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    rc = fwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), b * h, lq, lk, d, _stream(q))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return o, lse


def flash_attention_fwd_packed(q, k, v):
    """(o, lse) of attention from the head-packed reference's start values;
    for CUDA tensors the kernel of q's dtype (one head a block; bf16:
    `csrc/flash_fwd_packed.cu`, float32: `csrc/attention_f32.cu`), for CPU
    tensors the plain version (heads in groups of `head_pack(head_dim)`)."""
    if q.device.type == "cpu":
        _check_cpu_dtypes({"q": q, "k": k, "v": v})
        return attention_fwd_packed_plain(q, k, v)
    b, h, lq, lk, d = _check_qkv(q, k, v)
    source, entry, key = _PACKED[q.dtype]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    rc = _fwd5_lib(source, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b, h, lq, lk, d, _stream(q))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return o, lse


def flash_attention_fwd_fusedheads(qf, kf, vf, heads: int):
    """(o, lse) of attention on the projection layout (B, L, heads * d); for
    CUDA tensors the kernel of qf's dtype (bf16:
    `csrc/flash_fwd_fusedheads.cu`, float32: `csrc/attention_f32.cu`), for
    CPU tensors the plain version. kf and vf must have qf's dtype."""
    if qf.device.type == "cpu":
        _check_cpu_dtypes({"qf": qf, "kf": kf, "vf": vf})
        return attention_fwd_fusedheads_plain(qf, kf, vf, heads)
    if qf.dim() != 3 or kf.dim() != 3 or vf.dim() != 3:
        raise ValueError("qf, kf, vf must be (B, L, heads * head_dim)")
    b, lq, hd = qf.shape
    lk = kf.shape[1]
    if kf.shape != (b, lk, hd) or vf.shape != kf.shape:
        raise ValueError(f"shape mismatch qf {tuple(qf.shape)} kf {tuple(kf.shape)} "
                         f"vf {tuple(vf.shape)}")
    if hd % heads or hd // heads > 256 or b > 65535 or heads > 65535:
        raise ValueError(f"width {hd} / heads {heads} / batch {b} outside the kernel")
    if qf.dtype not in _FUSEDHEADS:
        raise ValueError(f"qf has dtype {qf.dtype}; the kernels take torch.bfloat16 or "
                         "torch.float32")
    _check_cuda({"qf": qf, "kf": kf, "vf": vf}, qf, qf.dtype)
    source, entry, key = _FUSEDHEADS[qf.dtype]
    o = torch.empty_like(qf)
    lse = torch.empty((b, heads, lq), device=qf.device, dtype=torch.float32)
    rc = _fwd5_lib(source, entry)(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), b, heads, lq, lk, hd // heads, _stream(qf))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    return o, lse


def flash_attention_bwd(q, k, v, lse, o, do):
    """(dq, dk, dv) of attention from the forward's lse and o; for CUDA tensors
    the kernels of q's dtype (bf16: `csrc/flash_bwd.cu`, which runs those of
    `csrc/flash_bwd_sm90.cuh` at head dims 8-48 and 72-80 in steps of 8;
    float32: `csrc/attention_f32.cu`), for CPU tensors the plain version. k,
    v, o and do must have q's dtype, lse is float32."""
    if q.device.type == "cpu":
        _check_cpu_dtypes({"q": q, "k": k, "v": v, "o": o, "do": do})
        return attention_bwd_plain(q, k, v, lse, o, do)
    b, h, lq, lk, d = _check_qkv(q, k, v)
    _, bwd_lib, _, key = _KERNELS[q.dtype]
    _check_cuda({"o": o, "do": do}, q, q.dtype)
    _check_cuda({"lse": lse}, q, torch.float32)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, lq):
        raise ValueError("o/do must match q and lse must be (B, heads, Lq)")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, lq), device=q.device, dtype=torch.float32)
    rc = bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   b * h, lq, lk, d, _stream(q))
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1
    if q.dtype == torch.bfloat16 and _bwd_sm90(d):
        LAUNCHES["flash_attention_bwd_sm90"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose gradient is the flash backward (the port of
    `_flash_attention_ad`'s custom VJP). `packed` takes the head-packed
    forward; the backward is the same."""

    @staticmethod
    def forward(ctx, q, k, v, packed=False):
        fwd = flash_attention_fwd_packed if packed else flash_attention_fwd
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, lse, o, do.contiguous()), None)


class FusedHeadsAttention(torch.autograd.Function):
    """Attention on the projection layout (the port of `_fusedheads_ad`). The
    backward runs only inside guidance iterations; it splits heads (one
    contiguous copy of each saved tensor) and reuses the per-head flash
    backward, as `_fusedheads_bwd` does."""

    @staticmethod
    def forward(ctx, qf, kf, vf, heads):
        o, lse = flash_attention_fwd_fusedheads(qf, kf, vf, heads)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.heads = heads
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        q, k, v, o4, g = (split_heads(t, ctx.heads).contiguous()
                          for t in (qf, kf, vf, o, do))
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, o4, g)
        return merge_heads(dq), merge_heads(dk), merge_heads(dv), None


_KERNEL_BUDGET = 12 * 1024 * 1024


def kernel_supported(q, k) -> bool:
    """The JAX dispatch gate `_kernel_supported`: KV >= 256 tokens,
    head_dim <= 256, Lq >= 8, and the reference's size rule on KV rounded up
    to 128 rows. Shorter KV (the 77-token cross-attention, the 64-token mid
    block) stays on plain math, as on the JAX side. The size rule is the
    reference's dispatch (what its backward could hold on chip, in f32), kept
    so that the two packages send the same layers to the same kernels; it is
    no limit of the CUDA kernels, which tile KV. Every SD1.x shape at 512x512
    passes it (the largest is 4126 keys at head_dim 40); at 768x768 the
    9216-key self-attention at head_dim 40 does not, and runs plain math."""
    lq, d = q.shape[-2:]
    lk = k.shape[2]
    if d > 256 or lq < 8 or lk < 256:
        return False
    lk_pad = -(-lk // 128) * 128
    return (4 * 128 * lk_pad * 4 + 2 * lk_pad * d * 4 + 6 * 128 * d * 4) < _KERNEL_BUDGET


_FUSEDHEADS_BUDGET = 11 * 1024 * 1024


def fusedheads_supported(qf, kf, heads: int) -> bool:
    """The JAX gate `_fusedheads_supported` without its environment switch:
    head_dim a multiple of 8 and <= 256, Lq >= 8, and the reference's size
    rule on KV rounded up to 128 rows. The size rule is the reference's
    dispatch (what its kernel could hold on chip), kept so that the two
    packages send the same layers to the same kernels; it is no limit of the
    CUDA kernel, which tiles KV. At bf16 it passes every 77-token
    cross-attention and the self and fuser attention of the 1024-, 256- and
    64-token levels, and refuses the 4096-token ones. At float32 (K/V counted
    at 4 bytes) it refuses the 1024-token self and fuser attention too, which
    then take the per-head gate."""
    _, lq, hd = qf.shape
    lk = kf.shape[1]
    d = hd // heads
    if hd % heads or d % 8 or d > 256 or lq < 8:
        return False
    lk_pad = -(-lk // 128) * 128
    itemsize = qf.element_size()
    return (2 * 128 * lk_pad * 4 + 4 * lk_pad * hd * itemsize
            + 4 * 128 * hd * itemsize) < _FUSEDHEADS_BUDGET


def flash_attention(q, k, v, packed: bool = False):
    """Fused attention over (B, heads, L, head_dim) tensors, differentiable;
    callers check `kernel_supported` first."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), packed)


def flash_attention_hd(qf, kf, vf, heads: int, options: KernelOptions = KernelOptions()):
    """Fused attention on projection-layout (B, L, heads * head_dim) tensors,
    differentiable: the fused-heads kernel where `fusedheads_supported`
    holds, else split heads -> per-head flash kernel (`kernel_supported`) or
    plain math -> merge."""
    if fusedheads_supported(qf, kf, heads):
        return FusedHeadsAttention.apply(qf.contiguous(), kf.contiguous(),
                                         vf.contiguous(), heads)
    q, k, v = (split_heads(t, heads) for t in (qf, kf, vf))
    if kernel_supported(q, k):
        return merge_heads(flash_attention(q, k, v, packed=options.packed_attention))
    return merge_heads(attention_plain(q, k, v))
