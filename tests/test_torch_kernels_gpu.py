"""The port's CUDA kernels (flash attention forward and backward, the
head-packed and fused-heads forwards, SAM attention, GroupNorm's pair-stats
reduction) against their plain PyTorch versions, on the card. Marked
`gpu`: they skip where no CUDA device is present. On a machine with the
card (and without JAX, which the repo's root conftest imports), run them
with

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: the kernels round p and dS to bf16 for the tensor-core products
and write bf16 outputs, the plain versions compute in f32 from the same bf16
inputs. Each output is held to max|kernel - plain| <= 2e-2 * max|plain|
(a few bf16 ulps of the largest entry); the f32 LSE to 1e-3 absolute; the
f32 sums of pair_stats to 1e-3 * max|plain| (f32 sums in another order).
The float32 forms of the flash forward, its backward and SAM attention
(`csrc/attention_f32.cu`) keep everything in float32: each output within
1e-4 * max|plain| and the LSE within 1e-4 (f32 sums in another order and
ex2.approx for exp; every product in 3xTF32, which drops terms below 2^-22
of a product; TF32 off for the plain versions' products).
"""

import numpy as np
import pytest
import torch

from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import group_norm as gn
from lmdx_torch.nn.kernels import sam_attention as sa

pytestmark = pytest.mark.gpu

SHAPES = [
    # (batch*heads, Lq, Lk, d): main-path levels, aligned and fuser KV
    (16, 256, 256, 160),
    (16, 256, 286, 160),
    (16, 1024, 1054, 80),
    (8, 4096, 4126, 40),
    (32, 4096, 4096, 40),   # LMD's per-box guidance: 4 boxes x 8 heads
    # single-image guidance: batch 1 x 8 heads, KV = L and the fuser's L + 30
    (8, 4096, 4096, 40),
    (8, 1024, 1024, 80),
    (8, 1024, 1054, 80),
    (8, 256, 256, 160),
    (8, 256, 286, 160),
    (2, 100, 300, 32),      # ragged q and kv tails
    (3, 100, 300, 20),      # head dim not a multiple of 8: element-wise loads
    (4, 8, 300, 40),        # Lq = 8: half of a warp's 16 rows
    (4, 100, 30, 40),       # KV shorter than one tile
    (4, 70, 77, 64),        # KV shorter than two tiles
    (2, 130, 200, 256),     # the general head-dim instantiation
    (2, 130, 200, 96),      # head dim between two instantiated widths
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def no_tf32(cuda):
    """Full float32 products for the plain versions the float32 kernels are
    held to."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _inputs(bh, lq, lk, d, device, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=device, dtype=dtype)

    return mk(1, bh, lq, d), mk(1, bh, lk, d), mk(1, bh, lk, d), mk(1, bh, lq, d)


def _close(got, want, rel=2e-2):
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * max(want.float().abs().max().item(), 1e-6)
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_forward_matches_plain(cuda, bh, lq, lk, d):
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


# The SDXL refiner's self-attention at head dim 64: CFG batch 2 x 12 heads at
# 4096 tokens, x 24 heads at 1024 and at 256 tokens (no UNet of SD1.x has d 64).
REFINER_SHAPES = [(24, 4096, 4096, 64), (48, 1024, 1024, 64), (48, 256, 256, 64)]


@pytest.mark.parametrize("bh,lq,lk,d", REFINER_SHAPES)
def test_forward_at_the_refiner_head_dim_matches_plain(cuda, bh, lq, lk, d):
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=2)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


# SD2.1 base at head dim 64 (5, 10 and 20 heads at 4096, 1024 and 256
# tokens): the backward at LMD's guidance batches (the per-box guidance of 3
# boxes and batch 1), the forward also at a 3-box layout's per-box pass
# (3 x CFG); the SDXL base's self-attention (CFG batch 2 x 10 heads at 4096
# tokens, x 20 at 1024).
D64_BWD_SHAPES = [(15, 4096, 4096, 64), (30, 1024, 1024, 64), (60, 256, 256, 64),
                  (5, 4096, 4096, 64), (10, 1024, 1024, 64), (20, 256, 256, 64)]
D64_FWD_SHAPES = [(30, 4096, 4096, 64), (60, 1024, 1024, 64), (120, 256, 256, 64),
                  (20, 4096, 4096, 64), (40, 1024, 1024, 64)]


@pytest.mark.parametrize("bh,lq,lk,d", D64_FWD_SHAPES)
def test_forward_at_sd21_and_sdxl_base_shapes_matches_plain(cuda, bh, lq, lk, d):
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=6)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("bh,lq,lk,d", D64_BWD_SHAPES)
def test_backward_at_sd21_shapes_matches_plain(cuda, bh, lq, lk, d):
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=7)
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bh,lq,lk,d", SHAPES)
def test_backward_matches_plain(cuda, bh, lq, lk, d):
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=1)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w)


def _shifted(t, elements=1):
    """A contiguous copy of `t` whose storage starts `elements` past an
    allocation: its pointer is not a multiple of 16 bytes."""
    buf = torch.empty(t.numel() + elements, device=t.device, dtype=t.dtype)
    out = buf[elements:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("which", ["q", "kv", "all"])
@pytest.mark.parametrize("bh,lq,lk,d", [(4, 100, 300, 40), (2, 256, 286, 160)])
def test_forward_takes_pointers_off_16_bytes(cuda, bh, lq, lk, d, which):
    """The 16-byte cp.async path needs aligned rows; a tensor that starts 2
    bytes into an allocation takes the element-wise loads and gives the same
    result, bit for bit."""
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=7)
    o_ref, lse_ref = fa.flash_attention_fwd(q, k, v)
    if which in ("q", "all"):
        q = _shifted(q)
    if which in ("kv", "all"):
        k, v = _shifted(k), _shifted(v)
    o, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


@pytest.mark.parametrize("bh,lq,lk,d", [(8, 4096, 4126, 40), (16, 256, 286, 160),
                                        (3, 100, 300, 20), (24, 4096, 4096, 64)])
def test_forward_is_bit_equal_from_run_to_run(cuda, bh, lq, lk, d):
    """One owner per output element and a fixed order of sums: no atomics."""
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=8)
    o1, lse1 = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_forward_matches_the_tiled_plain_more_closely_than_the_one_pass_plain(cuda):
    """`attention_fwd_tiled_plain` repeats the body's arithmetic (tiles, exp2,
    bf16 P), so only O's last rounding and the order of f32 sums differ: the
    LSE agrees to 1e-4 and O to one bf16 ulp of the largest entry."""
    q, k, v, _ = _inputs(4, 200, 300, 40, cuda, seed=9)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_tiled_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, o_ref, rel=2 ** -7)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("bh,lq,lk,d", [(16, 4096, 77, 40), (16, 64, 64, 160),
                                        (16, 64, 94, 160)])
def test_backward_at_short_kv_matches_plain(cuda, bh, lq, lk, d):
    """The KV lengths the fused-heads gradient gives the backward: one or two
    KV tiles, most of the second masked."""
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=12)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("bh,lq,lk,d", [(8, 4096, 4126, 40), (16, 256, 286, 160)])
def test_backward_is_bit_equal_from_run_to_run(cuda, bh, lq, lk, d):
    """Each of dQ, dK, dV has one owner block and a fixed order of sums: no
    atomics."""
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=13)
    o, lse = fa.flash_attention_fwd(q, k, v)
    first = fa.flash_attention_bwd(q, k, v, lse, o, do)
    second = fa.flash_attention_bwd(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("which", ["q", "kv", "o_do", "all"])
@pytest.mark.parametrize("bh,lq,lk,d", [(4, 100, 300, 40), (2, 256, 286, 160)])
def test_backward_takes_pointers_off_16_bytes(cuda, bh, lq, lk, d, which):
    """Tensors that start off 16 bytes (as `.contiguous()` views may) take the
    element-wise loads and give the same dQ, dK, dV, bit for bit."""
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=14)
    o, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_bwd(q, k, v, lse, o, do)
    if which in ("q", "all"):
        q = _shifted(q)
    if which in ("kv", "all"):
        k, v = _shifted(k), _shifted(v)
    if which in ("o_do", "all"):
        o, do = _shifted(o), _shifted(do)
    if which == "all":
        lse = _shifted(lse)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_backward_matches_the_tiled_plain_more_closely_than_the_one_pass_plain(cuda):
    """`attention_bwd_tiled_plain` repeats the kernels' arithmetic (exp2, p and
    dS rounded to bf16 for the products, the q steps and KV tiles), so only
    the outputs' last rounding and the order of f32 sums differ: each output
    within one bf16 ulp of its largest entry, and closer on average than the
    one-pass plain version, which keeps p and dS in f32."""
    q, k, v, do = _inputs(4, 200, 300, 40, cuda, seed=15)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    tiled = fa.attention_bwd_tiled_plain(q, k, v, lse, o, do)
    plain = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    for g, t, p in zip(got, tiled, plain):
        _close(g, t, rel=2 ** -7)
        err_t = (g.float() - t.float()).abs().mean().item()
        err_p = (g.float() - p.float()).abs().mean().item()
        assert err_t <= err_p, (err_t, err_p)


def test_wrapper_counts_and_rejects(cuda):
    q, k, v, _ = _inputs(2, 64, 256, 40, cuda)
    fa.reset_launch_counts()
    fa.flash_attention_fwd(q, k, v)
    assert fa.LAUNCHES["flash_attention_fwd"] == 1
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.float(), k, v)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    assert fa.LAUNCHES["flash_attention_fwd"] == 1
    assert fa.LAUNCHES["flash_attention_fwd_f32"] == 0


SAM_SHAPES = [
    # (batch*heads, gh, gw, d)
    (4, 14, 14, 64),        # one image's windows, few heads
    (6, 16, 13, 32),        # non-square grid, N = 208
    (1200, 14, 14, 64),     # main path: 4 images x 25 windows x 12 heads
    (48, 64, 64, 64),       # main path: global layers, 4 images x 12 heads
    (600, 14, 14, 64),      # one 2-box layout: 2 images x 25 windows x 12 heads
    (24, 64, 64, 64),       # one 2-box layout: global layers, 2 images x 12 heads
    (2, 40, 6, 32),         # grid rows shorter than 8 keys, N = 240
    (2, 7, 30, 32),         # N = 210: two keys in the last tile
    (2, 4, 4, 128),         # the widest head the kernel takes, one short tile
]


def _sam_inputs(bh, gh, gw, d, device, seed=0):
    rng = np.random.default_rng(seed)
    n = gh * gw

    def mk(last, dtype):
        return torch.from_numpy(rng.standard_normal((1, bh, n, last), dtype=np.float32)).to(
            device=device, dtype=dtype)

    return (mk(d, torch.bfloat16), mk(d, torch.bfloat16), mk(d, torch.bfloat16),
            mk(gh, torch.float32), mk(gw, torch.float32))


@pytest.mark.parametrize("bh,gh,gw,d", SAM_SHAPES)
def test_sam_attention_matches_plain(cuda, bh, gh, gw, d):
    args = _sam_inputs(bh, gh, gw, d, cuda)
    got = sa.sam_attention(*args)
    want = sa.sam_attention_plain(*args)
    torch.cuda.synchronize()
    _close(got, want)


def test_sam_attention_is_bit_equal_from_run_to_run(cuda):
    args = _sam_inputs(24, 14, 14, 64, cuda, seed=10)
    first, second = sa.sam_attention(*args), sa.sam_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_sam_attention_matches_the_tiled_plain(cuda):
    q, k, v, bias_h, bias_w = _sam_inputs(4, 16, 13, 32, cuda, seed=11)
    got = sa.sam_attention(q, k, v, bias_h, bias_w)
    want, _ = fa.attention_fwd_tiled_plain(q, k, v, rel_pos=(bias_h, bias_w))
    torch.cuda.synchronize()
    _close(got, want, rel=2 ** -7)


def test_sam_wrapper_counts_and_rejects(cuda):
    q, k, v, bh_, bw_ = _sam_inputs(2, 14, 14, 64, cuda)
    sa.reset_launch_counts()
    sa.sam_attention(q, k, v, bh_, bw_)
    assert sa.LAUNCHES["sam_attention"] == 1
    with pytest.raises(ValueError):
        sa.sam_attention(q, k, v, bh_.to(torch.bfloat16), bw_)
    with pytest.raises(ValueError):
        sa.sam_attention(q, k, v, bw_, bh_[..., :13])   # grid does not match N
    assert sa.LAUNCHES["sam_attention"] == 1


PACKED_SHAPES = [
    # (batch, heads, Lq, Lk, d)
    (2, 8, 4096, 4126, 40),   # main path: pack 3, one padding head, fuser KV
    (4, 8, 256, 256, 40),     # pack 3, aligned
    (2, 5, 100, 300, 64),     # pack 2, one padding head, ragged q and kv tails
    (2, 8, 256, 286, 160),    # pack 1
]


@pytest.mark.parametrize("b,h,lq,lk,d", PACKED_SHAPES)
def test_packed_forward_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v, _ = (t.reshape(b, h, -1, d) for t in _inputs(b * h, lq, lk, d, cuda, seed=2))
    o, lse = fa.flash_attention_fwd_packed(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
    o_one, lse_one = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    _close(o, o_ref)
    _close(o, o_one)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert (lse - lse_one).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,h,lq,lk,d", [(1, 8, 4096, 4096, 40), (2, 8, 4096, 4126, 40)])
def test_packed_forward_equals_the_per_head_kernel(cuda, b, h, lq, lk, d):
    """One block per (q tile, head) on kernel 1's tile: the packed kernel's
    start values (-1e30, 1e-30) never bite on finite inputs, so O and LSE are
    kernel 1's bit for bit."""
    q, k, v, _ = (t.reshape(b, h, -1, d) for t in _inputs(b * h, lq, lk, d, cuda, seed=16))
    o, lse = fa.flash_attention_fwd_packed(q, k, v)
    o_one, lse_one = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o_one) and torch.equal(lse, lse_one)


FUSED_SHAPES = [
    # (batch, heads, Lq, Lk, d): cross (KV 77), self, fuser KV, the mid block
    (2, 8, 4096, 77, 40),
    (2, 8, 1024, 1054, 80),
    (4, 8, 256, 256, 160),
    (2, 8, 64, 94, 160),
    (2, 3, 100, 130, 24),     # ragged tails, head_dim not a multiple of 16
]


def _fused_inputs(b, h, lq, lk, d, device, seed=3):
    rng = np.random.default_rng(seed)

    def mk(L):
        return torch.from_numpy(rng.standard_normal((b, L, h * d), dtype=np.float32)).to(
            device=device, dtype=torch.bfloat16)

    return mk(lq), mk(lk), mk(lk), mk(lq)


@pytest.mark.parametrize("b,h,lq,lk,d", FUSED_SHAPES)
def test_fusedheads_forward_matches_plain(cuda, b, h, lq, lk, d):
    qf, kf, vf, _ = _fused_inputs(b, h, lq, lk, d, cuda)
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, h)
    torch.cuda.synchronize()
    assert o.shape == qf.shape and lse.shape == (b, h, lq)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("b,h,lq,lk,d", FUSED_SHAPES[:4])
def test_fusedheads_autograd_matches_plain_backward(cuda, b, h, lq, lk, d):
    """`FusedHeadsAttention`'s backward (head split + flash backward, here at
    KV 77 and 94 too) against the plain backward on split heads."""
    qf, kf, vf, g = _fused_inputs(b, h, lq, lk, d, cuda, seed=4)
    ins = [t.clone().requires_grad_(True) for t in (qf, kf, vf)]
    fa.reset_launch_counts()
    out = fa.FusedHeadsAttention.apply(*ins, h)
    out.backward(g)
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads"] == 1
    assert fa.LAUNCHES["flash_attention_bwd"] == 1
    q, k, v, o4, g4 = (fa.split_heads(t, h).contiguous() for t in (qf, kf, vf, out.detach(), g))
    _, lse = fa.attention_fwd_plain(q, k, v)
    want = fa.attention_bwd_plain(q, k, v, lse, o4, g4)
    torch.cuda.synchronize()
    for t, w in zip(ins, want):
        _close(t.grad, fa.merge_heads(w))


STAT_SHAPES = [
    # (B, C, N, dtype): GroupNorm inputs of the main path, then ragged rows
    (8, 320, 4096, torch.bfloat16), (2, 2560, 64, torch.bfloat16),
    (4, 1920, 256, torch.float32), (2, 960, 1024, torch.float32),
    (3, 7, 1030, torch.bfloat16), (3, 7, 61, torch.float32),
]


@pytest.mark.parametrize("b,c,n,dtype", STAT_SHAPES)
@pytest.mark.parametrize("same", [True, False], ids=["x_x", "a_b"])
def test_pair_stats_matches_plain(cuda, b, c, n, dtype, same):
    rng = np.random.default_rng(5)

    def mk():
        return torch.from_numpy(rng.standard_normal((b, c, n), dtype=np.float32) + 0.5).to(
            device=cuda, dtype=dtype)

    a = mk()
    other = a if same else mk()
    got = gn.pair_stats(a, other)
    want = gn.pair_stats_plain(a, other)
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        assert g_.shape == (b, c) and g_.dtype == torch.float32
        _close(g_, w_, rel=1e-3)


def test_group_norm_fn_matches_autograd_through_group_norm(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 320, 16, 16), dtype=np.float32) * 2 + 0.5).to(
        device=cuda, dtype=torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal(320, dtype=np.float32) * 0.1 + 1).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(320, dtype=np.float32) * 0.1).to(cuda)
    g = torch.from_numpy(rng.standard_normal((2, 320, 16, 16), dtype=np.float32)).to(cuda)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    gn.reset_launch_counts()
    got = gn.GroupNormFn.apply(xs[0], w, bias, 32, 1e-5, True)
    got.backward(g)
    assert gn.LAUNCHES["pair_stats"] == 2
    want = torch.nn.functional.silu(
        torch.nn.functional.group_norm(xs[1].float(), 32, w, bias, 1e-5))
    want.backward(g)
    torch.cuda.synchronize()
    _close(got, want, rel=1e-4)
    _close(xs[0].grad, xs[1].grad)   # bf16 gradients: one rounding apart


def test_new_wrappers_count_and_reject(cuda):
    q, k, v, _ = _inputs(16, 64, 256, 40, cuda)
    q, k, v = (t.reshape(2, 8, -1, 40) for t in (q, k, v))
    fa.reset_launch_counts()
    gn.reset_launch_counts()
    fa.flash_attention_fwd_packed(q, k, v)
    assert fa.LAUNCHES["flash_attention_fwd_packed"] == 1
    assert fa.LAUNCHES["flash_attention_fwd"] == 0
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_packed(q.half(), k.half(), v.half())
    qf, kf, vf, _ = _fused_inputs(2, 8, 64, 77, 40, cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_fusedheads(qf, kf, vf, 7)           # 320 % 7
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_fusedheads(qf[:, :, :160], kf[:, :, :160], vf[:, :, :160], 4)
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads"] == 0
    a = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError):
        gn.pair_stats(a, a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        gn.pair_stats(a.half(), a.half())
    with pytest.raises(ValueError):
        gn.pair_stats(a.transpose(1, 2), a.transpose(1, 2))
    assert gn.LAUNCHES["pair_stats"] == 0


# ---- the float32 forms (csrc/attention_f32.cu) ---------------------------------

F32_SHAPES = [
    # (batch*heads, Lq, Lk, d): the shapes float32 LMD gives the kernels at
    # 512x512 (chip_smoke.py phase 9: per-box pass of a 3-box layout 3 x CFG x
    # 8 heads, its guidance 3 x 8, overall guidance 8) and the fuser's L + 30
    (48, 4096, 4096, 40),
    (24, 4096, 4096, 40),
    (8, 4096, 4126, 40),
    (24, 1024, 1024, 80),
    (8, 1024, 1054, 80),
    (24, 256, 256, 160),
    (8, 256, 286, 160),
    (2, 100, 300, 32),      # ragged q and kv tails
    (3, 100, 300, 20),      # head dim not a multiple of 8
    (4, 8, 300, 40),        # Lq = 8
    (4, 100, 30, 40),       # KV shorter than one tile
    (2, 130, 200, 256),     # the widest instantiation: 32-row q steps
    (2, 130, 200, 96),      # head dim between two instantiated widths
]


def _close_f32(got, want):
    assert got.dtype == torch.float32
    _close(got, want, rel=1e-4)


@pytest.mark.parametrize("bh,lq,lk,d", F32_SHAPES)
def test_f32_forward_matches_plain(no_tf32, bh, lq, lk, d):
    q, k, v, _ = _inputs(bh, lq, lk, d, no_tf32, seed=20, dtype=torch.float32)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd_f32"] == 1 and fa.LAUNCHES["flash_attention_fwd"] == 0
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("bh,lq,lk,d", F32_SHAPES)
def test_f32_backward_matches_plain(no_tf32, bh, lq, lk, d):
    q, k, v, do = _inputs(bh, lq, lk, d, no_tf32, seed=21, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd_f32"] == 1 and fa.LAUNCHES["flash_attention_bwd"] == 0
    for g, w in zip(got, want):
        _close_f32(g, w)


@pytest.mark.parametrize("bh,lq,lk,d", D64_BWD_SHAPES)
def test_f32_kernels_at_sd21_shapes_match_plain(no_tf32, bh, lq, lk, d):
    """Kernels 1-f32 and 2-f32 at SD2.1's head dim 64 (its float32 LMD)."""
    q, k, v, do = _inputs(bh, lq, lk, d, no_tf32, seed=22, dtype=torch.float32)
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd_f32"] == fa.LAUNCHES["flash_attention_bwd_f32"] == 1
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for g, w in zip(got, want):
        _close_f32(g, w)


@pytest.mark.parametrize("bh,lq,lk,d", [(8, 4096, 4126, 40), (16, 256, 286, 160)])
def test_f32_kernels_are_bit_equal_from_run_to_run(cuda, bh, lq, lk, d):
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=22, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    first, second = (fa.flash_attention_bwd(q, k, v, lse, o, do) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_f32_autograd_runs_the_f32_kernels(no_tf32):
    """FlashAttention at float32: the forward and its gradient on the float32
    kernels, the gradient equal to autograd through the plain version."""
    q, k, v, do = _inputs(8, 256, 286, 40, no_tf32, seed=23, dtype=torch.float32)
    q, k, v = (t.reshape(1, 8, -1, 40).requires_grad_() for t in (q, k, v))
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v).backward(do.reshape(1, 8, -1, 40))
    assert fa.LAUNCHES["flash_attention_fwd_f32"] == 1
    assert fa.LAUNCHES["flash_attention_bwd_f32"] == 1
    assert fa.LAUNCHES["flash_attention_fwd"] == fa.LAUNCHES["flash_attention_bwd"] == 0
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    o_ref, _ = fa.attention_fwd_plain(q, k, v)
    o_ref.backward(do.reshape(1, 8, -1, 40))
    for g, t in zip(got, (q, k, v)):
        _close_f32(g, t.grad)


F32_SAM_SHAPES = [
    (12, 64, 64, 64),       # one float32 image: global layers, 12 heads
    (300, 14, 14, 64),      # one float32 image: 25 windows x 12 heads
    (6, 16, 13, 32),        # non-square grid
    (2, 7, 30, 32),         # two keys in the last tile
    (2, 4, 4, 128),         # the widest head the kernel takes
]


@pytest.mark.parametrize("bh,gh,gw,d", F32_SAM_SHAPES)
def test_f32_sam_attention_matches_plain(no_tf32, bh, gh, gw, d):
    q, k, v, bias_h, bias_w = _sam_inputs(bh, gh, gw, d, no_tf32, seed=24)
    q, k, v = q.float(), k.float(), v.float()
    sa.reset_launch_counts()
    got = sa.sam_attention(q, k, v, bias_h, bias_w)
    want = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
    torch.cuda.synchronize()
    assert sa.LAUNCHES == {"sam_attention": 0, "sam_attention_f32": 1}
    _close_f32(got, want)


def test_f32_wrappers_reject_mixed_and_other_dtypes(cuda):
    q, k, v, do = _inputs(2, 64, 256, 40, cuda, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.reset_launch_counts()
    for args in ((q, k.bfloat16(), v), (q.half(), k.half(), v.half())):
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(*args)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(q, k, v, lse, o, do.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention_fwd_packed(q.reshape(1, 2, 64, 40), k.reshape(1, 2, 256, 40).bfloat16(),
                                      v.reshape(1, 2, 256, 40))
    qf, kf, vf = (t.reshape(1, -1, 80) for t in (q, k, v))
    for args in ((qf, kf.bfloat16(), vf), (qf.half(), kf.half(), vf.half())):
        with pytest.raises(ValueError):
            fa.flash_attention_fwd_fusedheads(*args, 2)
    assert all(n == 0 for n in fa.LAUNCHES.values())
    sq, sk, sv, bh_, bw_ = _sam_inputs(2, 14, 14, 64, cuda)
    sa.reset_launch_counts()
    with pytest.raises(ValueError):
        sa.sam_attention(sq.float(), sk, sv.float(), bh_, bw_)
    with pytest.raises(ValueError):
        sa.sam_attention(sq.half(), sk.half(), sv.half(), bh_, bw_)
    assert all(n == 0 for n in sa.LAUNCHES.values())


# ---- the float32 forms of kernels 3 and 4 (csrc/attention_f32.cu) -------------

F32_PACKED_SHAPES = [
    # (batch, heads, Lq, Lk, d): float32 LMD+ with every option on at 512x512
    # (per-box pass 8, overall pass 4, guidance 2; fuser KV L + 30)
    (2, 8, 4096, 4126, 40),
    (8, 8, 1024, 1024, 80),
    (4, 8, 1024, 1054, 80),
    (2, 5, 100, 300, 64),     # ragged q and kv tails
    (2, 3, 130, 200, 256),    # the widest instantiation
]


@pytest.mark.parametrize("b,h,lq,lk,d", F32_PACKED_SHAPES)
def test_f32_packed_forward_matches_plain(no_tf32, b, h, lq, lk, d):
    q, k, v, _ = (t.reshape(b, h, -1, d)
                  for t in _inputs(b * h, lq, lk, d, no_tf32, seed=25, dtype=torch.float32))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd_packed(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd_packed_f32"] == 1
    assert fa.LAUNCHES["flash_attention_fwd_packed"] == 0
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,h,lq,lk,d", F32_PACKED_SHAPES[:3])
def test_f32_packed_forward_equals_the_per_head_f32_kernel(cuda, b, h, lq, lk, d):
    """The start values (-1e30, 1e-30) never bite on finite inputs: O and LSE
    are kernel 1-f32's bit for bit."""
    q, k, v, _ = (t.reshape(b, h, -1, d)
                  for t in _inputs(b * h, lq, lk, d, cuda, seed=26, dtype=torch.float32))
    o, lse = fa.flash_attention_fwd_packed(q, k, v)
    o_one, lse_one = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o_one) and torch.equal(lse, lse_one)


F32_FUSED_SHAPES = [
    # (batch, heads, Lq, Lk, d): cross (KV 77) of every level, the self and
    # fuser attention of the 256- and 64-token levels
    (8, 8, 4096, 77, 40),
    (4, 8, 1024, 77, 80),
    (2, 8, 256, 77, 160),
    (8, 8, 256, 286, 160),
    (4, 8, 64, 64, 160),
    (2, 8, 64, 94, 160),
    (2, 3, 100, 130, 24),     # ragged tails, head_dim not a multiple of 16
]


def _f32_fused_inputs(b, h, lq, lk, d, device, seed):
    return [t.float() for t in _fused_inputs(b, h, lq, lk, d, device, seed=seed)]


@pytest.mark.parametrize("b,h,lq,lk,d", F32_FUSED_SHAPES)
def test_f32_fusedheads_forward_matches_plain(no_tf32, b, h, lq, lk, d):
    rng = np.random.default_rng(27)
    qf, kf, vf = (torch.from_numpy(rng.standard_normal((b, L, h * d), dtype=np.float32)).to(
        no_tf32) for L in (lq, lk, lk))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, h)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads_f32"] == 1
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads"] == 0
    assert o.shape == qf.shape and o.dtype == torch.float32 and lse.shape == (b, h, lq)
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("which", ["packed", "fusedheads"])
def test_f32_opt_in_kernels_are_bit_equal_from_run_to_run(cuda, which):
    if which == "packed":
        q, k, v, _ = (t.reshape(2, 8, -1, 40) for t in _inputs(
            16, 4096, 4126, 40, cuda, seed=28, dtype=torch.float32))
        first, second = (fa.flash_attention_fwd_packed(q, k, v) for _ in range(2))
    else:
        qf, kf, vf, _ = _f32_fused_inputs(2, 8, 256, 286, 160, cuda, seed=29)
        first, second = (fa.flash_attention_fwd_fusedheads(qf, kf, vf, 8) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 8, 4096, 77, 40), (2, 8, 256, 286, 160),
                                         (2, 8, 64, 94, 160)])
def test_f32_fusedheads_autograd_runs_the_f32_backward(no_tf32, b, h, lq, lk, d):
    """`FusedHeadsAttention` at float32: kernel 4-f32 forward, then a head
    split and kernel 2-f32, the gradients within 1e-4 of the plain backward on
    split heads."""
    qf, kf, vf, g = _f32_fused_inputs(b, h, lq, lk, d, no_tf32, seed=30)
    ins = [t.clone().requires_grad_(True) for t in (qf, kf, vf)]
    fa.reset_launch_counts()
    out = fa.FusedHeadsAttention.apply(*ins, h)
    out.backward(g)
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads_f32"] == 1
    assert fa.LAUNCHES["flash_attention_bwd_f32"] == 1
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads"] == fa.LAUNCHES["flash_attention_bwd"] == 0
    q, k, v, o4, g4 = (fa.split_heads(t, h).contiguous() for t in (qf, kf, vf, out.detach(), g))
    _, lse = fa.attention_fwd_plain(q, k, v)
    want = fa.attention_bwd_plain(q, k, v, lse, o4, g4)
    torch.cuda.synchronize()
    for t, w in zip(ins, want):
        _close_f32(t.grad, fa.merge_heads(w))


# ---- the float32 tensor-core kernels (csrc/attention_f32_tc.cuh) --------------

TC_FUSED_SHAPES = [
    # (batch, heads, Lq, Lk, d): the guidance batch at the 256- and 64-token
    # levels (32-row q tiles; KV tiles split over 2 warp groups at 256 and
    # 286 keys, 4 at 64, 77 and 94), head dim 160; batch 4 (one group); the
    # 64-row tile at head dim 160 (Lq just above 256)
    (2, 8, 256, 286, 160),
    (2, 8, 256, 256, 160),
    (2, 8, 256, 77, 160),
    (2, 8, 64, 77, 160),
    (2, 8, 64, 64, 160),
    (2, 8, 64, 94, 160),
    (4, 8, 256, 286, 160),
    (2, 8, 257, 286, 160),
]
TC_BWD_SHAPES = [
    # (batch*heads, Lq, Lk, d) at batch 2: the 256- and 64-token levels at
    # head dim 160 (dQ's KV tiles over 2 or 4 warp groups; the split dK/dV
    # walk over column pairs, and the wide one at 286 keys: 144 blocks), the
    # KV-77 gradients at head dims 40 and 80 (dK/dV split over four warps),
    # and a batch whose KV-77 grid is wide
    (16, 256, 286, 160),
    (16, 256, 256, 160),
    (16, 256, 77, 160),
    (16, 64, 77, 160),
    (16, 64, 64, 160),
    (16, 64, 94, 160),
    (16, 4096, 77, 40),
    (16, 1024, 77, 80),
    (136, 64, 77, 160),
]


@pytest.mark.parametrize("b,h,lq,lk,d", TC_FUSED_SHAPES)
def test_f32_fusedheads_tc_tiles_match_plain(no_tf32, b, h, lq, lk, d):
    qf, kf, vf, _ = _f32_fused_inputs(b, h, lq, lk, d, no_tf32, seed=31)
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, h)
    torch.cuda.synchronize()
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("bh,lq,lk,d", TC_BWD_SHAPES)
def test_f32_backward_tc_tiles_match_plain(no_tf32, bh, lq, lk, d):
    q, k, v, do = _inputs(bh, lq, lk, d, no_tf32, seed=32, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _close_f32(g, w)


@pytest.mark.parametrize("which", ["q", "kv", "all"])
@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 8, 256, 286, 160), (2, 8, 4096, 77, 40),
                                         (2, 3, 100, 130, 24)])
def test_f32_fusedheads_takes_pointers_off_16_bytes(cuda, b, h, lq, lk, d, which):
    """A projection that starts 4 bytes into its allocation takes the 4-byte
    cp.async pieces and gives the same O and LSE, bit for bit."""
    qf, kf, vf, _ = _f32_fused_inputs(b, h, lq, lk, d, cuda, seed=33)
    want = fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)
    if which in ("q", "all"):
        qf = _shifted(qf)
    if which in ("kv", "all"):
        kf, vf = _shifted(kf), _shifted(vf)
    got = fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


@pytest.mark.parametrize("which", ["q", "kv", "o_do", "all"])
@pytest.mark.parametrize("bh,lq,lk,d", [(16, 256, 286, 160), (16, 4096, 77, 40),
                                        (3, 100, 300, 20)])
def test_f32_backward_takes_pointers_off_16_bytes(cuda, bh, lq, lk, d, which):
    """Float32 tensors that start off 16 bytes take the 4-byte pieces and give
    the same dQ, dK, dV, bit for bit (both dK/dV walks among the shapes)."""
    q, k, v, do = _inputs(bh, lq, lk, d, cuda, seed=34, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_bwd(q, k, v, lse, o, do)
    if which in ("q", "all"):
        q = _shifted(q)
    if which in ("kv", "all"):
        k, v = _shifted(k), _shifted(v)
    if which in ("o_do", "all"):
        o, do = _shifted(o), _shifted(do)
    if which == "all":
        lse = _shifted(lse)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_f32_tc_kernels_match_their_step_by_step_plain_versions(no_tf32):
    """`attention_fwd_fusedheads_tc_plain` and `attention_bwd_tc_plain` repeat
    the kernels' 3xTF32 steps; the kernels meet them within 1e-4 too (their
    tensor cores' own sums truncate where the plain versions round)."""
    qf, kf, vf, _ = _f32_fused_inputs(2, 8, 256, 286, 160, no_tf32, seed=35)
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, 8)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_tc_plain(qf, kf, vf, 8)
    q, k, v, do = _inputs(16, 1024, 77, 80, no_tf32, seed=36, dtype=torch.float32)
    o4, lse4 = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse4, o4, do)
    want = fa.attention_bwd_tc_plain(q, k, v, lse4, o4, do)
    torch.cuda.synchronize()
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    for g, w in zip(got, want):
        _close_f32(g, w)


# ---- kernels 1-f32, 3-f32 and 5-f32 on the tensor-core forward body ---------

F32_TC_FWD_SHAPES = [
    # (batch*heads, Lq, Lk, d): the 256-token level at batch 1 (64 blocks of
    # 32 rows: the KV tiles split over 2 warp groups), KV L and L + 30; the
    # 64-token level at batch 2 (KV 77: 3 tiles over 4 groups, one of them
    # empty); head dim 256 (no path; 64-row q tiles, one group)
    (8, 256, 256, 160),
    (8, 256, 286, 160),
    (16, 64, 77, 160),
    (8, 256, 286, 256),
]


@pytest.mark.parametrize("bh,lq,lk,d", F32_TC_FWD_SHAPES)
def test_f32_forward_tc_tiles_match_plain(no_tf32, bh, lq, lk, d):
    q, k, v, _ = _inputs(bh, lq, lk, d, no_tf32, seed=41, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    _close_f32(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("bh,lq,lk,d", F32_TC_FWD_SHAPES + [(48, 4096, 4126, 40)])
def test_f32_packed_forward_equals_kernel_1_f32_on_every_tile(cuda, bh, lq, lk, d):
    """Kernel 3-f32 deals and merges its KV tiles as kernel 1-f32 does, so
    the start values (-1e30, 1e-30) give kernel 1-f32's bits, also where a
    warp group gets no tile."""
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=42, dtype=torch.float32)
    q4, k4, v4 = (t.reshape(2, bh // 2, -1, d) for t in (q, k, v))
    o, lse = fa.flash_attention_fwd_packed(q4, k4, v4)
    o_one, lse_one = fa.flash_attention_fwd(q4, k4, v4)
    torch.cuda.synchronize()
    assert torch.equal(o, o_one) and torch.equal(lse, lse_one)


F32_TC_SAM_SHAPES = [
    (24, 64, 64, 64),       # SAM ViT-B's global layers, a 2-image chunk
    (600, 14, 14, 64),      # its 14x14 windows (4 keys in the last KV tile), 2 images
    (4, 6, 7, 40),          # odd gw, few blocks: KV tiles over 2 warp groups
]


@pytest.mark.parametrize("bh,gh,gw,d", F32_TC_SAM_SHAPES)
def test_f32_sam_attention_tc_matches_plain_and_its_steps(no_tf32, bh, gh, gw, d):
    q, k, v, bias_h, bias_w = (t.float() for t in _sam_inputs(bh, gh, gw, d, no_tf32, seed=43))
    got = sa.sam_attention(q, k, v, bias_h, bias_w)
    want = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
    steps, _ = fa.attention_fwd_tc_plain(q, k, v, rel_pos=(bias_h, bias_w))
    torch.cuda.synchronize()
    _close_f32(got, want)
    _close_f32(got, steps)


@pytest.mark.parametrize("which", ["q", "kv", "all"])
@pytest.mark.parametrize("bh,lq,lk,d", [(8, 256, 286, 160), (8, 4096, 4126, 40),
                                        (3, 100, 300, 20)])
def test_f32_forward_and_packed_take_pointers_off_16_bytes(cuda, bh, lq, lk, d, which):
    """Kernels 1-f32 and 3-f32 on tensors that start 4 bytes into their
    allocation (4-byte cp.async pieces, 4-byte stores of O and the LSE) give
    the aligned call's O and LSE bit for bit."""
    q, k, v, _ = _inputs(bh, lq, lk, d, cuda, seed=44, dtype=torch.float32)
    want = fa.flash_attention_fwd(q, k, v)
    want_packed = fa.flash_attention_fwd_packed(q, k, v)
    if which in ("q", "all"):
        q = _shifted(q)
    if which in ("kv", "all"):
        k, v = _shifted(k), _shifted(v)
    got = fa.flash_attention_fwd(q, k, v)
    got_packed = fa.flash_attention_fwd_packed(q, k, v)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_packed, want_packed))


@pytest.mark.parametrize("which", ["qkv", "bias"])
@pytest.mark.parametrize("bh,gh,gw", [(24, 64, 64), (600, 14, 14), (4, 6, 7)])
def test_f32_sam_attention_takes_pointers_off_16_bytes(cuda, bh, gh, gw, which):
    q, k, v, bias_h, bias_w = (t.float() for t in _sam_inputs(bh, gh, gw, 64, cuda, seed=45))
    want = sa.sam_attention(q, k, v, bias_h, bias_w)
    if which == "qkv":
        q, k, v = _shifted(q), _shifted(k), _shifted(v)
    else:
        bias_h, bias_w = _shifted(bias_h), _shifted(bias_w)
    got = sa.sam_attention(q, k, v, bias_h, bias_w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_f32_sam_attention_is_bit_equal_from_run_to_run(cuda):
    for bh, g in ((24, 64), (600, 14)):
        q, k, v, bias_h, bias_w = (t.float() for t in _sam_inputs(bh, g, g, 64, cuda, seed=46))
        first, second = (sa.sam_attention(q, k, v, bias_h, bias_w) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def _bf16_sam_digest(device="cuda") -> str:
    """SHA-1 of the bf16 SAM kernel's outputs on seeded inputs at SAM ViT-B's
    two shapes (one image: B*H 12 on the 64x64 grid, 300 on the 14x14
    windows)."""
    import hashlib

    h = hashlib.sha1()
    for bh, g in ((12, 64), (300, 14)):
        q, k, v, bias_h, bias_w = _sam_inputs(bh, g, g, 64, device, seed=47)
        o = sa.sam_attention(q, k, v, bias_h, bias_w)
        h.update(o.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()


# The digest of the bf16 SAM kernel built from the sources before its bias
# policy moved into csrc/attention_bias.cuh (NVIDIA H100 80GB HBM3, nvcc 12.8).
BF16_SAM_DIGEST = "c4e4c37163af8ee592ef93d4355e238c7b393a68"


def test_bf16_sam_bits_are_unchanged_by_the_shared_bias_policy(cuda):
    assert _bf16_sam_digest(cuda) == BF16_SAM_DIGEST
