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


def _inputs(bh, lq, lk, d, device, seed=0):
    rng = np.random.default_rng(seed)

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            device=device, dtype=torch.bfloat16)

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
                                        (3, 100, 300, 20)])
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
        fa.flash_attention_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    assert fa.LAUNCHES["flash_attention_fwd"] == 1


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
        fa.flash_attention_fwd_packed(q.float(), k.float(), v.float())
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
