"""The arithmetic of the float32 tensor-core kernels (lmdx_torch/csrc/
attention_f32_tc.cuh: the forward body of kernels 1-f32, 3-f32, 4-f32 and
5-f32, and kernel 2-f32, the backward), repeated step by step in plain
PyTorch on the CPU: `attention_fwd_tc_plain` (its fused-heads form
`attention_fwd_fusedheads_tc_plain`) and `attention_bwd_tc_plain` take every
product in 3xTF32 (`matmul_3xtf32`: each operand split into TF32 big and
small parts, `tf32_round` emulating `cvt.rna.tf32.f32`) over the kernels'
tiles (32-key tiles of the forward, `f32_tc_dq_kv_tile`,
`f32_tc_dkdv_walk`). Held against the one-pass float32 plain versions the
kernels are held to on the card (`attention_fwd_plain`,
`attention_fwd_packed_plain`, `sam_attention_plain`,
`attention_fwd_fusedheads_plain`, `attention_bwd_plain`) and against the JAX
package's kernels at float32, at the widest reductions the float32 paths
have: KV 4126 (the 4096-token fuser attention) at a narrow width, head dim
160, KV 77, SAM's 14x14 windows (4 keys in the last tile), and the q walk of
4096 rows of the KV-77 gradient.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py,
within 1e-4 * max|plain| there); these tests show on the CPU that 3xTF32 in
these steps meets that bound with room, and that one TF32 pass does not.
Inputs are made with numpy from a seed and handed to every side.

Tolerances, each a share of max|reference| per output (the LSE absolute):
- against the one-pass plain versions 1e-5: 3xTF32 drops small_a small_b
  (below 2^-22 of a product) and rounds the small parts to TF32, and the
  tiles sum in another order (measured below 2.4e-6, the LSE below 1e-6);
- against the Pallas kernels in interpret mode at float32 and the JAX side's
  materialized SAM attention 2e-5 (the same, plus the JAX side's own float32
  sums; measured below 2.5e-6);
- against the Pallas SAM kernel in interpret mode 4e-2, the JAX package's
  own tolerance for it: it casts q, k, v and the bias to bf16 for its
  products whatever the input dtype, so it is no float32 reference;
- kernel 3-f32's start values (-1e30, 1e-30) against kernel 1-f32's
  (-inf, 0): equal bits (the kernels are held to the same on the card);
- one TF32 pass (the negative control) misses 1e-4 by far.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx.nn.pallas import sam_attention as jsa
from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import sam_attention as sa

TOL = 1e-5
TOL_LSE = 1e-5
TOL_PALLAS = 2e-5
CARD_TOL = 1e-4

# (batch, heads, Lq, Lk, d) of the forward: the 4096-token level's KV with
# the fuser (4126) at a narrow width, the cross-attention's KV 77 at head
# dims 40, 80 and 160, the 256- and 64-token self and fuser KV at 160, a head
# dim that is no multiple of 16 (all on grids small enough that 2 or 4 warp
# groups split the KV tiles), and a grid of 136 blocks (one group).
FWD_SHAPES = [(1, 2, 16, 4126, 40), (2, 2, 128, 77, 40), (2, 2, 64, 77, 80),
              (2, 2, 64, 77, 160), (1, 2, 32, 286, 160), (2, 2, 64, 94, 160),
              (2, 3, 100, 130, 24), (2, 34, 64, 94, 40)]
# (batch, heads, Lq, Lk, d) of the backward: the dQ walk over 4126 keys; the
# dK/dV walk over 4096 q rows at KV 77 (split: 4 warps over 16-row slices);
# head dim 160 at KV 77 and L + 30 (split: 2 warps, column pairs); the wide
# walk (a grid of 132 blocks or more) at head dims 40 and 80 (32-row steps)
# and 160 (16-row steps).
BWD_SHAPES = [(1, 2, 16, 4126, 40), (1, 2, 4096, 77, 40), (2, 2, 64, 77, 160),
              (1, 2, 96, 126, 160), (1, 28, 64, 300, 40), (1, 28, 70, 300, 80),
              (1, 34, 40, 130, 160), (2, 3, 100, 130, 24)]


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _fused(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h * d), dtype=np.float32) for n in (lq, lk, lk))


def _split(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d), dtype=np.float32) for n in (lq, lk, lk, lq))


def _sam(h, gh, gw, d, seed):
    rng = np.random.default_rng(seed)
    n = gh * gw
    return tuple(rng.standard_normal((1, h, n, last), dtype=np.float32)
                 for last in (d, d, d, gh, gw))


def test_tf32_round_is_cvt_rna():
    """Round to nearest with ties away from zero, 13 low bits cleared."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 2,
                      1 + ulp * 0.49, 3.0e-3, 0.0], dtype=torch.float32)
    got = fa.tf32_round(x)
    want = [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 1.0]
    assert got[:5].tolist() == want
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    big = fa.tf32_round(x)
    small = fa.tf32_round(x - big)
    assert ((big + small - x).abs() <= x.abs() * 2.0 ** -21).all()


def test_matmul_3xtf32_is_float32_close_and_one_pass_is_not():
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            for s in ((64, 4126), (4126, 40)))
    want = (a.double() @ b.double()).float()
    assert _rel(fa.matmul_3xtf32(a, b), want) < 2e-6
    assert _rel(fa.tf32_round(a) @ fa.tf32_round(b), want) > 1e-4


@pytest.mark.parametrize("b,h,lq,lk,d", FWD_SHAPES)
def test_tc_forward_matches_plain(b, h, lq, lk, d):
    qf, kf, vf = (torch.from_numpy(x) for x in _fused(b, h, lq, lk, d, seed=lq + lk + d))
    o, lse = fa.attention_fwd_fusedheads_tc_plain(qf, kf, vf, h)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, h)
    assert o.dtype == torch.float32 and o.shape == qf.shape and lse.shape == (b, h, lq)
    assert _rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("b,h,lq,lk,d", FWD_SHAPES[:4])
def test_tc_forward_matches_pallas_interpret(b, h, lq, lk, d):
    qf, kf, vf = _fused(b, h, lq, lk, d, seed=1)
    o_ref, lse_ref = jfa._pallas_attention_fusedheads(
        *map(jnp.asarray, (qf, kf, vf)), h, interpret=True, return_lse=True)
    o, lse = fa.attention_fwd_fusedheads_tc_plain(*map(torch.from_numpy, (qf, kf, vf)), h)
    o_ref = torch.tensor(np.asarray(o_ref))
    assert _rel(o, o_ref) <= TOL_PALLAS
    assert (lse - torch.tensor(np.asarray(lse_ref))).abs().max().item() <= TOL_PALLAS


@pytest.mark.parametrize("b,h,lq,lk,d", BWD_SHAPES)
def test_tc_backward_matches_plain(b, h, lq, lk, d):
    q, k, v, g = (torch.from_numpy(x) for x in _split(b, h, lq, lk, d, seed=lq + lk + d + 1))
    o, lse = fa.attention_fwd_plain(q, k, v)
    got = fa.attention_bwd_tc_plain(q, k, v, lse, o, g)
    want = fa.attention_bwd_plain(q, k, v, lse, o, g)
    for got_, want_, like in zip(got, want, (q, k, v)):
        assert got_.dtype == torch.float32 and got_.shape == like.shape
        assert _rel(got_, want_) <= TOL


@pytest.mark.parametrize("b,h,lq,lk,d", [BWD_SHAPES[i] for i in (0, 2, 3, 4, 7)])
def test_tc_backward_matches_pallas_interpret(b, h, lq, lk, d):
    q, k, v, g = _split(b, h, lq, lk, d, seed=2)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._pallas_attention(jq, jk, jv, interpret=True, return_lse=True)
    want = jfa._pallas_attention_bwd(jq, jk, jv, lse, o, jg, interpret=True)
    got = fa.attention_bwd_tc_plain(*map(torch.from_numpy, (q, k, v)),
                                    torch.tensor(np.asarray(lse)), torch.tensor(np.asarray(o)),
                                    torch.from_numpy(g))
    for got_, want_ in zip(got, want):
        assert _rel(got_, torch.tensor(np.asarray(want_))) <= TOL_PALLAS


@pytest.mark.parametrize("lq,lk,d,bh,walk", [
    (4096, 77, 40, 16, (16, 4)),     # KV 77 at batch 2: 32 wide blocks -> split
    (1024, 77, 80, 16, (16, 4)),
    (256, 77, 160, 16, (16, 2)),
    (256, 256, 160, 16, (16, 2)),    # the 256-token level at batch 2: 128 wide blocks
    (256, 256, 160, 24, (16, 1)),    # ... at batch 3: 192
    (1024, 1024, 80, 8, (16, 4)),    # 128 wide blocks at batch 1
    (1024, 1024, 80, 16, (32, 1)),
    (4096, 4096, 40, 8, (32, 1)),
    (4096, 4126, 64, 8, (32, 1)),
])
def test_dkdv_walk_follows_the_grid_rule(lq, lk, d, bh, walk):
    """The dK/dV kernel splits its q walk over warps exactly where the wide
    grid would hold fewer than 132 blocks (one an SM)."""
    assert fa.f32_tc_dkdv_walk(lq, lk, d, bh) == walk


@pytest.mark.parametrize("batch,heads,lq,lk,d,groups", [
    (2, 8, 256, 286, 160, 2),    # 128 blocks of 32 rows, 9 KV tiles
    (2, 8, 256, 77, 160, 4),     # 3 tiles: one super-step
    (8, 8, 64, 94, 160, 4),      # 128 blocks
    (4, 8, 256, 286, 160, 1),    # 256 blocks fill the card
    (2, 8, 4096, 77, 40, 1),     # 64-row q tiles
    (1, 1, 64, 20, 80, 1),       # one tile
    (1, 1, 64, 77, 256, 1),      # above head dim 160
    (2, 2, 64, 77, 80, 2),       # 3 tiles, but 4 groups only above head dim 80
])
def test_fwd_kv_groups_follow_the_grid_rule(batch, heads, lq, lk, d, groups):
    assert fa.f32_tc_fwd_kv_groups(batch, heads, lq, lk, d) == groups


@pytest.mark.parametrize("bh,lq,lk,d,groups", [
    (16, 256, 286, 160, 2),      # 128 blocks of 32 rows, 18 tiles of 16 keys
    (16, 64, 64, 160, 4),        # 4 tiles
    (16, 64, 77, 160, 2),        # 5 tiles
    (24, 256, 256, 160, 1),      # 192 blocks
    (8, 1024, 1024, 80, 1),      # 128 blocks of 64 rows: no split up to head dim 80
    (16, 64, 64, 80, 1),
    (16, 1024, 77, 80, 1),       # 256 blocks
    (2, 64, 77, 256, 1),
])
def test_dq_kv_groups_follow_the_grid_rule(bh, lq, lk, d, groups):
    assert fa.f32_tc_dq_kv_groups(bh, lq, lk, d) == groups


def test_dq_kv_tile():
    assert [fa.f32_tc_dq_kv_tile(d) for d in (40, 64, 80, 96, 160, 256)] == [32] * 3 + [16] * 3


@pytest.mark.parametrize("which", ["forward", "backward", "per_head", "packed", "sam"])
def test_one_tf32_pass_misses_the_card_tolerance(monkeypatch, which):
    """The negative control: the same steps with every product in one TF32
    pass miss the card's 1e-4 * max|plain| at the widest reduction (KV 4126;
    SAM at its 14x14 windows)."""
    monkeypatch.setattr(fa, "matmul_3xtf32", lambda a, b: fa.tf32_round(a) @ fa.tf32_round(b))
    if which == "forward":
        qf, kf, vf = (torch.from_numpy(x) for x in _fused(1, 2, 16, 4126, 40, seed=3))
        got, _ = fa.attention_fwd_fusedheads_tc_plain(qf, kf, vf, 2)
        want, _ = fa.attention_fwd_fusedheads_plain(qf, kf, vf, 2)
        errs = [_rel(got, want)]
    elif which in ("per_head", "packed"):
        q, k, v, _ = (torch.from_numpy(x) for x in _split(1, 2, 16, 4126, 40, seed=3))
        start = {"per_head": {}, "packed": {"m_init": -1e30, "l_min": 1e-30}}[which]
        got, _ = fa.attention_fwd_tc_plain(q, k, v, **start)
        errs = [_rel(got, fa.attention_fwd_plain(q, k, v)[0])]
    elif which == "sam":
        q, k, v, bias_h, bias_w = (torch.from_numpy(x) for x in _sam(2, 14, 14, 64, seed=3))
        got, _ = fa.attention_fwd_tc_plain(q, k, v, rel_pos=(bias_h, bias_w))
        errs = [_rel(got, sa.sam_attention_plain(q, k, v, bias_h, bias_w))]
    else:
        q, k, v, g = (torch.from_numpy(x) for x in _split(1, 2, 16, 4126, 40, seed=3))
        o, lse = fa.attention_fwd_plain(q, k, v)
        errs = [_rel(x, y) for x, y in zip(fa.attention_bwd_tc_plain(q, k, v, lse, o, g),
                                           fa.attention_bwd_plain(q, k, v, lse, o, g))]
    assert max(errs) > CARD_TOL, errs


# (batch, heads, Lq, Lk, d) of the per-head and head-packed forwards (kernels
# 1-f32 and 3-f32, B * heads heads a grid): KV 4126 at a narrow width (2 warp
# groups); the 256-token level's fuser KV at head dim 160 (2 groups, 9
# tiles); 3 and 2 tiles over 4 groups (the last one or two get none); a grid
# of 136 blocks (one group); a head dim that is no multiple of 8.
BHLD_SHAPES = [(1, 2, 16, 4126, 40), (1, 2, 64, 286, 160), (2, 2, 32, 77, 160),
               (1, 2, 32, 40, 160), (2, 34, 64, 94, 40), (2, 3, 100, 130, 20)]
# (heads, gh, gw, d) of SAM's attention (kernel 5-f32): the 14x14 windows (4
# keys in the last 32-key tile), an odd gw, and a grid small enough that 2
# warp groups split the KV tiles.
SAM_GRIDS = [(2, 14, 14, 64), (2, 6, 7, 32), (1, 5, 9, 40)]


@pytest.mark.parametrize("b,h,lq,lk,d", BHLD_SHAPES)
def test_tc_forward_per_head_matches_plain(b, h, lq, lk, d):
    q, k, v, _ = (torch.from_numpy(x) for x in _split(b, h, lq, lk, d, seed=lq + lk + d + 4))
    o, lse = fa.attention_fwd_tc_plain(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    assert o.dtype == torch.float32 and o.shape == q.shape and lse.shape == (b, h, lq)
    assert _rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("b,h,lq,lk,d", BHLD_SHAPES)
def test_tc_forward_packed_start_values_give_equal_bits(b, h, lq, lk, d):
    """From (-1e30, 1e-30) the steps give the bits of (-inf, 0) on finite
    inputs, also where a warp group gets no tile; and the packed kernel's
    plain version within 1e-5."""
    q, k, v, _ = (torch.from_numpy(x) for x in _split(b, h, lq, lk, d, seed=lq + lk + d + 5))
    o, lse = fa.attention_fwd_tc_plain(q, k, v, m_init=-1e30, l_min=1e-30)
    o_one, lse_one = fa.attention_fwd_tc_plain(q, k, v)
    assert torch.equal(o, o_one) and torch.equal(lse, lse_one)
    o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
    assert _rel(o, o_ref) <= TOL
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("b,h,lq,lk,d", [BHLD_SHAPES[i] for i in (0, 1, 2, 5)])
def test_tc_forward_per_head_matches_pallas_interpret(b, h, lq, lk, d, packed):
    q, k, v, _ = _split(b, h, lq, lk, d, seed=6)
    kernel = jfa._pallas_attention_packed if packed else jfa._pallas_attention
    o_ref, lse_ref = kernel(*map(jnp.asarray, (q, k, v)), interpret=True, return_lse=True)
    assert o_ref.dtype == jnp.float32
    start = {"m_init": -1e30, "l_min": 1e-30} if packed else {}
    o, lse = fa.attention_fwd_tc_plain(*map(torch.from_numpy, (q, k, v)), **start)
    assert _rel(o, torch.tensor(np.asarray(o_ref))) <= TOL_PALLAS
    assert (lse - torch.tensor(np.asarray(lse_ref))).abs().max().item() <= TOL_PALLAS


@pytest.mark.parametrize("h,gh,gw,d", SAM_GRIDS)
def test_tc_forward_rel_pos_matches_sam_plain(h, gh, gw, d):
    q, k, v, bias_h, bias_w = (torch.from_numpy(x) for x in _sam(h, gh, gw, d, seed=gh + gw))
    got, _ = fa.attention_fwd_tc_plain(q, k, v, rel_pos=(bias_h, bias_w))
    want = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("h,gh,gw,d", SAM_GRIDS)
def test_tc_forward_rel_pos_matches_the_jax_sam_attention(h, gh, gw, d):
    """At 2e-5 against the JAX side's float32 SAM attention (materialized
    scores); at the Pallas kernel's own 4e-2 against it in interpret mode (its
    products take bf16 operands at any input dtype)."""
    args = _sam(h, gh, gw, d, seed=7)
    got, _ = fa.attention_fwd_tc_plain(*map(torch.from_numpy, args[:3]),
                                       rel_pos=tuple(map(torch.from_numpy, args[3:])))
    want = torch.tensor(np.asarray(jsa.xla_sam_attention(*map(jnp.asarray, args))))
    assert _rel(got, want) <= TOL_PALLAS
    pallas = jsa.sam_attention_interpret(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=4e-2, atol=4e-2)
