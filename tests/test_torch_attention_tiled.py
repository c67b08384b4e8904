"""The arithmetic of the CUDA attention forward body
(lmdx_torch/csrc/attention_fwd.cuh), repeated step by step in plain PyTorch
(`attention_fwd_tiled_plain`: 64-row KV tiles, exp2 with scale * log2(e)
folded into the score, row max from m_init, l_min clamp, P rounded to v's
dtype, optional rel-pos bias, LSE back in natural units), held on the CPU
against the one-pass plain versions the kernels are held to on the card and
against the JAX package's Pallas kernels in interpret mode.

The body itself runs only on the card (tests/test_torch_kernels_gpu.py);
these tests show that its steps compute the function. Inputs are made with
numpy from a seed and handed to every side.

Tolerances: O in f32 1e-5 * max|plain| (f32 sums in another order, exp2 for
exp); O in bf16 2e-2 * max|plain| (a few bf16 ulps of the largest entry: P
and O are rounded); the LSE 1e-3 absolute, the card's tolerance. Against the
Pallas SAM kernel 4e-2, the JAX package's own for it (its products run in
bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx.nn.pallas import sam_attention as jsa
from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import sam_attention as sa

# Ragged q and kv tails, one window, KV shorter than two tiles.
LENGTHS = [(100, 300), (196, 196), (64, 77)]
HEAD_DIMS = [20, 32, 40, 64, 160]
SOFTMAX_STARTS = [(float("-inf"), 0.0), (-1e30, 1e-30)]  # (m_init, l_min)
GRIDS = [(14, 14, 64), (6, 13, 32), (10, 30, 64)]  # (gh, gw, d): N = 196, 78, 300
TOL_O = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_LSE = 1e-3


def _qkv(lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, 2, n, d), dtype=np.float32) for n in (lq, lk, lk))


def _sam_inputs(gh, gw, d, seed):
    rng = np.random.default_rng(seed)
    n = gh * gw
    return tuple(rng.standard_normal(s, dtype=np.float32) for s in
                 ((1, 2, n, d), (1, 2, n, d), (1, 2, n, d), (1, 2, n, gh), (1, 2, n, gw)))


def _assert_close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m_init,l_min", SOFTMAX_STARTS, ids=["plain", "packed"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_tiled_forward_matches_plain(lq, lk, d, m_init, l_min, dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(lq, lk, d, seed=lq + lk + d))
    o, lse = fa.attention_fwd_tiled_plain(q, k, v, m_init=m_init, l_min=l_min)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    assert o.dtype == dtype and lse.dtype == torch.float32
    _assert_close(o, o_ref, TOL_O[dtype])
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_tiled_forward_matches_pallas_interpret(lq, lk, d):
    q, k, v = _qkv(lq, lk, d, seed=1)
    o_ref, lse_ref = jfa._pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, return_lse=True)
    o, lse = fa.attention_fwd_tiled_plain(*map(torch.from_numpy, (q, k, v)))
    _assert_close(o, torch.tensor(np.asarray(o_ref)), TOL_O[torch.float32])
    assert np.abs(lse.numpy() - np.asarray(lse_ref)).max() <= TOL_LSE


@pytest.mark.parametrize("lq,lk,d", [(100, 300, 40), (64, 77, 160)])
def test_tiled_forward_from_the_packed_start_matches_the_packed_plain(lq, lk, d):
    """The head-packed kernel runs the body from (-1e30, 1e-30); its plain
    version walks 512-row chunks. Same function."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(lq, lk, d, seed=2))
    o, lse = fa.attention_fwd_tiled_plain(q, k, v, m_init=-1e30, l_min=1e-30)
    o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
    _assert_close(o, o_ref, TOL_O[torch.float32])
    assert (lse - lse_ref).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("gh,gw,d", GRIDS)
def test_tiled_forward_with_rel_pos_matches_sam_plain(gh, gw, d, dtype):
    q, k, v, bias_h, bias_w = map(torch.from_numpy, _sam_inputs(gh, gw, d, seed=gh + gw))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    o, _ = fa.attention_fwd_tiled_plain(q, k, v, rel_pos=(bias_h, bias_w))
    _assert_close(o, sa.sam_attention_plain(q, k, v, bias_h, bias_w), TOL_O[dtype])


@pytest.mark.parametrize("gh,gw,d", GRIDS)
def test_tiled_forward_with_rel_pos_matches_jax(gh, gw, d):
    args = _sam_inputs(gh, gw, d, seed=3)
    q, k, v, bias_h, bias_w = map(torch.from_numpy, args)
    o, _ = fa.attention_fwd_tiled_plain(q, k, v, rel_pos=(bias_h, bias_w))
    xla = jsa.xla_sam_attention(*map(jnp.asarray, args))
    _assert_close(o, torch.tensor(np.asarray(xla)), TOL_O[torch.float32])
    pallas = jsa.sam_attention_interpret(*map(jnp.asarray, args))
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), rtol=4e-2, atol=4e-2)


def test_bias_is_added_unscaled_and_lse_counts_it():
    """A constant bias leaves O unchanged and shifts the LSE by it: it is not
    multiplied by the softmax scale."""
    q, k, v, bias_h, bias_w = map(torch.from_numpy, _sam_inputs(8, 8, 32, seed=4))
    o0, lse0 = fa.attention_fwd_tiled_plain(q, k, v, rel_pos=(0 * bias_h, 0 * bias_w))
    o1, lse1 = fa.attention_fwd_tiled_plain(q, k, v,
                                            rel_pos=(0 * bias_h + 1.5, 0 * bias_w + 0.5))
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    _assert_close(o0, o_ref, TOL_O[torch.float32])
    _assert_close(o1, o_ref, TOL_O[torch.float32])
    assert (lse0 - lse_ref).abs().max().item() <= TOL_LSE
    assert (lse1 - lse_ref - 2.0).abs().max().item() <= TOL_LSE


def test_ptxas_report_names_kernels_and_spills():
    """The build's register report (what the smoke run checks for spills),
    on `ptxas -v` text as nvcc prints it for a templated and a plain kernel;
    the mangled name's hash may end in digits that run into the length."""
    from lmdx_torch.nn.kernels.build import ptxas_report

    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN4lmdx45_GLOBAL__N__011b2141_12_"
        "flash_fwd_cu_4d7b4f9916flash_fwd_kernelILi160ENS0_7FwdTileILi8EEEEEvPK13"
        "__nv_bfloat16S6_S6_PS4_Pfiiif' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4lmdx45_GLOBAL__N__011b2141\n"
        "    0 bytes stack frame, 40 bytes spill stores, 24 bytes spill loads\n"
        "ptxas info    : Used 238 registers, used 1 barriers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN4lmdx22flash_bwd_delta_kernelEPKfi' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN4lmdx22flash_bwd_delta_kernelEPKfi\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 12 registers\n")
    assert ptxas_report(log) == [
        {"kernel": "flash_fwd_kernel<160,8>", "registers": 238, "spill_bytes": 64},
        {"kernel": "flash_bwd_delta_kernel", "registers": 12, "spill_bytes": 0}]
