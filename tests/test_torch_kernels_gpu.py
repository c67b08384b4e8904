"""The port's CUDA kernels (flash attention forward and backward, SAM
attention) against their plain PyTorch versions, on the card. Marked
`gpu`: they skip where no CUDA device is present. On a machine with the
card (and without JAX, which the repo's root conftest imports), run them
with

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: the kernels round p and dS to bf16 for the tensor-core products
and write bf16 outputs, the plain versions compute in f32 from the same bf16
inputs. Each output is held to max|kernel - plain| <= 2e-2 * max|plain|
(a few bf16 ulps of the largest entry); the f32 LSE to 1e-3 absolute.
"""

import numpy as np
import pytest
import torch

from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import sam_attention as sa

pytestmark = pytest.mark.gpu

SHAPES = [
    # (batch*heads, Lq, Lk, d): main-path levels, aligned and fuser KV
    (16, 256, 256, 160),
    (16, 256, 286, 160),
    (16, 1024, 1054, 80),
    (8, 4096, 4126, 40),
    (32, 4096, 4096, 40),   # LMD's per-box guidance: 4 boxes x 8 heads
    (2, 100, 300, 32),      # ragged q and kv tails
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
