"""The arithmetic of the CUDA attention backward (lmdx_torch/csrc/flash_bwd.cu),
repeated step by step in plain PyTorch (`attention_bwd_tiled_plain`: delta
from dO and O, p by exp2 with scale * log2(e) folded into the score and the
natural-unit LSE converted, dS in f32, p and dS rounded to the inputs' dtype
for the products, dV and dK summed over the dK/dV kernel's q steps, dQ over
64-row KV tiles), held on the CPU against the one-pass plain version the
kernel is held to on the card (`attention_bwd_plain`) and against the JAX
package's Pallas backward in interpret mode.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py);
these tests show that their steps compute the function. Inputs are made with
numpy from a seed and handed to every side; the forward's (o, lse) come from
the side under test. Lengths: q rows that are no multiple of 16 and KV rows
that are no multiple of 64 (100 x 300, 64 x 77, 8 x 94); head dims 20, 40, 80
(q steps of 64 rows) and 96, 160 (steps of 32).

Tolerances, each a share of max|plain| per output:
- f32 inputs 1e-5: only the order of f32 sums and exp2 for exp differ
  (measured below 1.2e-6);
- bf16 inputs 2e-2, the card's tolerance: the tiled version rounds p and dS
  to bf16 for the products where the plain one keeps f32 (measured below
  7.1e-3);
- against the Pallas kernel (f32) 2e-4 absolute and relative, the JAX
  package's own for that kernel against XLA (measured below 1.2e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx_torch.nn.kernels import flash_attention as fa

LENGTHS = [(100, 300), (64, 77), (8, 94)]
HEAD_DIMS = [20, 40, 80]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TOL_PALLAS = 2e-4


def _qkvg(lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((1, 2, n, d), dtype=np.float32) for n in (lq, lk, lk, lq))


def _assert_close(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item()
    assert err <= bound, (err, bound)


def _tiled_and_plain(lq, lk, d, dtype, seed):
    q, k, v, g = (torch.from_numpy(x).to(dtype) for x in _qkvg(lq, lk, d, seed))
    o, lse = fa.attention_fwd_plain(q, k, v)
    got = fa.attention_bwd_tiled_plain(q, k, v, lse, o, g)
    want = fa.attention_bwd_plain(q, k, v, lse, o, g)
    return got, want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_tiled_backward_matches_plain(lq, lk, d, dtype):
    got, want = _tiled_and_plain(lq, lk, d, dtype, seed=lq + lk + d)
    for g_, w_, like in zip(got, want, ("q", "k", "v")):
        assert g_.dtype == dtype and g_.shape == w_.shape, like
        _assert_close(g_, w_, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(100, 300, 96), (64, 94, 160)])
def test_tiled_backward_with_32_row_q_steps_matches_plain(lq, lk, d, dtype):
    """Above the padded head dim 80 the dK/dV kernel walks q in 32-row steps."""
    assert fa.bwd_q_step(d) == 32 and fa.bwd_q_step(80) == 64
    got, want = _tiled_and_plain(lq, lk, d, dtype, seed=lq + d)
    for g_, w_ in zip(got, want):
        _assert_close(g_, w_, TOL[dtype])


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_tiled_backward_matches_pallas_interpret(lq, lk, d):
    q, k, v, g = _qkvg(lq, lk, d, seed=1)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._pallas_attention(jq, jk, jv, interpret=True, return_lse=True)
    want = jfa._pallas_attention_bwd(jq, jk, jv, lse, o, jg, interpret=True)
    got = fa.attention_bwd_tiled_plain(
        *map(torch.from_numpy, (q, k, v)), torch.tensor(np.asarray(lse)),
        torch.tensor(np.asarray(o)), torch.from_numpy(g))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=TOL_PALLAS, atol=TOL_PALLAS)
