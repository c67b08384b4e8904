"""The port's head-packed flash forward (`flash_attention_fwd_packed`) held
against the JAX package's Pallas kernel `_pallas_attention_packed`, run in
interpret mode on the CPU.

On CPU tensors the wrapper computes its plain version, which mirrors the
kernel's arithmetic (heads in groups of `head_pack(d)`, online softmax over
512-row KV chunks from -1e30, the denominator clamped at 1e-30), so these
tests pin the math the CUDA kernel is held to on the card
(tests/test_torch_kernels_gpu.py). Inputs are made with numpy from a seed and
handed to both sides in f32.

Tolerances: O 2e-5, LSE 1e-4 (abs+rel): f32 sums taken in other orders and
blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx_torch.nn.kernels import flash_attention as fa

# (heads, Lq, Lk, d): pack 3 with one padding head, pack 1; KV aligned and ragged.
SHAPES = [(8, 128, 128, 40), (8, 128, 158, 40), (2, 128, 128, 80), (2, 128, 158, 80)]


def _qkv(h, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, h, lq, d), dtype=np.float32),
            rng.standard_normal((1, h, lk, d), dtype=np.float32),
            rng.standard_normal((1, h, lk, d), dtype=np.float32))


@pytest.mark.parametrize("h,lq,lk,d", SHAPES)
def test_packed_forward_matches_pallas(h, lq, lk, d):
    q, k, v = _qkv(h, lq, lk, d)
    o_ref, lse_ref = jfa.packed_attention_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True)
    o, lse = fa.flash_attention_fwd_packed(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert o.shape == (1, h, lq, d) and lse.shape == (1, h, lq)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d,pack", [(40, 3), (64, 2), (80, 1), (160, 1)])
def test_head_pack_matches_jax(d, pack):
    assert fa.head_pack(d) == jfa._head_pack(d) == pack


def test_packed_plain_agrees_with_the_per_head_plain_over_several_chunks():
    """KV longer than one 512-row chunk: the online softmax across chunks
    gives the one-pass softmax."""
    q, k, v = (torch.tensor(x) for x in _qkv(4, 64, 1100, 40, seed=1))
    o, lse = fa.attention_fwd_packed_plain(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), rtol=1e-4, atol=1e-4)


def test_autograd_with_the_packed_forward_matches_naive_attention():
    q, k, v = (torch.tensor(x, dtype=torch.float64) for x in _qkv(4, 64, 260, 40, seed=2))
    g = torch.tensor(np.random.default_rng(3).standard_normal(q.shape))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*ins, packed=True).backward(g)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.softmax(ref_ins[0] @ ref_ins[1].transpose(-1, -2) / 40**0.5, -1) @ ref_ins[2]
    ref.backward(g)
    for a, b in zip(ins, ref_ins):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    q, k, v = (torch.tensor(x) for x in _qkv(8, 16, 256, 40, seed=4))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd_packed(q, k, v)
    assert fa.LAUNCHES["flash_attention_fwd_packed"] == 0
    o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
