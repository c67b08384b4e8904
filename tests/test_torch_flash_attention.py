"""The port's flash attention (lmdx_torch/nn/kernels/flash_attention.py) held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each wrapper computes its plain PyTorch version, so these
tests pin the math the CUDA kernels are held to on the card
(tests/test_torch_kernels_gpu.py). Inputs are made with numpy from a seed
and handed to both sides in f32.

Tolerances: forward O and LSE 2e-5 abs+rel and backward 2e-4, the JAX
package's own for its kernels against XLA (tests/test_flash_attention.py):
f32 sums taken in other orders and blocks; the autograd check 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx_torch.nn.kernels import flash_attention as fa

SHAPES = [(128, 256, 32), (128, 260, 40), (256, 256, 40), (256, 260, 32)]


def _qkvg(lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 2, lq, d), dtype=np.float32),
            rng.standard_normal((1, 2, lk, d), dtype=np.float32),
            rng.standard_normal((1, 2, lk, d), dtype=np.float32),
            rng.standard_normal((1, 2, lq, d), dtype=np.float32))


@pytest.mark.parametrize("lq,lk,d", SHAPES)
def test_plain_forward_matches_pallas(lq, lk, d):
    q, k, v, _ = _qkvg(lq, lk, d)
    o_ref, lse_ref = jfa._pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, return_lse=True)
    o, lse = fa.flash_attention_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("lq,lk,d", SHAPES)
def test_plain_backward_matches_pallas(lq, lk, d):
    q, k, v, g = _qkvg(lq, lk, d, seed=1)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = jfa._pallas_attention(jq, jk, jv, interpret=True, return_lse=True)
    want = jfa._pallas_attention_bwd(jq, jk, jv, lse, o, jg, interpret=True)
    got = fa.flash_attention_bwd(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(np.asarray(lse)), torch.tensor(np.asarray(o)), torch.tensor(g))
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_autograd_function_matches_naive_attention():
    q, k, v, g = (torch.tensor(x, dtype=torch.float64) for x in _qkvg(64, 260, 40, seed=2))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*ins)
    out.backward(g)
    ref_ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.softmax(ref_ins[0] @ ref_ins[1].transpose(-1, -2) / 40**0.5, -1) @ ref_ins[2]
    ref.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=1e-5)
    for a, b in zip(ins, ref_ins):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)


@pytest.mark.parametrize("lq,lk,d", [(4096, 4126, 40), (256, 286, 160), (64, 64, 160),
                                     (4096, 77, 40), (4, 512, 40), (256, 256, 320)])
def test_dispatch_gate_matches_jax(lq, lk, d):
    """Same decision as the JAX gate at every shape where its VMEM clause
    does not bind (the port has no VMEM budget)."""
    q, k = np.zeros((1, 1, lq, d), np.float32), np.zeros((1, 1, lk, d), np.float32)
    assert fa.kernel_supported(torch.tensor(q), torch.tensor(k)) == jfa._kernel_supported(q, k)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    q, k, v, g = (torch.tensor(x) for x in _qkvg(16, 256, 32, seed=3))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v)
    fa.flash_attention_bwd(q, k, v, lse, o, g)
    assert fa.LAUNCHES == dict.fromkeys(
        ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bwd_sm90",
         "flash_attention_fwd_packed",
         "flash_attention_fwd_fusedheads", "flash_attention_fwd_f32",
         "flash_attention_bwd_f32", "flash_attention_fwd_packed_f32",
         "flash_attention_fwd_fusedheads_f32"), 0)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
