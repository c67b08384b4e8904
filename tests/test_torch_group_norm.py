"""The port's fused GroupNorm (`lmdx_torch/nn/kernels/group_norm.py`) held
against the JAX package's `nn/pallas/group_norm.py` with its Pallas reduction
in interpret mode on the CPU: `pair_stats`, and `group_norm` values and
`jax.vjp` gradients (dx, dscale, dbias) against `GroupNormFn`, with and
without the trailing SiLU.

The JAX side is NHWC and reduces (B, N, C) over N; the port is NCHW and
reduces (B, C, N) rows: the tests transpose the same numpy inputs. On CPU
tensors the port's `pair_stats` computes its plain version, so these tests
pin the math the CUDA kernel is held to on the card.

Tolerances: values 2e-5, gradients 1e-4 (abs+rel): f32 sums in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import group_norm as jgn
from lmdx_torch.nn.attention import GroupNorm
from lmdx_torch.nn.kernels import group_norm as gn

# (B, H, W, C, groups): a small unaligned width and SD's level-0 width.
SHAPES = [(1, 4, 4, 96, 8), (2, 4, 4, 320, 32)]


def _inputs(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c), dtype=np.float32) * 2.0 + 0.5
    scale = rng.standard_normal((c,), dtype=np.float32) * 0.1 + 1.0
    bias = rng.standard_normal((c,), dtype=np.float32) * 0.1
    cot = rng.standard_normal((b, h, w, c), dtype=np.float32)
    return x, scale, bias, cot


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("b,h,w,c,groups", SHAPES)
@pytest.mark.parametrize("same", [True, False], ids=["x_x", "a_b"])
def test_pair_stats_matches_pallas(b, h, w, c, groups, same):
    a, _, _, other = _inputs(b, h, w, c)
    a3 = a.reshape(b, h * w, c)
    b3 = a3 if same else other.reshape(b, h * w, c)
    want = jgn.pair_stats(jnp.asarray(a3), jnp.asarray(b3), interpret=True)
    ta = torch.tensor(np.ascontiguousarray(a3.transpose(0, 2, 1)))
    tb = ta if same else torch.tensor(np.ascontiguousarray(b3.transpose(0, 2, 1)))
    got = gn.pair_stats(ta, tb)
    for g_, w_ in zip(got, want):
        assert g_.shape == (b, c) and g_.dtype == torch.float32
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,w,c,groups", SHAPES)
@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_values_and_gradients_match_pallas(b, h, w, c, groups, silu):
    x, scale, bias, cot = _inputs(b, h, w, c, seed=1)

    def ref(x_, s_, b_):
        return jgn.group_norm(x_, s_, b_, groups, 1e-5, silu, True)

    want, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_dx, want_ds, want_db = vjp(jnp.asarray(cot))

    tx = _nchw(x).requires_grad_(True)
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    got = gn.GroupNormFn.apply(tx, ts, tb, groups, 1e-5, silu)
    got.backward(_nchw(cot))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_ds), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_db), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("silu", [False, True])
def test_fused_module_is_a_drop_in_for_group_norm(silu):
    """Same parameter names, f32 output, and the function of the port's
    `GroupNorm` (+ SiLU), which is what the default UNet computes."""
    x, scale, bias, _ = _inputs(2, 4, 4, 320, seed=2)
    plain = GroupNorm(32, 320, eps=1e-5)
    fused = gn.FusedGroupNorm(32, 320, eps=1e-5, apply_silu=silu)
    state = {"weight": torch.tensor(scale), "bias": torch.tensor(bias)}
    plain.load_state_dict(state, strict=True)
    fused.load_state_dict(state, strict=True)
    tx = _nchw(x).to(torch.bfloat16)
    want = plain(tx)
    want = torch.nn.functional.silu(want) if silu else want
    got = fused(tx)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    a = torch.tensor(np.random.default_rng(3).standard_normal((2, 8, 64), dtype=np.float32))
    gn.reset_launch_counts()
    got = gn.pair_stats(a, a)
    assert gn.LAUNCHES == {"pair_stats": 0}
    want = gn.pair_stats_plain(a, a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
