"""The opt-in kernels at float32: the head-packed (kernel 3) and fused-heads
(kernel 4) forwards, whose float32 forms live in `csrc/attention_f32.cu`.

- The float32 dispatch on SD1.4+GLIGEN's full-width attention shapes (meta
  tensors): at float32 the fused-heads size rule counts K/V at 4 bytes, so
  the 1024-token self and fuser attention leave it for the per-head gate
  (and there the packed kernel); every other untapped attention stays on the
  fused-heads kernel, and none falls to plain math. `fusedheads_supported`
  equals the JAX gate `_fusedheads_supported` (LMDX_FUSED_HEADS=1) at each.
- The float32 kernels' arithmetic on the CPU: `attention_fwd_tiled_plain`
  from the packed kernel's start values (-1e30, 1e-30) against the Pallas
  kernel `_pallas_attention_packed` in interpret mode, and the fused-heads
  kernel's steps (split heads -> the tiled plain version -> merge) against
  `_pallas_attention_fusedheads` in interpret mode.
- `FusedHeadsAttention` at float32 on CPU tensors takes the plain gradient
  and launches nothing.

Inputs are made with numpy from a seed and handed to both sides in float32.
Tolerances: O 2e-5 and LSE 1e-4 (abs + rel), the JAX package's own for its
kernels: float32 sums in other orders and blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx_torch.nn.kernels import flash_attention as fa

# (Lq, Lk, heads * d) of every untapped attention of SD1.4+GLIGEN at 512x512
# (8 heads, 30 grounding tokens), with the route at bf16 and at float32.
ROUTES = [
    (4096, 4096, 320, "packed", "packed"),
    (4096, 4126, 320, "packed", "packed"),
    (1024, 1024, 640, "fused", "packed"),
    (1024, 1054, 640, "fused", "packed"),
    (256, 256, 1280, "fused", "fused"),
    (256, 286, 1280, "fused", "fused"),
    (64, 64, 1280, "fused", "fused"),
    (64, 94, 1280, "fused", "fused"),
    (4096, 77, 320, "fused", "fused"),
    (1024, 77, 640, "fused", "fused"),
    (256, 77, 1280, "fused", "fused"),
    (64, 77, 1280, "fused", "fused"),
]


def _route(qf, kf, heads):
    """Where `flash_attention_hd` with every option on sends an attention."""
    if fa.fusedheads_supported(qf, kf, heads):
        return "fused"
    if fa.kernel_supported(fa.split_heads(qf, heads), fa.split_heads(kf, heads)):
        return "packed"
    return "plain"


@pytest.mark.parametrize("lq,lk,hd,bf16_route,f32_route", ROUTES)
def test_float32_dispatch_at_full_width(monkeypatch, lq, lk, hd, bf16_route, f32_route):
    monkeypatch.setenv("LMDX_FUSED_HEADS", "1")
    for dtype, want in ((torch.bfloat16, bf16_route), (torch.float32, f32_route)):
        qf = torch.empty((2, lq, hd), dtype=dtype, device="meta")
        kf = torch.empty((2, lk, hd), dtype=dtype, device="meta")
        assert _route(qf, kf, 8) == want, dtype
        jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        assert fa.fusedheads_supported(qf, kf, 8) == jfa._fusedheads_supported(
            jnp.zeros((2, lq, hd), jdtype), jnp.zeros((2, lk, hd), jdtype), 8)


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32),
            rng.standard_normal(shape_kv, dtype=np.float32))


# (heads, Lq, Lk, d): the packed kernel's head dims, KV aligned and ragged.
PACKED_SHAPES = [(8, 128, 158, 40), (2, 128, 128, 80), (2, 96, 200, 80)]


@pytest.mark.parametrize("h,lq,lk,d", PACKED_SHAPES)
def test_tiled_plain_from_the_packed_start_values_matches_pallas_at_float32(h, lq, lk, d):
    q, k, v = _qkv((1, h, lq, d), (1, h, lk, d), seed=lq + lk + d)
    o_ref, lse_ref = jfa.packed_attention_interpret(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True)
    o, lse = fa.attention_fwd_tiled_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                          m_init=-1e30, l_min=1e-30)
    assert o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-4, atol=1e-4)


# (heads, Lq, Lk, d): the 77-token cross-attention, self and fuser KV at d 160.
FUSED_SHAPES = [(8, 128, 77, 40), (2, 64, 64, 160), (2, 64, 94, 160), (3, 100, 130, 24)]


@pytest.mark.parametrize("h,lq,lk,d", FUSED_SHAPES)
def test_fusedheads_tiled_arithmetic_matches_pallas_at_float32(h, lq, lk, d):
    """Kernel 4-f32 runs the float32 body on each head's strided rows: split
    heads, the body's steps from (-inf, 0), merge."""
    qf, kf, vf = _qkv((2, lq, h * d), (2, lk, h * d), seed=lq + lk + d + 1)
    o_ref, lse_ref = jfa.fusedheads_attention_interpret(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), h, return_lse=True)
    q, k, v = (fa.split_heads(torch.tensor(t), h) for t in (qf, kf, vf))
    o, lse = fa.attention_fwd_tiled_plain(q, k, v)
    np.testing.assert_allclose(fa.merge_heads(o).numpy(), np.asarray(o_ref),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=1e-4, atol=1e-4)


def test_fusedheads_autograd_at_float32_on_the_cpu_takes_the_plain_gradient():
    qf, kf, vf = (torch.tensor(t) for t in _qkv((2, 64, 320), (2, 94, 320), seed=7))
    g = torch.tensor(np.random.default_rng(8).standard_normal((2, 64, 320), dtype=np.float32))
    ins = [t.clone().requires_grad_(True) for t in (qf, kf, vf)]
    fa.reset_launch_counts()
    out = fa.FusedHeadsAttention.apply(*ins, 8)
    out.backward(g)
    assert all(n == 0 for n in fa.LAUNCHES.values())
    o, lse = fa.attention_fwd_fusedheads_plain(qf, kf, vf, 8)
    assert torch.equal(out.detach(), o)
    q, k, v, o4, g4 = (fa.split_heads(t, 8).contiguous() for t in (qf, kf, vf, o, g))
    want = fa.attention_bwd_plain(q, k, v, lse, o4, g4)
    for t, w in zip(ins, want):
        assert t.grad.dtype == torch.float32
        assert torch.equal(t.grad, fa.merge_heads(w))


def test_opt_in_wrappers_refuse_mixed_dtypes_on_the_cpu():
    """The CPU path takes what the card does: one dtype for q, k and v."""
    q, k, v = (torch.tensor(t) for t in _qkv((1, 2, 16, 40), (1, 2, 30, 40), seed=9))
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_attention_fwd_packed(q, k.bfloat16(), v)
    qf, kf, vf = (fa.merge_heads(t) for t in (q, k, v))
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_attention_fwd_fusedheads(qf, kf, vf.bfloat16(), 2)
