"""The port's fused-heads attention (`flash_attention_fwd_fusedheads`,
`FusedHeadsAttention`, `fusedheads_supported`, `flash_attention_hd`) held
against the JAX package: the Pallas kernel `_pallas_attention_fusedheads` in
interpret mode for the forward, `jax.vjp` of `_xla_attention` on split heads
for the gradients (the plain reference the JAX package's own tests use), and
`_fusedheads_supported` for the dispatch gate.

On CPU tensors the wrappers compute their plain versions, so these tests pin
the math the CUDA kernels are held to on the card. Inputs are made with numpy
from a seed and handed to both sides in f32.

Tolerances: forward O and LSE 2e-5 abs+rel, gradients 2e-4 (f32 sums in other
orders; the JAX package's own for its kernels against XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn.pallas import flash_attention as jfa
from lmdx_torch.config import ALL_KERNELS, KernelOptions
from lmdx_torch.nn.kernels import flash_attention as fa

# (heads, Lq, Lk, d): the 77-token cross-attention, self-attention, the fuser's KV.
SHAPES = [(8, 128, 77, 40), (2, 128, 128, 80), (2, 64, 94, 160)]


def _qkvg(h, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, lq, h * d), dtype=np.float32),
            rng.standard_normal((2, lk, h * d), dtype=np.float32),
            rng.standard_normal((2, lk, h * d), dtype=np.float32),
            rng.standard_normal((2, lq, h * d), dtype=np.float32))


@pytest.mark.parametrize("h,lq,lk,d", SHAPES)
def test_fusedheads_forward_matches_pallas(h, lq, lk, d):
    qf, kf, vf, _ = _qkvg(h, lq, lk, d)
    o_ref, lse_ref = jfa.fusedheads_attention_interpret(
        jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf), h, return_lse=True)
    o, lse = fa.flash_attention_fwd_fusedheads(
        torch.tensor(qf), torch.tensor(kf), torch.tensor(vf), h)
    assert o.shape == qf.shape and lse.shape == (2, h, lq)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("h,lq,lk,d", SHAPES)
def test_fusedheads_gradients_match_xla_attention_on_split_heads(h, lq, lk, d):
    qf, kf, vf, g = _qkvg(h, lq, lk, d, seed=1)

    def ref(qf_, kf_, vf_):
        q, k, v = (jfa._split_heads_bhld(t, h) for t in (qf_, kf_, vf_))
        return jfa._merge_heads_blhd(jfa._xla_attention(q, k, v))

    want_o, vjp = jax.vjp(ref, jnp.asarray(qf), jnp.asarray(kf), jnp.asarray(vf))
    want = vjp(jnp.asarray(g))
    ins = [torch.tensor(x, requires_grad=True) for x in (qf, kf, vf)]
    out = fa.FusedHeadsAttention.apply(*ins, h)
    out.backward(torch.tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), rtol=2e-5, atol=2e-5)
    for t, w in zip(ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


# (Lq, Lk, heads * d) of every untapped attention of SD1.x at 512x512 (self,
# fuser and cross, 8 heads), then the two 4096-token shapes the size rule
# refuses.
GATE_SHAPES = [
    (1024, 1024, 640), (1024, 1054, 640), (256, 256, 1280), (256, 286, 1280),
    (64, 64, 1280), (64, 94, 1280),
    (4096, 77, 320), (1024, 77, 640), (256, 77, 1280), (64, 77, 1280),
    (4096, 4096, 320), (4096, 4126, 320),
]


@pytest.mark.parametrize("lq,lk,hd", GATE_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fusedheads_gate_matches_jax(monkeypatch, lq, lk, hd, dtype):
    monkeypatch.setenv("LMDX_FUSED_HEADS", "1")
    want = jfa._fusedheads_supported(jnp.zeros((2, lq, hd), dtype),
                                     jnp.zeros((2, lk, hd), dtype), 8)
    tdtype = getattr(torch, dtype)
    got = fa.fusedheads_supported(torch.zeros((2, lq, hd), dtype=tdtype),
                                  torch.zeros((2, lk, hd), dtype=tdtype), 8)
    assert got == want
    if dtype == "bfloat16":
        assert got == (lq != 4096 or lk == 77)


def test_gate_refuses_odd_head_dims_and_short_queries():
    z = torch.zeros
    assert not fa.fusedheads_supported(z(1, 64, 36), z(1, 64, 36), 3)    # d = 12
    assert not fa.fusedheads_supported(z(1, 4, 64), z(1, 64, 64), 2)     # Lq < 8
    assert not fa.fusedheads_supported(z(1, 64, 70), z(1, 64, 70), 3)    # 70 % 3


@pytest.mark.parametrize("h,d,lq,lk,path", [
    (2, 16, 64, 77, "fusedheads"),     # inside the size rule
    (8, 40, 16, 4096, "packed"),       # refused by the size rule, KV >= 256
    (2, 16, 16, 9000, "plain"),        # refused by it and by the flash gate's size rule
    (2, 12, 64, 300, "packed"),        # head_dim not a multiple of 8, KV >= 256
    (2, 12, 64, 77, "plain"),          # refused and KV < 256
])
def test_flash_attention_hd_dispatch(monkeypatch, h, d, lq, lk, path):
    """Each branch of `flash_attention_hd` is taken where the gates say, and
    all compute plain attention on split heads."""
    taken = []
    for name, attr in (("fusedheads", "flash_attention_fwd_fusedheads"),
                       ("packed", "flash_attention_fwd_packed"),
                       ("per_head", "flash_attention_fwd"), ("plain", "attention_plain")):
        def spy(*a, _name=name, _fn=getattr(fa, attr), **kw):
            taken.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(fa, attr, spy)
    rng = np.random.default_rng(5)
    qf = torch.tensor(rng.standard_normal((1, lq, h * d), dtype=np.float32))
    kf = torch.tensor(rng.standard_normal((1, lk, h * d), dtype=np.float32))
    vf = torch.tensor(rng.standard_normal((1, lk, h * d), dtype=np.float32))
    got = fa.flash_attention_hd(qf, kf, vf, h, ALL_KERNELS)
    assert taken == [path]
    q, k, v = (fa.split_heads(t, h) for t in (qf, kf, vf))
    want = fa.merge_heads(fa.attention_plain(q, k, v))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    if path == "packed":   # without the packed option the per-head forward
        taken.clear()
        fa.flash_attention_hd(qf, kf, vf, h, KernelOptions(fused_heads=True))
        assert taken == ["per_head"]


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    qf, kf, vf, _ = (torch.tensor(x) for x in _qkvg(2, 16, 77, 16, seed=6))
    fa.reset_launch_counts()
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, 2)
    assert fa.LAUNCHES["flash_attention_fwd_fusedheads"] == 0
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, 2)
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
