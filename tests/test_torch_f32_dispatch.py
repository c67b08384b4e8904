"""The float32 dispatch of the kernel wrappers and of `load_bundle`.

On the CPU a wrapper computes its plain version because its tensors lie on
the CPU; at float32 that is the plain version's result bit for bit, as at
bf16. Mixed dtypes raise there as on the card, where q's dtype chooses the
kernel (bf16 or float32) and k, v, o and dO must match it. `load_bundle`
refuses, before loading anything, dtypes no kernel takes; float32 passes
its dtype gate with every opt-in kernel, since each has a float32 form. The
gate needs no card.
"""

import numpy as np
import pytest
import torch

from lmdx_torch.config import ALL_KERNELS, KernelOptions
from lmdx_torch.nn.kernels import flash_attention as fa
from lmdx_torch.nn.kernels import sam_attention as sa
from lmdx_torch.runtime import models


def _f32(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in shapes]


def test_float32_cpu_tensors_give_the_plain_results():
    q, k, v, do = _f32((1, 2, 40, 16), (1, 2, 70, 16), (1, 2, 70, 16), (1, 2, 40, 16))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    assert o.dtype == torch.float32 and torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    assert all(g.dtype == torch.float32 and torch.equal(g, w) for g, w in zip(got, want))
    sq, sk, sv, bh, bw = _f32(*[(1, 2, 48, 16)] * 3, (1, 2, 48, 6), (1, 2, 48, 8), seed=1)
    assert torch.equal(sa.sam_attention(sq, sk, sv, bh, bw),
                       sa.sam_attention_plain(sq, sk, sv, bh, bw))
    assert fa.LAUNCHES["flash_attention_fwd_f32"] == fa.LAUNCHES["flash_attention_bwd_f32"] == 0


def test_float32_autograd_on_the_cpu_takes_the_plain_gradient():
    q, k, v, do = (t.requires_grad_(i < 3) for i, t in enumerate(
        _f32((1, 2, 40, 16), (1, 2, 70, 16), (1, 2, 70, 16), (1, 2, 40, 16), seed=2)))
    fa.flash_attention(q, k, v).backward(do)
    o, lse = fa.attention_fwd_plain(q.detach(), k.detach(), v.detach())
    want = fa.attention_bwd_plain(q.detach(), k.detach(), v.detach(), lse, o, do)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_mixed_dtypes_raise_on_the_cpu():
    q, k, v, do = _f32((1, 2, 40, 16), (1, 2, 70, 16), (1, 2, 70, 16), (1, 2, 40, 16))
    o, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="mixed dtypes"):
        fa.flash_attention_bwd(q, k, v, lse, o, do.bfloat16())
    sq, sk, sv, bh, bw = _f32(*[(1, 2, 48, 16)] * 3, (1, 2, 48, 6), (1, 2, 48, 8))
    with pytest.raises(ValueError, match="mixed dtypes"):
        sa.sam_attention(sq, sk.bfloat16(), sv, bh, bw)


@pytest.mark.parametrize("kernels", [KernelOptions(packed_attention=True),
                                     KernelOptions(fused_heads=True), ALL_KERNELS],
                         ids=["packed_attention", "fused_heads", "ALL_KERNELS"])
def test_load_bundle_passes_float32_with_the_opt_in_kernels_through_the_gate(kernels, tmp_path):
    """Float32 with the head-packed and fused-heads kernels reaches the
    checkpoint (here: its missing tokenizer): tmp_path holds no weights, and
    no card is needed to get there."""
    with pytest.raises(ValueError, match="tokenizer"):
        models.load_bundle("runwayml/stable-diffusion-v1-5", str(tmp_path), dtype="float32",
                           device="cuda", kernels=kernels)


def test_load_bundle_passes_float32_and_bf16_with_options_through_the_gate(tmp_path):
    """Float32 without those options, and bf16 with them, reach the
    checkpoint (here: its missing tokenizer) instead of the dtype gate."""
    for kw in ({"dtype": "float32"}, {"dtype": "float32", "kernels": KernelOptions(
            fused_group_norm=True)}, {"kernels": ALL_KERNELS}):
        with pytest.raises(ValueError, match="tokenizer"):
            models.load_bundle("runwayml/stable-diffusion-v1-5", str(tmp_path),
                               device="cuda", **kw)
