"""The port's tensor split at tp 2 (`lmdx_torch/dist/mesh.py::shard_params`)
against the JAX package's UNet unsplit, on the CPU in two gloo processes.

Both packages take the tiny-test weights (`tests/_torch_tiny.py`, GLIGEN
gates open, biases drawn non-zero): one UNet forward at batch 2 with grounding tokens, and the
latents' gradient through the guidance loss (`ca_loss`, reference-CA term
on) computed from the taps the split cross-attentions gather over heads.
Tiny-test has 2 heads, so each rank computes one; the gradient passes the
column-split inputs' all-reduce and the head gather's slice. Tolerance: 1e-4
of the JAX value's max |x| (float32 sums split over two ranks and taken in
another order). Once with the default kernels and once with every opt-in
kernel (`ALL_KERNELS`: the fused-heads forward at the local head count and
the fused GroupNorm, on their plain versions here). Both ranks return the
same bits: the row-split outputs are all-reduced, so every rank holds the
whole activation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lmdx.nn import unet as junet
from lmdx.runtime import models as jmodels
from lmdx.sampling import guidance as jguid
from lmdx_torch.runtime import convert
from lmdx_torch.sampling import guidance as tguid
from tests._torch_dist import run_ranks
from tests._torch_tiny import tiny_params

KEYS = (("mid", 0, 0, 0), ("up", 1, 0, 0), ("up", 1, 1, 0))
BOXES = [(0.1, 0.2, 0.5, 0.7), [(0.55, 0.1, 0.9, 0.45), (0.6, 0.6, 0.95, 0.95)]]
POSITIONS = [[3, 4], [6]]
WORDS = [4, 6]
REF_BOX_TO_OBJ = [0, 1, 1]
SPEC = dict(keys=KEYS, loss_scale=5.0, loss_threshold=0.01, max_index_step=3,
            bg_weight=4.0, use_ref_ca=True)
TOL = 1e-4


def _inputs():
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = (rng.standard_normal((2, 77, 32)) * 0.5).astype(np.float32)
    objs = (rng.standard_normal((2, 8, 32)) * 0.5).astype(np.float32)
    ref = {}
    for k in KEYS:
        h, w = tguid.key_resolution(k, (16, 16), 2)
        m = rng.random((len(REF_BOX_TO_OBJ), 2, h * w)).astype(np.float32)
        ref[k] = m / m.sum(-1, keepdims=True)
    return lat, ctx, objs, ref


def _with_biases(params, seed=5):
    """tiny_params with every bias drawn N(0, 0.1^2) instead of zero, so a
    row-split layer's bias added once per rank (not once after the sum)
    shows."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(0.0, 0.1, x.shape).astype(np.float32)
                         if path[-1].key == "bias" else x), params)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    params = _with_biases(tiny_params(0))
    cfg = jmodels.SD_CONFIGS["tiny-test"]()
    lat, ctx, objs, ref = _inputs()
    kw = dict(word_token_indices=WORDS, ref_box_to_obj=REF_BOX_TO_OBJ)
    jspec = jguid.GuidanceSpec(**SPEC)
    jdata = jguid.make_guidance_data(BOXES, POSITIONS, jspec, (16, 16), 2, **kw)
    unet = junet.UNet2DCondition(cfg.unet, dtype=jnp.float32)
    eps = jax.jit(lambda p, x, c, o: junet.apply_unet(unet, p, x, 501, c, objs=o)[0])(
        params["unet"], lat, ctx, objs)

    def loss(p, x, c, o, r):
        taps = junet.apply_unet(unet, p, x, 501, c, objs=o, taps=jspec.tap_spec,
                                stop_after_taps=True)[1]
        return jguid.ca_loss(taps, jdata, jspec, ref_taps=r)

    jloss, grad = jax.jit(jax.value_and_grad(loss, argnums=1))(
        params["unet"], lat[:1], ctx[1:], objs[1:], ref)
    tdata = tguid.make_guidance_data(BOXES, POSITIONS, tguid.GuidanceSpec(**SPEC), (16, 16),
                                     2, **kw)
    args = {"state_dicts": convert.from_jax_params(params, cfg), "lat": lat, "ctx": ctx,
            "objs": objs, "ref": ref, "spec": SPEC, "data": tdata}
    ranks = run_ranks("tp_unet", 2, args, tmp_path_factory.mktemp("tp"))
    want = {"eps": np.asarray(eps), "grad": np.asarray(grad), "loss": float(jloss)}
    return ranks, want


def _close(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("what", ["eps", "grad", "loss"])
@pytest.mark.parametrize("options", ["default", "all_kernels"])
def test_tp2_unet_matches_jax_unsplit(results, options, what):
    ranks, want = results
    for rank in ranks:
        _close(rank[options][what], want[what])


@pytest.mark.parametrize("options", ["default", "all_kernels"])
def test_tp2_ranks_agree_and_hold_half_the_heads(results, options):
    ranks, _ = results
    r0, r1 = (r[options] for r in ranks)
    for what in ("eps", "grad"):
        np.testing.assert_array_equal(r0[what], r1[what])
    # One of the two heads per rank; the taps carry both (gathered).
    assert r0["heads"] == [1]
    assert all(s[1] == 2 for s in r0["tap_shapes"].values())
    name = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    assert r0["shapes"][f"{name}.to_q.weight"] == (16, 32)
    assert r0["shapes"][f"{name}.to_out.0.weight"] == (32, 16)
    assert r0["shapes"][f"{name}.to_out.0.bias"] == (32,)
    ff = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net"
    assert r0["shapes"][f"{ff}.0.proj.weight"] == (128, 32)
    assert r0["shapes"][f"{ff}.2.weight"] == (32, 64)
