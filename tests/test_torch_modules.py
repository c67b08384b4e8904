"""Port modules (lmdx_torch/) held against the JAX package on the CPU at toy
sizes: the same weights (the JAX side's parameters converted with
`lmdx_torch.runtime.convert`) and the same inputs (numpy, seeded) go through
both, and the outputs are compared in f32.

Tolerances: 1e-5 abs+rel for single layers (f32 sums in other orders); 1e-4
for the tiny UNet, CLIP and VAE stacks and the guidance update, whose errors
accumulate over a dozen layers; bit-exact for the noise and the host-side
grids and masks, which are the same numpy code.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.core import schedule as jsched
from lmdx.nn import attention as jatt
from lmdx.nn.unet import apply_unet as japply_unet
from lmdx.runtime import models as jmodels
from lmdx.sampling import guidance as jguid
from lmdx.sampling import latents as jlat
from lmdx_torch import config as tconfig
from lmdx_torch.core import schedule as tsched
from lmdx_torch.nn import attention as tatt
from lmdx_torch.nn.unet import apply_unet as tapply_unet
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.sampling import guidance as tguid
from lmdx_torch.sampling import latents as tlat


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def bundles():
    jb = jmodels.load_bundle("tiny-test", seed=0)
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    tb = tmodels.build_bundle(tconfig.tiny_test(), convert.from_jax_params(
        params, tconfig.tiny_test()), device="cpu")
    return jb, tb


def _port_module(module, jparams):
    module.load_state_dict(convert.state_dict_from_tree(
        jax.tree_util.tree_map(np.asarray, jparams)), strict=True)
    return module.eval()


# ---- schedule and noise ----------------------------------------------------

def test_schedule_grids_match():
    for n in (6, 50):
        j, t = jsched.make_schedule(n), tsched.make_schedule(n)
        np.testing.assert_array_equal(np.asarray(j.timesteps), t.timesteps)
        np.testing.assert_array_equal(np.asarray(j.prev_timesteps), t.prev_timesteps)
        np.testing.assert_array_equal(np.asarray(j.alphas_cumprod), t.alphas_cumprod)


def test_ddim_step_matches():
    rng = np.random.default_rng(0)
    s_j, s_t = jsched.make_schedule(50), tsched.make_schedule(50)
    x, eps = _rand(rng, 2, 4, 4, 4), _rand(rng, 2, 4, 4, 4)
    for t, prev in ((981, 961), (21, 1), (1, -19)):
        want = jsched.ddim_step(s_j, jnp.asarray(eps), jnp.int32(t), jnp.int32(prev),
                                jnp.asarray(x))
        got = tsched.ddim_step(s_t, torch.tensor(eps), t, prev, torch.tensor(x))
        _close(got, want, 1e-6)
        assert tsched.guidance_step_size(s_t, t) == pytest.approx(
            float(jsched.guidance_step_size(s_j, jnp.int32(t))), rel=1e-7)


def test_noise_and_input_latents_bit_exact(monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    np.testing.assert_array_equal(
        tlat.noise_from_seed(7, (1, 8, 8, 4)),
        np.asarray(jlat.noise_from_seed(7, (1, 8, 8, 4))))
    masks = [np.pad(np.ones((3, 4), np.float32), ((1, 4), (2, 2))),
             np.pad(np.ones((5, 2), np.float32), ((0, 3), (5, 1)))]
    j_list, j_bg = jlat.get_input_latents_list(3, 20, masks, (1, 8, 8, 4),
                                               fg_blending_ratio=0.1)
    t_list, t_bg = tlat.get_input_latents_list(3, 20, masks, (1, 8, 8, 4),
                                               fg_blending_ratio=0.1)
    np.testing.assert_array_equal(t_bg, np.asarray(j_bg))
    for a, b in zip(t_list, j_list):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---- attention layers ------------------------------------------------------

@pytest.mark.parametrize("cond_only,single_token", [(False, False), (True, True)])
def test_cross_attention_with_taps(cond_only, single_token):
    rng = np.random.default_rng(1)
    x, ctx = _rand(rng, 4, 16, 32), _rand(rng, 4, 7, 24)
    tok = np.array([2, 5], np.int64)
    jmod = jatt.CrossAttention(query_dim=32, heads=2, head_dim=16, context_dim=24,
                               tap_name="down_0_0_0")
    jp = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(ctx))["params"]
    spec_j = jatt.TapSpec(keys=(("down", 0, 0, 0),), cond_only=cond_only,
                          single_token=single_token)
    want, taps = jmod.apply({"params": jp}, jnp.asarray(x), jnp.asarray(ctx),
                            taps=spec_j, tap_token_index=jnp.asarray(tok, jnp.int32),
                            mutable=["taps"])
    tmod = _port_module(tatt.CrossAttention(32, 2, 16, context_dim=24,
                                            tap_name="down_0_0_0"), jp)
    spec_t = tatt.TapSpec(keys=(("down", 0, 0, 0),), cond_only=cond_only,
                          single_token=single_token)
    out = {}
    got = tmod(torch.tensor(x), torch.tensor(ctx), taps=spec_t,
               tap_token_index=tok, taps_out=out)
    _close(got, want)
    _close(out[("down", 0, 0, 0)], taps["taps"]["down_0_0_0"])


def test_gated_self_attention_and_flash_path():
    """The fuser: visual rows over [visual | objs], Lk = 256 + 8 takes the
    flash path on the port side (plain version on the CPU)."""
    rng = np.random.default_rng(2)
    x, objs = _rand(rng, 2, 256, 32), _rand(rng, 2, 8, 24)
    jmod = jatt.GatedSelfAttention(query_dim=32, context_dim=24, heads=2, head_dim=16)
    jp = jmod.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(objs))["params"]
    jp = dict(jp, alpha_attn=jnp.float32(0.7), alpha_dense=jnp.float32(-0.4))
    want = jmod.apply({"params": jp}, jnp.asarray(x), jnp.asarray(objs))
    tmod = _port_module(tatt.GatedSelfAttention(32, 24, 2, 16), jp)
    _close(tmod(torch.tensor(x), torch.tensor(objs)), want)


def test_transformer2d():
    rng = np.random.default_rng(3)
    x, ctx, objs = _rand(rng, 2, 16, 16, 32), _rand(rng, 2, 7, 24), _rand(rng, 2, 8, 24)
    jmod = jatt.Transformer2D(channels=32, heads=2, head_dim=16, context_dim=24,
                              norm_num_groups=8, use_gated_attention=True,
                              tap_prefix="up_1_0")
    jp = jmod.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(ctx),
                   objs=jnp.asarray(objs))["params"]
    want = jmod.apply({"params": jp}, jnp.asarray(x), jnp.asarray(ctx),
                      objs=jnp.asarray(objs))
    tmod = _port_module(tatt.Transformer2D(32, 2, 24, 1, 8, tap_prefix="up_1_0",
                                           use_gated_attention=True), jp)
    got = tmod(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(ctx),
               objs=torch.tensor(objs))
    _close(got.permute(0, 2, 3, 1), want, 1e-4)


# ---- full networks at tiny-test -----------------------------------------------

def test_unet_forward_and_early_exit_taps(bundles):
    jb, tb = bundles
    rng = np.random.default_rng(4)
    lat, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 77, 32)
    objs = _rand(rng, 2, 8, 32)
    want, _ = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), 501,
                          jnp.asarray(ctx), objs=jnp.asarray(objs))
    got, _ = tapply_unet(tb.unet, torch.tensor(lat), 501, torch.tensor(ctx),
                         objs=torch.tensor(objs))
    _close(got, want, 1e-4)

    keys = tguid.default_guidance_keys(tb.config.unet)
    _, jtaps = japply_unet(jb.unet, jb.params["unet"], jnp.asarray(lat), 501,
                           jnp.asarray(ctx), objs=jnp.asarray(objs),
                           taps=jguid.GuidanceSpec(keys=keys).tap_spec,
                           stop_after_taps=True)
    eps, ttaps = tapply_unet(tb.unet, torch.tensor(lat), 501, torch.tensor(ctx),
                             objs=torch.tensor(objs),
                             taps=tguid.GuidanceSpec(keys=keys).tap_spec,
                             stop_after_taps=True)
    assert eps is None and set(ttaps) == set(jtaps) == set(keys)
    for k in keys:
        _close(ttaps[k], jtaps[k], 1e-4)


def test_clip_encode_text(bundles):
    jb, tb = bundles
    texts = ["a red cube", "A realistic scene with a red cube and a blue ball", ""]
    jh, jp = jmodels.encode_text(jb, texts)
    th, tp = tmodels.encode_text(tb, texts)
    _close(th, jh, 1e-4)
    _close(tp, jp, 1e-4)


def test_vae_decode(bundles):
    from lmdx.methods import base as jbase
    from lmdx_torch.methods import base as tbase

    jb, tb = bundles
    lat = _rand(np.random.default_rng(5), 2, 16, 16, 4)
    want = jb.vae.apply({"params": jb.params["vae"]}, jnp.asarray(lat),
                        method=jb.vae.__class__.decode)
    got = tb.vae(torch.tensor(lat))
    _close(got, want, 1e-4)
    diff = np.abs(tbase.decode_latents(tb, torch.tensor(lat)).astype(int)
                  - jbase.decode_latents(jb, jnp.asarray(lat)).astype(int))
    assert diff.max() <= 1  # uint8 rounding of values that agree to 1e-4


def test_gligen_objs(bundles):
    jb, tb = bundles
    rng = np.random.default_rng(6)
    boxes = rng.random((2, 8, 4), dtype=np.float32)
    masks = np.array([[1, 1, 0, 0, 0, 0, 0, 0], [0] * 8], np.float32)
    embs = _rand(rng, 2, 8, 32)
    _close(tmodels.gligen_objs(tb, boxes, masks, embs),
           jmodels.gligen_objs(jb, boxes, masks, embs), 1e-5)


def test_prepare_gligen_condition():
    from lmdx.sampling.gligen import prepare_gligen_condition as jprep
    from lmdx_torch.sampling.gligen import prepare_gligen_condition as tprep

    embs = _rand(np.random.default_rng(9), 3, 32)
    boxes = [[0.1, 0.2, 0.3, 0.4], [0.5, 0.5, 0.9, 0.8], [0.0, 0.0, 1.0, 1.0]]
    for got, want in zip(tprep(boxes, embs, max_objs=8, num_images_per_prompt=2),
                         jprep(boxes, embs, max_objs=8, num_images_per_prompt=2)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_load_bundle_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodels.load_bundle("tiny-test")
    assert tmodels.load_bundle("tiny-test", device="cpu").device.type == "cpu"


# ---- guidance --------------------------------------------------------------

def _guidance_case(spec_j, spec_t, latent_hw=(16, 16), levels=2):
    bboxes = [[[0.1, 0.1, 0.5, 0.6]], [[0.55, 0.5, 0.9, 0.95], [0.1, 0.7, 0.3, 0.9]]]
    positions, wt, ref = [[3, 4], [6, 7, 8]], [4, 8], [0, 1, 1]
    kw = dict(word_token_indices=wt, ref_box_to_obj=ref, max_objs=2, max_positions=4,
              max_ref_boxes=4)
    jd = jguid.make_guidance_data(bboxes, positions, spec_j, latent_hw, levels, **kw)
    td = tguid.make_guidance_data(bboxes, positions, spec_t, latent_hw, levels, **kw)
    return jd, td


def _specs(keys):
    kw = dict(keys=keys, loss_scale=5.0, loss_threshold=5.0, fg_weight=1.0,
              bg_weight=4.0, use_ref_ca=True, max_index_step=2)
    return jguid.GuidanceSpec(**kw), tguid.GuidanceSpec(**kw)


def test_make_guidance_data_and_ca_loss_batched():
    keys = (("mid", 0, 0, 0), ("up", 1, 0, 0))
    spec_j, spec_t = _specs(keys)
    jd, td = _guidance_case(spec_j, spec_t)
    for name in ("positions", "pos_valid", "pos_count", "obj_valid", "box_word_idx",
                 "box_weight"):
        np.testing.assert_array_equal(td[name], np.asarray(jd[name]))
    for k in keys:
        for name in ("masks", "kfg", "kbg", "ref_masks"):
            np.testing.assert_array_equal(td[name][k], np.asarray(jd[name][k]))

    rng = np.random.default_rng(7)
    taps = {k: rng.random((2, 2, int(np.prod(jguid.key_resolution(k, (16, 16), 2))), 77),
                          dtype=np.float32) for k in keys}
    refs = {k: rng.random((2, 4, 2, taps[k].shape[2]), dtype=np.float32) for k in keys}
    jdata = jguid.stack_guidance_data([jd, jd])
    tdata = tguid.stack_guidance_data([td, td], "cpu")

    def jloss(t):
        return jguid.ca_loss_batched(t, jdata, spec_j, {k: jnp.asarray(v)
                                                         for k, v in refs.items()})

    jl, jgrad = jax.value_and_grad(lambda t: jloss(t).sum())(
        {k: jnp.asarray(v) for k, v in taps.items()})
    tt = {k: torch.tensor(v, requires_grad=True) for k, v in taps.items()}
    tl = tguid.ca_loss_batched(tt, tdata, spec_t, {k: torch.tensor(v) for k, v in refs.items()})
    tl.sum().backward()
    _close(tl, jloss({k: jnp.asarray(v) for k, v in taps.items()}))
    for k in keys:
        _close(tt[k].grad, jgrad[k])


def test_guidance_update_batched_through_the_unet(bundles):
    """Two guidance iterations through the tiny UNet's early-exit forward;
    image 1 starts below the threshold and must stay frozen."""
    jb, tb = bundles
    keys = tguid.default_guidance_keys(tb.config.unet)
    spec_j, spec_t = _specs(keys)
    spec_t = dataclasses.replace(spec_t, use_ref_ca=False)
    spec_j = dataclasses.replace(spec_j, use_ref_ca=False)
    jd, td = _guidance_case(spec_j, spec_t)
    rng = np.random.default_rng(8)
    lat, ctx = _rand(rng, 2, 16, 16, 4), _rand(rng, 2, 77, 32)
    loss_in = np.array([100.0, 1.0], np.float32)

    def junet(x):
        return japply_unet(jb.unet, jb.params["unet"], x, 701, jnp.asarray(ctx),
                           taps=spec_j.tap_spec, stop_after_taps=True)[1]

    def tunet(x):
        return tapply_unet(tb.unet, x, 701, torch.tensor(ctx), taps=spec_t.tap_spec,
                           stop_after_taps=True)[1]

    jlat_, jl = jguid.guidance_update_batched(
        junet, jnp.asarray(lat), jnp.asarray(loss_in), 0.9, jnp.int32(2),
        jguid.stack_guidance_data([jd, jd]), spec_j)
    tlat_, tl = tguid.guidance_update_batched(
        tunet, torch.tensor(lat), torch.tensor(loss_in), 0.9, 2,
        tguid.stack_guidance_data([td, td], "cpu"), spec_t)
    _close(tlat_, jlat_, 1e-4)
    _close(tl, jl, 1e-4)
    np.testing.assert_array_equal(tlat_[1].numpy(), lat[1])
