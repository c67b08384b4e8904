"""Single-image CA-energy guidance of the port (`ca_loss`, `guidance_update`
and `sample(..., guidance_batched=False)`) against the JAX package's.

`ca_loss` and `guidance_update` run on seeded taps and guidance data built by
each package's `make_guidance_data` from the same boxes and positions, with
and without reference maps; the taps come from a small differentiable map of
the latents written once in each framework on the same numpy weights.
Tolerance: 1e-5 of the JAX value's largest magnitude for losses and latents
(f32 sorts, sums and one softmax in another order). `sample` runs the
tiny-test UNet of both packages on the same weights (`tests/_torch_tiny.py`)
through guidance with reference-CA transfer and a frozen mask; tolerance
1e-4 of max|latents| (f32 sums in another order through four UNet steps and
up to four guidance gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.core import schedule as jsched
from lmdx.sampling import guidance as jguid
from lmdx.sampling import loop as jloop
from lmdx_torch.core import schedule as tsched
from lmdx_torch.sampling import guidance as tguid
from lmdx_torch.sampling import loop as tloop
from tests._torch_tiny import one_torch_thread, tiny_bundles

LATENT_HW = (16, 16)
NUM_LEVELS = 2
KEYS = (("mid", 0, 0, 0), ("up", 1, 0, 0), ("up", 1, 1, 0))
HEADS, CTX = 2, 77
BOXES = [(0.1, 0.2, 0.5, 0.7), [(0.55, 0.1, 0.9, 0.45), (0.6, 0.6, 0.95, 0.95)]]
POSITIONS = [[3, 4], [6]]
WORDS = [4, 6]
REF_BOX_TO_OBJ = [0, 1, 1]


def _spec(pkg, use_ref_ca, loss_threshold=0.01):
    return pkg.GuidanceSpec(keys=KEYS, loss_scale=5.0, loss_threshold=loss_threshold,
                            max_index_step=3, bg_weight=4.0, use_ref_ca=use_ref_ca)


def _data(use_ref_ca):
    kw = dict(word_token_indices=WORDS, ref_box_to_obj=REF_BOX_TO_OBJ) if use_ref_ca else {}
    jd = jguid.make_guidance_data(BOXES, POSITIONS, _spec(jguid, use_ref_ca), LATENT_HW,
                                  NUM_LEVELS, **kw)
    td = tguid.guidance_data_to_device(
        tguid.make_guidance_data(BOXES, POSITIONS, _spec(tguid, use_ref_ca), LATENT_HW,
                                 NUM_LEVELS, **kw), "cpu")
    return jd, td


def _n(key):
    h, w = tguid.key_resolution(key, LATENT_HW, NUM_LEVELS)
    return h, w


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0.0, 3.0, (4, HEADS * CTX)).astype(np.float32) for k in KEYS}


def _ref(seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for k in KEYS:
        h, w = _n(k)
        m = rng.random((len(REF_BOX_TO_OBJ), HEADS, h * w)).astype(np.float32)
        out[k] = m / m.sum(-1, keepdims=True)
    return out


def _jax_taps(weights):
    H, W = LATENT_HW

    def fn(lat):
        out = {}
        for k in KEYS:
            h, w = _n(k)
            pooled = lat.reshape(1, h, H // h, w, W // w, 4).mean((2, 4)).reshape(1, h * w, 4)
            logits = (pooled @ weights[k]).reshape(1, h * w, HEADS, CTX).transpose(0, 2, 1, 3)
            out[k] = jax.nn.softmax(logits, axis=-1)
        return out
    return fn


def _torch_taps(weights):
    H, W = LATENT_HW
    wt = {k: torch.from_numpy(v) for k, v in weights.items()}

    def fn(lat):
        out = {}
        for k in KEYS:
            h, w = _n(k)
            pooled = lat.reshape(1, h, H // h, w, W // w, 4).mean((2, 4)).reshape(1, h * w, 4)
            logits = (pooled @ wt[k]).reshape(1, h * w, HEADS, CTX).permute(0, 2, 1, 3)
            out[k] = torch.softmax(logits, dim=-1)
        return out
    return fn


def _latents(seed=2):
    return np.random.default_rng(seed).standard_normal((1, *LATENT_HW, 4)).astype(np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-12), (err, np.abs(want).max())


@pytest.mark.parametrize("use_ref_ca", [False, True], ids=["no_ref", "ref_ca"])
def test_ca_loss_matches_jax(use_ref_ca):
    jd, td = _data(use_ref_ca)
    weights, lat = _weights(), _latents()
    ref = _ref() if use_ref_ca else None
    want = jguid.ca_loss(_jax_taps(weights)(jnp.asarray(lat)), jd, _spec(jguid, use_ref_ca),
                         ref_taps=None if ref is None else {k: jnp.asarray(v)
                                                            for k, v in ref.items()})
    got = tguid.ca_loss(_torch_taps(weights)(torch.from_numpy(lat)), td,
                        _spec(tguid, use_ref_ca),
                        ref_taps=None if ref is None else {k: torch.from_numpy(v)
                                                           for k, v in ref.items()})
    assert got.shape == ()
    _close(got.item(), float(want), 1e-5)


# (threshold, carried loss, budget): every iteration runs; the first
# iteration's fresh loss ends the loop; the carried loss is already below the
# threshold, so nothing runs.
LOOPS = [(0.01, 1e4, 3), (6.0, 1e4, 3), (0.5, 1.0, 3)]


@pytest.mark.parametrize("use_ref_ca", [False, True], ids=["no_ref", "ref_ca"])
@pytest.mark.parametrize("threshold,loss_in,max_iter", LOOPS,
                         ids=["full_budget", "stops_after_one", "no_iteration"])
def test_guidance_update_matches_jax(use_ref_ca, threshold, loss_in, max_iter):
    jd, td = _data(use_ref_ca)
    weights, lat = _weights(), _latents()
    ref = _ref() if use_ref_ca else None
    step = 0.7
    want_lat, want_loss = jguid.guidance_update(
        _jax_taps(weights), jnp.asarray(lat), jnp.float32(loss_in), jnp.float32(step),
        jnp.int32(max_iter), jd, _spec(jguid, use_ref_ca, threshold),
        ref_taps=None if ref is None else {k: jnp.asarray(v) for k, v in ref.items()})
    got_lat, got_loss = tguid.guidance_update(
        _torch_taps(weights), torch.from_numpy(lat), torch.tensor(loss_in), step, max_iter,
        td, _spec(tguid, use_ref_ca, threshold),
        ref_taps=None if ref is None else {k: torch.from_numpy(v) for k, v in ref.items()})
    assert got_loss.shape == ()
    _close(got_loss.item(), float(want_loss), 1e-5)
    _close(got_lat.numpy(), np.asarray(want_lat), 1e-5)
    moved = np.abs(np.asarray(want_lat) - lat).max()
    if loss_in < threshold * 5.0:
        assert moved == 0.0 and float(want_loss) == loss_in
    else:
        assert moved > 1e-3                 # the update is large enough to compare
        _close(got_lat.numpy() - lat, np.asarray(want_lat) - lat, 1e-3)


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


def test_sample_single_image_guidance_matches_jax(monkeypatch, bundles):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    cfg = tb.config
    assert (cfg.latent_height, cfg.latent_width) == LATENT_HW

    rng = np.random.default_rng(5)
    steps, frozen = 4, 2
    lat = rng.standard_normal((1, *LATENT_HW, 4)).astype(np.float32)
    text = rng.normal(0, 1, (2, CTX, cfg.unet.cross_attention_dim)).astype(np.float32)
    frozen_mask = np.zeros(LATENT_HW, np.float32)
    frozen_mask[2:9, 3:12] = 1.0
    frozen_lat = rng.standard_normal((frozen + 1, 1, *LATENT_HW, 4)).astype(np.float32)
    ref = {k: np.repeat(v[None], steps, axis=0) for k, v in _ref().items()}
    jd, td = _data(True)
    budgets = [2, 1]

    want = jloop.sample(
        jb.unet, jb.params["unet"], jsched.make_schedule(steps), jnp.asarray(lat),
        jnp.asarray(text), cond_embeddings=jnp.asarray(text[1:]), spec=_spec(jguid, True),
        guidance_data=jd, max_iter=budgets, ref_taps={k: jnp.asarray(v) for k, v in ref.items()},
        frozen_mask=jnp.asarray(frozen_mask), frozen_latents=jnp.asarray(frozen_lat),
        num_frozen_steps=frozen)
    got = tloop.sample(
        tb.unet, tsched.make_schedule(steps), torch.from_numpy(lat), torch.from_numpy(text),
        cond_embeddings=torch.from_numpy(text[1:]), spec=_spec(tguid, True), guidance_data=td,
        max_iter=budgets, ref_taps={k: torch.from_numpy(v) for k, v in ref.items()},
        frozen_mask=torch.from_numpy(frozen_mask), frozen_latents=torch.from_numpy(frozen_lat),
        num_frozen_steps=frozen, guidance_batched=False)
    assert got.final_loss.shape == ()
    _close(got.final_loss.item(), float(want.final_loss), 1e-4)
    _close(got.latents.numpy(), np.asarray(want.latents), 1e-4)
