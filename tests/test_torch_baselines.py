"""The port's baselines (`methods.sd`, `methods.gligen`,
`methods.backward_guidance`) against the JAX package's on the tiny-test
config, and the port's method registry against the JAX one (BoxDiff and
MultiDiffusion have their own files).

Both sides run the same weights (the JAX side's tiny-test parameters
converted for the port, `tests/_torch_tiny.py`) and the same noise (the JAX side with LMDX_NOISE_BACKEND=torch draws the port's torch
stream). Tolerance: the latents handed to the VAE within 1e-4 of their
largest value (f32 sums in other orders; about 2e-6 is seen, and swapping
GLIGEN's two boxes moves them by 3.5e-3), images within 2 uint8 levels. Backward guidance runs at its
published settings (loss scale 30, threshold 0.2, 5 iterations over the
first 10 steps), so every one of the 6 steps here is guided.
"""

import numpy as np
import pytest

import lmdx.methods as jmethods
from lmdx.methods import base as jbase
from lmdx_torch import methods as tmethods
from lmdx_torch.methods import base as tbase
from tests._torch_tiny import one_torch_thread, record_decodes, tiny_bundles

SPECS = [
    {"prompt": "A realistic scene with a red cube and a blue ball",
     "gen_boxes": [("a red cube", (50, 300, 120, 120)),
                   ("a blue ball", (300, 280, 100, 100))],
     "bg_prompt": "A realistic scene", "extra_neg_prompt": ""},
    {"prompt": "A park with a green tree and a red bench",
     "gen_boxes": [("a green tree", (200, 100, 150, 250)),
                   ("a red bench", (20, 350, 160, 100))],
     "bg_prompt": "A park", "extra_neg_prompt": "people"},
]


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


@pytest.mark.parametrize("spec", SPECS, ids=["layout_a", "layout_b"])
@pytest.mark.parametrize("name", ["sd", "gligen", "backward_guidance"])
def test_baseline_matches_jax(monkeypatch, bundles, name, spec):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    want_latents, got_latents = record_decodes(monkeypatch, jbase, tbase)
    want = jmethods.get_method(name).run(spec, jb, bg_seed=3, num_inference_steps=6)
    got = tmethods.get_method(name).run(spec, tb, bg_seed=3, num_inference_steps=6)
    assert len(got_latents) == len(want_latents) == 1
    np.testing.assert_allclose(got_latents[0], want_latents[0], rtol=0,
                               atol=1e-4 * np.abs(want_latents[0]).max())
    assert got.image.dtype == np.uint8 and got.image.shape == want.image.shape
    diff = np.abs(got.image.astype(np.int32) - want.image.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert got.image.std() > 0


@pytest.mark.parametrize("n_boxes", [0, 2, 11])   # tiny-test holds at most 8 objects
def test_make_gligen_inputs_matches_jax(bundles, n_boxes):
    """The packing (truncation, phrase order, zero embeddings without boxes)
    on the same weights: both halves of the CFG-doubled tokens and the
    guidance tokens, within 1e-4 of the largest value."""
    jb, tb = bundles
    rng = np.random.default_rng(n_boxes)
    corners = np.sort(rng.uniform(0.0, 1.0, (n_boxes, 2, 2)), axis=1)
    bboxes = [tuple(map(float, c.T.reshape(-1)[[0, 2, 1, 3]])) for c in corners]
    phrases = [f"object number {i}" for i in range(n_boxes)]
    want = [np.asarray(x) for x in jbase.make_gligen_inputs(jb, bboxes, phrases)]
    with one_torch_thread():
        got = [x.numpy() for x in tbase.make_gligen_inputs(tb, bboxes, phrases)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_gligen_grounding_reaches_the_latents(monkeypatch, bundles):
    """The fuser gates of the tiny bundle are open: the same phrases with
    their boxes swapped move the final latents by more than ten times the
    parity tolerance above, so that parity sees the grounding."""
    spec = SPECS[0]
    (p0, b0), (p1, b1) = spec["gen_boxes"]
    swapped = dict(spec, gen_boxes=[(p0, b1), (p1, b0)])
    (latents,) = record_decodes(monkeypatch, tbase)
    with one_torch_thread():
        for s in (spec, swapped):
            tmethods.get_method("gligen").run(s, bundles[1], bg_seed=3,
                                              num_inference_steps=6)
    a, b = latents
    assert np.abs(a - b).max() > 1e-3 * np.abs(a).max()


def test_scheduler_other_than_ddim_is_refused(bundles):
    # DPM-Solver++(2M) is ported (tests/test_torch_dpm_invert.py); Euler, the
    # SDXL refiner's sigma-space solver, is the one still refused.
    with pytest.raises(NotImplementedError):
        tmethods.get_method("sd").run(SPECS[0], bundles[1], scheduler="euler")


@pytest.mark.parametrize("name,version", [("lmd-plus", "lmd_plus"), ("lmd_plus", "lmd_plus"),
                                          ("backward-guidance", "backward_guidance"),
                                          ("sd", "sd")])
def test_get_method_normalises_names(name, version):
    assert tmethods.get_method(name).version == version
    assert tmethods.get_method(name) is tmethods.METHODS[version]


def test_get_method_refuses_an_unknown_name():
    with pytest.raises(KeyError, match="available"):
        tmethods.get_method("dalle")


def test_registry_is_the_jax_registry():
    assert set(tmethods.METHODS) == set(jmethods.METHODS)
    for name, module in tmethods.METHODS.items():
        assert module.version == name
