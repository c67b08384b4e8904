"""The port's single-image LMD and LMD+ (`methods.lmd.run`,
`methods.lmd_plus.run` over `run_grounded`) against the JAX package's on the
tiny-test config: two layouts and the layout without boxes each; LMD with
the weightless CoarseSegmenter and once with the tiny SAM.

Both sides run the same weights (the JAX side's tiny-test parameters
converted for the port, `tests/_torch_tiny.py`; the port's SAM state dict
mapped onto the Flax tree by the JAX side's `convert_sam`) and
the same noise (the JAX side with LMDX_NOISE_BACKEND=torch draws the port's
torch stream). Tolerance, as tests/test_torch_slice.py: per-box masks,
frozen masks and foreground indices identical; images and per-box images
within 2 uint8 levels (f32 sums in other orders through two sampling passes
and the VAE). The latents of both passes, as handed to the VAE, are held
within 1e-4 of their largest value (about 2e-6 is seen): the tiny VAE's
uint8 images alone would not see the overall pass's GLIGEN grounding. The
layouts have two boxes each, for the reason given in that file's docstring.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.methods import base as jbase
from lmdx.methods import lmd as jlmd
from lmdx.methods import lmd_plus as jlmd_plus
from lmdx.nn import sam as jsam
from lmdx_torch.methods import base as tbase
from lmdx_torch.methods import lmd as tlmd
from lmdx_torch.methods import lmd_plus as tlmd_plus
from lmdx_torch.nn import sam as tsam
from lmdx_torch.runtime import models as tmodels
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
    {"prompt": "A sunset over the sea", "gen_boxes": [],
     "bg_prompt": "A sunset over the sea", "extra_neg_prompt": ""},
]
LAYOUTS = ["two_boxes_a", "two_boxes_b", "no_boxes"]
OVERRIDES = dict(max_iter=1, overall_max_iter=1, max_index_step=2,
                 overall_max_index_step=2, num_inference_steps=5)


@pytest.fixture(scope="module")
def bundles():
    with one_torch_thread():
        yield tiny_bundles()


def _images_close(got, want):
    assert got.dtype == np.uint8 and got.shape == np.asarray(want).shape
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 2, diff.max()


def _check(got, want, n_boxes, latents):
    want_latents, got_latents = latents
    # The per-box pass (when there are boxes), then the overall pass.
    assert len(got_latents) == len(want_latents) == (2 if n_boxes else 1)
    for g, w in zip(got_latents, want_latents):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    _images_close(got.image, want.image)
    np.testing.assert_array_equal(got.aux["frozen_mask"], want.aux["frozen_mask"])
    np.testing.assert_array_equal(got.aux["foreground_indices"],
                                  want.aux["foreground_indices"])
    assert len(got.aux["masks"]) == len(want.aux["masks"]) == n_boxes
    for gm, wm in zip(got.aux["masks"], want.aux["masks"]):
        np.testing.assert_array_equal(gm, np.asarray(wm))
    assert len(got.so_img_list) == len(want.so_img_list) == n_boxes
    for gi, wi in zip(got.so_img_list, want.so_img_list):
        _images_close(gi, wi)
    assert (got.aux["frozen_mask"].sum() > 0) == (n_boxes > 0)


@pytest.mark.parametrize("spec", SPECS, ids=LAYOUTS)
@pytest.mark.parametrize("method", ["lmd_plus", "lmd"])
def test_single_image_method_matches_jax(monkeypatch, bundles, method, spec):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    jmod, tmod = {"lmd_plus": (jlmd_plus, tlmd_plus), "lmd": (jlmd, tlmd)}[method]
    latents = record_decodes(monkeypatch, jbase, tbase)
    want = jmod.run(spec, jb, **OVERRIDES)
    got = tmod.run(spec, tb, **OVERRIDES)
    _check(got, want, len(spec["gen_boxes"]), latents)


def test_lmd_with_sam_matches_jax(monkeypatch, bundles):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb = bundles
    sam = tmodels.build_sam(tsam.tiny_sam(), seed=0, device="cpu", dtype=torch.float32)
    tree = jsam.convert_sam({k: v.numpy() for k, v in sam.state_dict().items()},
                            jsam.tiny_sam())
    jseg = jsam.FlaxSamSegmenter(tree, jsam.tiny_sam(), dtype=jnp.float32)
    latents = record_decodes(monkeypatch, jbase, tbase)
    want = jlmd.run(SPECS[0], jb, segmenter=jseg, **OVERRIDES)
    got = tlmd.run(SPECS[0], tb, segmenter=tsam.SamSegmenter(sam), **OVERRIDES)
    _check(got, want, 2, latents)
