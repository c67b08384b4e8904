"""The port's batched training-free LMD (`run_lmd_batch`: per-box guidance,
attention-prompted SAM masks, host alignment with shifted reference taps)
and batched LMD+ with the same SAM segmenter, against the JAX package's on
the tiny-test config with the tiny SAM.

Both sides run the same weights (the JAX bundle's parameters converted for
the port; the port's SAM state dict mapped onto the Flax tree by the JAX
side's `convert_sam`) and the same noise (the JAX side with
LMDX_NOISE_BACKEND=torch draws the port's torch stream); both segmenters
compute in f32. Tolerance, as tests/test_torch_slice.py: frozen masks,
foreground indices and per-box masks identical; images within 2 uint8
levels (f32 sums in other orders through two sampling passes and the VAE).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.methods import batch as jbatch
from lmdx.nn import sam as jsam
from lmdx.runtime import models as jmodels
from lmdx_torch import config as tconfig
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.nn import sam as tsam
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels

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
OVERRIDES = dict(max_iter=1, overall_max_iter=1, max_index_step=2,
                 overall_max_index_step=2, num_inference_steps=5)


@pytest.fixture(scope="module")
def models():
    jb = jmodels.load_bundle("tiny-test", seed=0)
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    tb = tmodels.build_bundle(tconfig.tiny_test(),
                              convert.from_jax_params(params, tconfig.tiny_test()),
                              device="cpu")
    sam = tmodels.build_sam(tsam.tiny_sam(), seed=0, device="cpu", dtype=torch.float32)
    tree = jsam.convert_sam({k: v.numpy() for k, v in sam.state_dict().items()},
                            jsam.tiny_sam())
    jseg = jsam.FlaxSamSegmenter(tree, jsam.tiny_sam(), dtype=jnp.float32)
    return jb, tb, jseg, tsam.SamSegmenter(sam)


@pytest.mark.parametrize("method", ["run_lmd_batch", "run_lmd_plus_batch"])
def test_batch_with_sam_matches_jax(monkeypatch, models, method):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb, tb, jseg, tseg = models
    want = getattr(jbatch, method)(SPECS, jb, segmenter=jseg, bg_seeds=[1, 2], **OVERRIDES)
    got = getattr(tbatch, method)(SPECS, tb, segmenter=tseg, bg_seeds=[1, 2], **OVERRIDES)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.image.dtype == np.uint8 and g.image.shape == w.image.shape
        for gm, wm in zip(g.aux["masks"], w.aux["masks"]):
            np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_array_equal(g.aux["frozen_mask"], w.aux["frozen_mask"])
        np.testing.assert_array_equal(g.aux["foreground_indices"],
                                      w.aux["foreground_indices"])
        diff = np.abs(g.image.astype(np.int32) - w.image.astype(np.int32))
        assert diff.max() <= 2, diff.max()
    assert all(g.aux["frozen_mask"].sum() > 0 for g in got)
    assert (got[0].image != got[1].image).any()
