"""Batched LMD+ and LMD under a mesh (`lmdx_torch/methods/batch.py` with
`dist/serve.py::activate_mesh`) on the CPU in gloo processes.

- dp 2 x tp 2 (4 ranks): `run_lmd_plus_batch` on four copies of the JAX
  package's two-box layout with its seeds and settings
  (`tests/test_dist.py::test_batched_pipeline_under_mesh_matches_unsharded`)
  is within 1 uint8 level of the JAX package's unsharded images on the same
  weights (`tests/_torch_tiny.py`) and noise (LMDX_NOISE_BACKEND=torch: the
  JAX side draws the port's torch stream), on every rank.
- dp 2 (2 ranks): each dp row runs its two images and every rank returns
  all four; each row's images equal bit for bit the port's own run of that
  sub-batch in one process without a mesh, for `run_lmd_plus_batch` and for
  `run_lmd_batch` (its host-side alignment and the CA-energy guidance of the
  per-box pass). Against the one-process batch of four they are within 1
  uint8 level (float sums may differ with the batch).
"""

import jax
import numpy as np
import pytest

from lmdx.methods import batch as jbatch
from lmdx_torch.config import SD_CONFIGS
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.runtime import convert
from tests._torch_dist import run_ranks
from tests._torch_tiny import one_torch_thread, tiny_bundles, tiny_params

SPEC = {
    "prompt": "A realistic scene with a red cube and a blue ball",
    "gen_boxes": [("a red cube", (50, 300, 120, 120)),
                  ("a blue ball", (300, 280, 100, 100))],
    "bg_prompt": "A realistic scene",
    "extra_neg_prompt": "",
}
KWARGS = dict(bg_seeds=[0, 1, 2, 3], fg_seed_starts=[100] * 4, num_inference_steps=4,
              overall_max_iter=1, overall_max_index_step=2)
LMD_KWARGS = dict(KWARGS, max_iter=1, max_index_step=2)


@pytest.fixture(scope="module")
def state_dicts():
    return convert.from_jax_params(tiny_params(0), SD_CONFIGS["tiny-test"]())


def _args(state_dicts, method, dp, tp, kwargs, own=False):
    return {"state_dicts": state_dicts, "method": method, "dp": dp, "tp": tp,
            "specs": [SPEC] * 4, "kwargs": kwargs, "own": own}


def test_lmd_plus_dp2_tp2_within_one_level_of_jax(state_dicts, tmp_path, monkeypatch):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")  # the port's noise stream
    jb, _ = tiny_bundles()
    want = np.stack([r.image for r in jbatch.run_lmd_plus_batch([SPEC] * 4, jb, **KWARGS)])
    jax.clear_caches()
    ranks = run_ranks("batch", 4, _args(state_dicts, "lmd_plus", 2, 2, KWARGS), tmp_path)
    for r in ranks:
        assert r["local_batches"] == [2]  # each dp row ran its two images
        assert r["images"].shape == want.shape and r["images"].dtype == np.uint8
        assert np.abs(r["images"].astype(int) - want.astype(int)).max() <= 1
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["images"], ranks[0]["images"])


@pytest.fixture(scope="module")
def dp2(state_dicts, tmp_path_factory):
    out = {}
    for method, kwargs in (("lmd_plus", KWARGS), ("lmd", LMD_KWARGS)):
        out[method] = run_ranks("batch", 2, _args(state_dicts, method, 2, 1, kwargs, own=True),
                                tmp_path_factory.mktemp(method))
    return out


@pytest.mark.parametrize("method", ["lmd_plus", "lmd"])
def test_dp2_rows_equal_their_one_process_sub_batch(dp2, method):
    ranks = dp2[method]
    assert [r["dp_index"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["local_batches"] == [2]
        i = r["dp_index"]
        np.testing.assert_array_equal(r["images"][2 * i:2 * i + 2], r["own"])
    np.testing.assert_array_equal(ranks[0]["images"], ranks[1]["images"])


@pytest.mark.parametrize("method", ["lmd_plus", "lmd"])
def test_dp2_within_one_level_of_the_whole_batch(dp2, state_dicts, method):
    from lmdx_torch.runtime import models as tmodels

    bundle = tmodels.build_bundle(SD_CONFIGS["tiny-test"](), state_dicts, device="cpu")
    run = getattr(tbatch, f"run_{method}_batch")
    with one_torch_thread():
        whole = np.stack([r.image for r in run([SPEC] * 4, bundle,
                                               **(KWARGS if method == "lmd_plus"
                                                  else LMD_KWARGS))])
    got = dp2[method][0]["images"]
    assert np.abs(got.astype(int) - whole.astype(int)).max() <= 1
