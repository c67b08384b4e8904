"""The port's slice end to end: batched LMD+ (`run_lmd_plus_batch`) against
the JAX package's on the tiny-test config, plus the port's import rules.

Both sides run the same weights (converted JAX parameters) and the same
noise (the JAX side with LMDX_NOISE_BACKEND=torch draws the port's torch
stream). Tolerance: frozen masks identical; images within 2 uint8 levels
(f32 sums in other orders through two sampling passes and the VAE).

The layouts have two boxes each. With one box, the reference-CA term at the
first guidance step compares the overall pass's word-token attention with
the per-box pass's, which can be equal to the last bit; the loss then sits
on the kink of |x| and the sign of its gradient is rounding noise in either
package.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from lmdx.methods.batch import run_lmd_plus_batch as jax_run
from lmdx.runtime import models as jmodels
from lmdx_torch import config as tconfig
from lmdx_torch.methods.batch import run_lmd_plus_batch as torch_run
from lmdx_torch.runtime import convert
from lmdx_torch.runtime import models as tmodels

REPO = Path(__file__).resolve().parents[1]

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
EMPTY = {"prompt": "A sunset over the sea", "gen_boxes": [],
         "bg_prompt": "A sunset over the sea", "extra_neg_prompt": ""}
OVERRIDES = dict(max_iter=1, overall_max_iter=1, overall_max_index_step=2)


@pytest.mark.parametrize("specs,steps", [(SPECS, 6), ([SPECS[0], EMPTY], 5)],
                         ids=["two_layouts", "with_empty_layout"])
def test_run_lmd_plus_batch_matches_jax(monkeypatch, specs, steps):
    monkeypatch.setenv("LMDX_NOISE_BACKEND", "torch")
    jb = jmodels.load_bundle("tiny-test", seed=0)
    params = jax.tree_util.tree_map(np.asarray, jb.params)
    tb = tmodels.build_bundle(tconfig.tiny_test(),
                              convert.from_jax_params(params, tconfig.tiny_test()),
                              device="cpu")
    kw = dict(OVERRIDES, num_inference_steps=steps)
    want = jax_run(specs, jb, bg_seeds=[1, 2], **kw)
    got = torch_run(specs, tb, bg_seeds=[1, 2], **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.image.dtype == np.uint8 and g.image.shape == w.image.shape
        np.testing.assert_array_equal(g.aux["frozen_mask"], w.aux["frozen_mask"])
        np.testing.assert_array_equal(g.aux["foreground_indices"],
                                      w.aux["foreground_indices"])
        diff = np.abs(g.image.astype(np.int32) - w.image.astype(np.int32))
        assert diff.max() <= 2, diff.max()
    assert got[0].aux["frozen_mask"].sum() > 0
    assert (got[0].image != got[1].image).any()


def _port_modules():
    pkg = REPO / "lmdx_torch"
    return sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_no_jax_and_nothing_of_lmdx():
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['flax'] = None\n"
            "sys.modules['lmdx'] = None\n"
            f"for m in {_port_modules()!r}:\n"
            "    __import__(m)\n"
            "assert not any(k == 'lmdx' or k.startswith('lmdx.') for k in sys.modules\n"
            "               if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    banned = re.compile(r"^\s*(from|import)\s+(lmdx|jax|flax)(\.|\s|$)")
    for path in [*(REPO / "lmdx_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not banned.match(line), f"{path}: {line}"
