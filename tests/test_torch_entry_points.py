"""The port's entry points on the CPU: float32 precision, the opt-in kernels
of the CLI and the webui, and SAM's host inputs.

- Every float32 entry point turns both TF32 flags off, starting from both
  on: `load_bundle(dtype="float32")` (and a config that is float32), the
  eval CLI's OWL-ViT (`build_owlvit`, `OwlViTDetector`, `owl_vit_eval.main`),
  `generate.main --use_autocast 0` (which prints its line) and the float32
  training step. A bfloat16 bundle and a bfloat16 training step leave them
  as they were.
- Each of LMDX_PACKED_ATTENTION, LMDX_FUSED_HEADS and LMDX_PALLAS_GROUPNORM
  (alone, all three, none) reaches `load_bundle(kernels=...)` and from there
  every attention layer and GroupNorm of the UNet, through the stage-2 CLI
  (the sequential and the batched loop get the bundle built with them) and
  through the webui; `kernel_options_from_env` reads "1" as on and anything
  else as off, as the JAX package does.
- SAM's host images against the JAX segmenter on the same tiny weights: a
  grayscale image, an RGBA image and mixed-size batches (one chunk, and two
  chunks whose second has one size) give the same masks and IoU.
"""

import argparse
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdx.nn import sam as jsam
from lmdx_torch import config as tconfig
from lmdx_torch.cli import generate as tgen
from lmdx_torch.cli import owl_vit_eval
from lmdx_torch.eval import owl_vit as teval
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.methods import lmd_plus as tlmd_plus
from lmdx_torch.nn import attention as tattn
from lmdx_torch.nn import owlvit as towl
from lmdx_torch.nn import sam as tsam
from lmdx_torch.nn.kernels.group_norm import FusedGroupNorm
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.training import train as ttrain
from lmdx_torch.webui import server as tserver
from tests.test_torch_generate import RESPONSES


@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _tf32():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


# ---- float32 precision ----------------------------------------------------------

@pytest.mark.parametrize("key,dtype,full", [
    ("tiny-test", "float32", True),
    ("tiny-test", None, True),          # tiny-test is float32 already
    ("tiny-test", "bfloat16", False),
])
def test_load_bundle_float32_turns_tf32_off(tf32_on, key, dtype, full):
    bundle = tmodels.load_bundle(key, dtype=dtype, device="cpu")
    assert bundle.config.torch_dtype() == (torch.bfloat16 if dtype == "bfloat16"
                                           else torch.float32)
    assert _tf32() == ((False, False) if full else (True, True))


def test_owlvit_detector_turns_tf32_off(tf32_on):
    teval.OwlViTDetector(config=towl.tiny_owlvit(), device="cpu", seed=0)
    assert _tf32() == (False, False)


def test_owl_vit_eval_cli_turns_tf32_off(tf32_on, monkeypatch, tmp_path, capsys):
    class Report:
        def summary(self):
            return "report"

    monkeypatch.setattr(towl, "owlvit_base_patch32", towl.tiny_owlvit)
    monkeypatch.setattr(owl_vit_eval, "evaluate_run", lambda *a, **k: Report())
    assert owl_vit_eval.main(["--run_base_path", str(tmp_path), "--detector-random",
                              "--cpu"]) == 0
    assert capsys.readouterr().out.strip() == "report"
    assert _tf32() == (False, False)


@pytest.fixture
def cache_path(tmp_path):
    from lmdx_torch.eval.prompts import PROMPTS_DEMO

    path = tmp_path / "cache_demo_v0.1_gpt-4.json"
    path.write_text(json.dumps({p.strip().rstrip("."): [r]
                                for p, r in zip(PROMPTS_DEMO, RESPONSES)}))
    return str(path)


def _record_cli(monkeypatch):
    """The real `load_bundle` at tiny-test, recorded; the methods and batch
    functions record the bundle they are handed and return blank images."""
    from lmdx_torch import methods as tmethods
    from lmdx_torch.methods import base as tbase

    seen = {"load": [], "bundles": []}
    load = tmodels.load_bundle

    def load_bundle(key, **kw):
        seen["load"].append(kw)
        return load("tiny-test", **kw)

    class Method:
        def __init__(self, name):
            pass

        def run(self, spec, bundle, bg_seed, **kw):
            seen["bundles"].append(bundle)
            return tbase.GenerationResult(image=np.zeros((8, 8, 3), np.uint8))

    def batch_fn(specs, bundle, **kw):
        seen["bundles"].append(bundle)
        return [tbase.GenerationResult(image=np.zeros((8, 8, 3), np.uint8))
                for _ in kw["bg_seeds"]]

    monkeypatch.setattr(tmodels, "load_bundle", load_bundle)
    monkeypatch.setattr(tmethods, "get_method", Method)
    monkeypatch.setattr(tbatch, "run_lmd_plus_batch", batch_fn)
    return seen


def test_generate_use_autocast_0_turns_tf32_off(tf32_on, monkeypatch, cache_path, tmp_path,
                                                capsys):
    seen = _record_cli(monkeypatch)
    assert tgen.main(["--cpu", "--prompt-type", "demo", "--cache-path", cache_path,
                      "--save-dir", str(tmp_path), "--use_autocast", "0",
                      "--num_prompts", "1"]) == 0
    assert _tf32() == (False, False)
    assert seen["load"][0]["dtype"] == "float32"
    out = capsys.readouterr().out
    assert ("full f32: torch.backends.cuda.matmul.allow_tf32=False, "
            "torch.backends.cudnn.allow_tf32=False") in out


@pytest.mark.parametrize("dtype,full", [(torch.float32, True), (torch.bfloat16, False)])
def test_training_step_float32_turns_tf32_off(tf32_on, dtype, full):
    cfg = dataclasses.replace(tconfig.SD_CONFIGS["tiny-test"](),
                              dtype=str(dtype).removeprefix("torch."))
    unet = tmodels.build_train_unet(cfg, device="cpu")
    assert unet.compute_dtype == dtype
    ttrain.make_train_step(unet, ttrain.make_optimizer(), np.ones(1000, np.float32))
    assert _tf32() == ((False, False) if full else (True, True))


# ---- the opt-in kernels from the environment --------------------------------------

ENV_CASES = {
    "none": {},
    "packed": {"LMDX_PACKED_ATTENTION": "1"},
    "fused_heads": {"LMDX_FUSED_HEADS": "1"},
    "group_norm": {"LMDX_PALLAS_GROUPNORM": "1"},
    "all": {"LMDX_PACKED_ATTENTION": "1", "LMDX_FUSED_HEADS": "1",
            "LMDX_PALLAS_GROUPNORM": "1"},
}


def _expected(env) -> tconfig.KernelOptions:
    return tconfig.KernelOptions(packed_attention="LMDX_PACKED_ATTENTION" in env,
                                 fused_heads="LMDX_FUSED_HEADS" in env,
                                 fused_group_norm="LMDX_PALLAS_GROUPNORM" in env)


def _set_env(monkeypatch, env):
    for var in tconfig.KERNEL_ENV.values():
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)


def _check_unet(unet, want: tconfig.KernelOptions):
    attns = [m for m in unet.modules() if isinstance(m, tattn.CrossAttention)]
    norms = [m for m in unet.modules() if isinstance(m, (tattn.GroupNorm, FusedGroupNorm))]
    assert attns and norms
    assert all(m.options == want for m in attns)
    assert all(isinstance(m, FusedGroupNorm) == want.fused_group_norm for m in norms)


@pytest.mark.parametrize("value,on", [("1", True), ("0", False), ("true", False),
                                      ("yes", False), ("", False), (None, False)])
def test_kernel_options_from_env_reads_one_as_on(monkeypatch, value, on):
    _set_env(monkeypatch, {} if value is None
             else {var: value for var in tconfig.KERNEL_ENV.values()})
    want = tconfig.ALL_KERNELS if on else tconfig.KernelOptions()
    assert tconfig.kernel_options_from_env() == want


@pytest.mark.parametrize("mode", ["sequential", "batched"])
@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_cli_takes_the_opt_in_kernels(case, mode, monkeypatch, cache_path, tmp_path):
    _set_env(monkeypatch, ENV_CASES[case])
    seen = _record_cli(monkeypatch)
    argv = ["--cpu", "--prompt-type", "demo", "--cache-path", cache_path,
            "--save-dir", str(tmp_path), "--run-model", "lmd_plus", "--num_prompts", "2"]
    if mode == "batched":
        argv += ["--image-batch-size", "2"]
    assert tgen.main(argv) == 0
    want = _expected(ENV_CASES[case])
    (kw,) = seen["load"]
    assert kw["kernels"] == want
    assert seen["bundles"]
    for bundle in seen["bundles"]:
        _check_unet(bundle.unet, want)


@pytest.mark.parametrize("case", ["none", "packed", "fused_heads", "group_norm"])
def test_webui_takes_the_opt_in_kernels(case, monkeypatch):
    _set_env(monkeypatch, ENV_CASES[case])
    app = tserver.App(argparse.Namespace(sd_model="tiny-test", cpu=True, cache_path=None,
                                         llm_model="gpt-4", steps=2))
    _check_unet(app.bundle().unet, _expected(ENV_CASES[case]))
    assert app.bundle() is app.bundle()


def test_lmd_plus_runs_on_the_env_kernels(monkeypatch, cache_path, tmp_path):
    """One real run of the CLI with every variable set: the tiny LMD+ image
    it writes is the method's image on a bundle built with `ALL_KERNELS`."""
    from PIL import Image

    _set_env(monkeypatch, ENV_CASES["all"])
    results = []
    run = tlmd_plus.run

    def keep(*a, **kw):
        results.append((a[1], run(*a, **kw)))
        return results[-1][1]

    monkeypatch.setattr(tlmd_plus, "run", keep)
    assert tgen.main(["--cpu", "--sd-model", "tiny-test", "--prompt-type", "demo",
                      "--cache-path", cache_path, "--save-dir", str(tmp_path),
                      "--run-model", "lmd_plus", "--num_prompts", "1",
                      "--num_inference_steps", "2", "--no-continue-on-error"]) == 0
    ((bundle, result),) = results
    _check_unet(bundle.unet, tconfig.ALL_KERNELS)
    (png,) = tmp_path.rglob("img_0.png")
    np.testing.assert_array_equal(np.asarray(Image.open(png)), result.image)


# ---- SAM's host inputs ----------------------------------------------------------

BOXES = [[(0.1, 0.1, 0.6, 0.7)], [(0.3, 0.2, 0.9, 0.8)], [(0.0, 0.4, 0.5, 1.0)],
         [(0.2, 0.0, 0.7, 0.5)], [(0.4, 0.4, 1.0, 1.0)]]


@pytest.fixture(scope="module")
def sam_pair():
    model = tmodels.build_sam(tsam.tiny_sam(), seed=0, device="cpu", dtype=torch.float32)
    tree = jsam.convert_sam({k: v.numpy() for k, v in model.state_dict().items()},
                            jsam.tiny_sam())
    return (tsam.SamSegmenter(model),
            jsam.FlaxSamSegmenter(tree, jsam.tiny_sam(), dtype=jnp.float32))


def _host_images(case):
    rng = np.random.default_rng(11)

    def rgb(h, w):
        return rng.integers(0, 255, (h, w, 3), np.uint8)

    if case == "grayscale":
        return [rng.integers(0, 255, (32, 32), np.uint8), rgb(32, 32)]
    if case == "rgba":
        return [rng.integers(0, 255, (32, 32, 4), np.uint8), rgb(32, 32)]
    if case == "mixed":
        return [rgb(32, 32), rgb(24, 40), rgb(48, 16)]
    # Two chunks: the first mixed, the second (one image) of its own size.
    return [rgb(32, 32), rgb(24, 40), rgb(48, 16), rgb(32, 32), rgb(40, 24)]


@pytest.mark.parametrize("prompt", ["input_boxes", "input_points"])
@pytest.mark.parametrize("case", ["grayscale", "rgba", "mixed", "mixed_two_chunks"])
def test_sam_host_inputs_match_jax(sam_pair, case, prompt):
    port, jax_seg = sam_pair
    images = _host_images(case)
    n = len(images)
    kw = ({"input_boxes": BOXES[:n]} if prompt == "input_boxes"
          else {"input_points": [[(0.3, 0.4)], [(0.6, 0.5)], [(0.2, 0.8)], [(0.7, 0.2)],
                                 [(0.5, 0.5)]][:n]})
    want = jax_seg.segment_batch(images, target_hw=(16, 16), **kw)
    got = port.segment_batch(images, target_hw=(16, 16), **kw)
    assert len(got) == len(want) == n
    for (gm, gi), (wm, wi) in zip(got, want):
        assert gm.dtype == np.bool_ and gm.shape == (3, 16, 16)
        np.testing.assert_array_equal(gm, np.asarray(wm))
        np.testing.assert_allclose(gi, np.asarray(wi), atol=1e-5, rtol=0)
