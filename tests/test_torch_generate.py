"""The port's stage-2 CLI (`lmdx_torch/cli/generate.py`) against the JAX
package's (`lmdx/cli/generate.py`).

- Both parsers define the same options with the same defaults;
  `collect_run_kwargs`, `select_model_key` and `make_save_dir` agree on every
  flag; `plan_shape_classes` agrees over a hypothesis sweep of groups and
  budgets; `build_jobs` and `plan_groups` give the same jobs, seeds, specs,
  order and pads.
- With each package's method registry, batch functions and `load_bundle`
  replaced by recorders, `main(argv)` makes the same calls with the same
  specs, seeds and keyword arguments, sequential and batched, with and
  without `--use_autocast 0`.
- The port's CLI on the CPU at tiny-test writes PNGs equal bit for bit to
  what its methods return for the same seeds (sequential and batched, the
  padded tail group, `--warm-ahead`), leaves an existing image untouched on
  resume, and refuses an SDXL stage-2 model (a refiner only); `--use-sdv2`
  and the SD2.1 `--sd-model` make the JAX CLI's calls. `--mesh` runs:
  `tests/test_torch_dist_cli.py`.

Each test writes its own layout cache for the demo prompts: hand-written
responses in the template's format (3, 1 and 2 boxes).
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from lmdx import methods as jmethods
from lmdx.cli import generate as jgen
from lmdx.methods import base as jbase
from lmdx.methods import batch as jbatch
from lmdx.runtime import jit_cache
from lmdx.runtime import models as jmodels
from lmdx.text import cache as jcache
from lmdx.text import tokens as jtok
from lmdx_torch import methods as tmethods
from lmdx_torch.cli import generate as tgen
from lmdx_torch.eval.prompts import PROMPTS_DEMO
from lmdx_torch.methods import base as tbase
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.text import cache as tcache
from lmdx_torch.text import tokens as ttok
from tests._torch_tiny import one_torch_thread

RESPONSES = (
    "Objects: [('a blue cube', [232, 135, 132, 132]), ('a red cube', [232, 280, 132, 132]), "
    "('a vase', [80, 250, 90, 160])]\nBackground prompt: An indoor scene\nNegative prompt: ",
    "Objects: [('a wooden table', [60, 250, 392, 200])]\nBackground prompt: A realistic "
    "photo of an indoor scene\nNegative prompt: bananas",
    "Objects: [('a white deer', [60, 200, 180, 230]), ('a gray bear', [290, 210, 190, 220])]"
    "\nBackground prompt: A realistic image of an empty factory scene\nNegative prompt: ",
)
STEPS = 3


@pytest.fixture
def cache_path(tmp_path):
    path = tmp_path / "cache_demo_v0.1_gpt-4.json"
    path.write_text(json.dumps({p.strip().rstrip("."): [r]
                                for p, r in zip(PROMPTS_DEMO, RESPONSES)}))
    return str(path)


def _options(parser):
    return {opt: (a.dest, a.default, a.type, a.nargs, a.const, a.choices)
            for a in parser._actions for opt in a.option_strings if opt not in ("-h", "--help")}


def test_parsers_define_the_same_options():
    assert _options(tgen.build_parser()) == _options(jgen.build_parser())


FLAG_CASES = [
    [],
    ["--run-model", "lmd"],
    ["--run-model", "gligen"],
    ["--run-model", "sd", "--sd-model", "tiny-test"],
    ["--run-model", "boxdiff", "--use-sdv2"],
    ["--no-center-or-align", "--save-suffix", "x", "--prompt-type", "demo"],
    ["--force_run_ind", "3", "--template_version", "v0.2"],
    ["--loss_threshold", "0.5", "--max_iter", "4", "--use_ref_ca", "0",
     "--horizontal_shift_only", "1", "--so_vertical_placement", "floor_padding",
     "--frozen_step_ratio", "0.3", "--use_fast_schedule", "1", "--num_inference_steps", "7",
     "--overall_max_index_step", "12", "--so_floor_padding", "0.2"],
]


@pytest.mark.parametrize("argv", FLAG_CASES, ids=lambda a: " ".join(a) or "defaults")
def test_flag_functions_agree(argv, tmp_path):
    argv = [*argv, "--save-dir", str(tmp_path)]
    j, t = jgen.build_parser().parse_args(argv), tgen.build_parser().parse_args(argv)
    assert vars(j) == vars(t)
    assert tgen.collect_run_kwargs(t) == jgen.collect_run_kwargs(j)
    assert tgen.select_model_key(t) == jgen.select_model_key(j)
    assert tgen.make_save_dir(t) == jgen.make_save_dir(j)
    os.makedirs(jgen.make_save_dir(j))
    assert tgen.make_save_dir(t) == jgen.make_save_dir(j)


@settings(max_examples=150, deadline=None)
@given(groups=st.lists(st.lists(st.integers(0, 6), min_size=1, max_size=4),
                       min_size=1, max_size=9),
       budget=st.integers(0, 4), floor=st.sampled_from([1, 2, 4, 8]))
def test_plan_shape_classes_agrees(groups, budget, floor):
    assert (tgen.plan_shape_classes(groups, budget, position_floor=floor)
            == jgen.plan_shape_classes(groups, budget, position_floor=floor))


def _args(argv):
    return jgen.build_parser().parse_args(argv), tgen.build_parser().parse_args(argv)


JOB_CASES = [
    ["--image-batch-size", "2"],
    ["--image-batch-size", "2", "--max-compiled-variants", "1"],
    ["--image-batch-size", "2", "--max-compiled-variants", "2", "--repeats", "2"],
    ["--image-batch-size", "3", "--no-shape-schedule", "--seed_offset", "5"],
    ["--image-batch-size", "2", "--skip_first_prompts", "1", "--num_prompts", "1",
     "--max-compiled-variants", "1"],
    ["--image-batch-size", "2", "--no-scale-boxes-default", "--ignore-bg-prompt",
     "--ignore-negative-prompt", "--repeats", "3", "--max-compiled-variants", "1"],
]


@pytest.mark.parametrize("argv", JOB_CASES, ids=" ".join)
def test_build_jobs_and_plan_groups_agree(argv, cache_path, tmp_path):
    ja, ta = _args(["--prompt-type", "demo", *argv])
    save_dir = str(tmp_path / "run0")
    os.makedirs(f"{save_dir}/2")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(f"{save_dir}/2/img_0.png")
    jobs_j = jgen.build_jobs(ja, jcache.LayoutCache(cache_path), jgen.get_prompts("demo"),
                             save_dir)
    jobs_t = tgen.build_jobs(ta, tcache.LayoutCache(cache_path), tgen.get_prompts("demo"),
                             save_dir)
    assert jobs_t == jobs_j and jobs_t
    plan_j = jgen.plan_groups(ja, jobs_j, tokenizer=jtok.default_tokenizer())
    plan_t = tgen.plan_groups(ta, jobs_t, tokenizer=ttok.default_tokenizer())
    assert plan_t == plan_j


# ---- main(argv) with recorders ------------------------------------------------

class _Bundle:
    """What the CLI reads of a bundle besides handing it to the methods."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.checkpoint_dir = None


def _record(monkeypatch, side, result_cls):
    """Replace `side`'s load_bundle, method registry and batch functions by
    recorders; returns the list the calls go to."""
    calls = []
    gen, models, methods, batch = side
    tokenizer = (jtok if gen is jgen else ttok).default_tokenizer()

    def load_bundle(key, **kw):
        calls.append(("load_bundle", key, kw.get("dtype")))
        return _Bundle(tokenizer)

    def image(seed):
        return np.full((8, 8, 3), seed % 251, np.uint8)

    class Method:
        def __init__(self, name):
            self.name = name

        def run(self, spec, bundle, bg_seed, **kw):
            calls.append(("run", self.name, spec, bg_seed, kw))
            return result_cls(image=image(bg_seed))

    def batch_fn(name):
        def run(specs, bundle, **kw):
            calls.append(("batch", name, specs, kw))
            return [result_cls(image=image(s)) for s in kw["bg_seeds"]]
        return run

    monkeypatch.setattr(models, "load_bundle", load_bundle)
    monkeypatch.setattr(methods, "get_method", Method)
    for name in ("run_lmd_batch", "run_lmd_plus_batch"):
        monkeypatch.setattr(batch, name, batch_fn(name))
    return calls


MAIN_CASES = [
    ["--run-model", "lmd"],
    ["--run-model", "lmd", "--use_autocast", "0", "--repeats", "2", "--seed_offset", "3"],
    ["--run-model", "boxdiff", "--scheduler", "DPMSolverMultistep"],
    ["--run-model", "multidiffusion", "--multidiffusion_bootstrapping", "5"],
    ["--run-model", "lmd_plus", "--no-synthetic-prompt", "--no-center-or-align"],
    ["--run-model", "lmd_plus", "--image-batch-size", "2"],
    ["--run-model", "lmd_plus", "--image-batch-size", "2", "--max-compiled-variants", "1"],
    ["--run-model", "lmd", "--image-batch-size", "2", "--use_autocast", "0",
     "--no-pipeline-batches", "--loss_threshold", "0.3"],
    # SD2.1 base: the two flags that select it.
    ["--run-model", "lmd", "--use-sdv2", "--use_autocast", "0"],
    ["--run-model", "boxdiff", "--sd-model", "stabilityai/stable-diffusion-2-1-base"],
]


@pytest.mark.parametrize("argv", MAIN_CASES, ids=" ".join)
def test_main_makes_the_same_calls(argv, cache_path, tmp_path, monkeypatch):
    monkeypatch.setattr(jit_cache, "enable", lambda *a, **k: None)
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    calls = {}
    try:
        for name, side, result_cls in (
                ("jax", (jgen, jmodels, jmethods, jbatch), jbase.GenerationResult),
                ("torch", (tgen, tmodels, tmethods, tbatch), tbase.GenerationResult)):
            calls[name] = _record(monkeypatch, side, result_cls)
            gen = side[0]
            common = ["--prompt-type", "demo", "--cache-path", cache_path,
                      "--save-dir", str(tmp_path / name), "--no-continue-on-error"]
            assert gen.main([*common, *argv] + (["--cpu"] if gen is tgen else [])) == 0
        if "--use_autocast" in argv:
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved_tf32
    assert calls["torch"] == calls["jax"]
    assert len(calls["torch"]) > 1
    if "--use-sdv2" in argv or "stabilityai/stable-diffusion-2-1-base" in argv:
        assert calls["torch"][0][:2] == ("load_bundle", "stabilityai/stable-diffusion-2-1-base")
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    t_files = sorted(p.relative_to(tmp_path / "torch")
                     for p in (tmp_path / "torch").rglob("*.png"))
    assert t_files == j_files
    for rel in t_files:
        if rel.name.startswith("img"):
            assert np.array_equal(np.asarray(Image.open(tmp_path / "torch" / rel)),
                                  np.asarray(Image.open(tmp_path / "jax" / rel)))


@pytest.mark.parametrize("argv,needle", [
    # Training (tests/test_torch_training.py) and --mesh
    # (tests/test_torch_dist_cli.py) are ported.
    # --sdxl is ported (tests/test_torch_sdxl_refiner.py); an SDXL key as the
    # stage-2 model stays refused.
    (["--sd-model", "stabilityai/stable-diffusion-xl-refiner-1.0"], "item 6"),
    # SD2.1 runs (test_main_makes_the_same_calls, tests/test_torch_sd21.py);
    # the SDXL base, like the refiner, serves only as the --sdxl refiner.
    (["--sd-model", "stabilityai/stable-diffusion-xl-base-1.0"], "item 6"),
    (["--sd-model", "tiny-sdxl-base", "--run-model", "sd"], "item 6"),
])
def test_flags_whose_code_is_not_ported_refuse(argv, needle, cache_path, capsys):
    with pytest.raises(SystemExit) as err:
        tgen.main(["--cpu", "--prompt-type", "demo", "--cache-path", cache_path, *argv])
    assert err.value.code == 2
    assert needle in capsys.readouterr().err


# ---- the port's images against its methods' --------------------------------

@pytest.fixture(scope="module")
def tiny_bundle():
    with one_torch_thread():
        yield tmodels.load_bundle("tiny-test", device="cpu")


def _png(path):
    return np.asarray(Image.open(path))


def _cli(argv, cache_path, save_dir):
    with one_torch_thread():
        assert tgen.main(["--cpu", "--sd-model", "tiny-test", "--prompt-type", "demo",
                          "--cache-path", cache_path, "--save-dir", str(save_dir),
                          "--force_run_ind", "0", "--num_inference_steps", str(STEPS),
                          "--no-continue-on-error", *argv]) == 0


def _specs(cache_path, args):
    jobs = tgen.build_jobs(args, tcache.LayoutCache(cache_path), PROMPTS_DEMO, "/nonexistent")
    return {j["ind"]: j for j in jobs}


@pytest.mark.parametrize("name", ["lmd_plus", "lmd"])
def test_sequential_pngs_equal_the_methods_images(name, cache_path, tmp_path, tiny_bundle,
                                                  monkeypatch):
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    run_dir = tmp_path / f"templatev0.1_{name}_demo" / "run0"
    os.makedirs(run_dir / "1")
    sentinel = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    Image.fromarray(sentinel).save(run_dir / "1" / "img_0.png")
    _cli(["--run-model", name], cache_path, tmp_path)
    assert np.array_equal(_png(run_dir / "1" / "img_0.png"), sentinel)   # resumed: untouched
    assert sorted(os.listdir(run_dir / "1")) == ["img_0.png"]
    jobs = _specs(cache_path, tgen.build_parser().parse_args([]))
    for ind in (0, 2):
        job = jobs[ind]
        with one_torch_thread():
            want = tmethods.get_method(name).run(
                job["spec"], tiny_bundle, bg_seed=job["bg_seed"],
                fg_seed_start=job["fg_seed_start"], segmenter=None,
                num_inference_steps=STEPS)
        assert np.array_equal(_png(run_dir / str(ind) / "img_0.png"), want.image)
        for i, so in enumerate(want.so_img_list):
            assert np.array_equal(_png(run_dir / str(ind) / f"so_0_{i}.png"), so)
        assert (run_dir / str(ind) / "boxes.png").exists()
        assert (run_dir / str(ind) / "masks_0.png").exists()


def test_batched_pngs_equal_the_batch_functions_images(cache_path, tmp_path, tiny_bundle,
                                                       monkeypatch):
    """Two batches of 2 (shape-scheduled: 1 + 2 boxes, then 3 and, under
    --max-compiled-variants 1, its duplicate); the images equal
    `run_lmd_plus_batch` on the groups the CLI forms, whichever of
    --max-compiled-variants, --warm-ahead and --no-pipeline-batches is on."""
    monkeypatch.delenv("LMDX_CHECKPOINT_DIR", raising=False)
    args = tgen.build_parser().parse_args(["--image-batch-size", "2",
                                           "--max-compiled-variants", "1"])
    jobs = tgen.build_jobs(args, tcache.LayoutCache(cache_path), PROMPTS_DEMO, "/nonexistent")
    groups, pads, _ = tgen.plan_groups(args, jobs, tiny_bundle.tokenizer)
    assert [[j["ind"] for j in g] for g in groups] == [[1, 2], [0, 0]]
    assert groups[1][1].get("pad") and all(pads)
    want = {}
    for group in groups:
        with one_torch_thread():
            results = tbatch.run_lmd_plus_batch(
                [j["spec"] for j in group], tiny_bundle, bg_seeds=[j["bg_seed"] for j in group],
                fg_seed_starts=[j["fg_seed_start"] for j in group],
                num_inference_steps=STEPS)
        for job, r in zip(group, results):
            want.setdefault(job["ind"], r.image)
    for i, flags in enumerate([[], ["--max-compiled-variants", "1", "--warm-ahead"],
                               ["--no-pipeline-batches"]]):
        _cli(["--run-model", "lmd_plus", "--image-batch-size", "2", *flags], cache_path,
             tmp_path / str(i))
        run_dir = tmp_path / str(i) / "templatev0.1_lmd_plus_demo" / "run0"
        for ind, image in want.items():
            assert np.array_equal(_png(run_dir / str(ind) / "img_0.png"), image), (flags, ind)


def test_deferred_images_resolve_to_the_eager_ones(cache_path, tiny_bundle):
    args = tgen.build_parser().parse_args([])
    specs = [job["spec"] for job in _specs(cache_path, args).values()][:2]
    with one_torch_thread():
        eager = tbatch.run_lmd_plus_batch(specs, tiny_bundle, bg_seeds=[4, 5],
                                          num_inference_steps=2)
        deferred = tbatch.run_lmd_plus_batch(specs, tiny_bundle, bg_seeds=[4, 5],
                                             num_inference_steps=2, defer_fetch=True)
    assert all(isinstance(r.image, tbase.ImageRef) for r in deferred)
    tbase.finalize_results(deferred)
    for e, d in zip(eager, deferred):
        assert isinstance(d.image, np.ndarray) and np.array_equal(e.image, d.image)
    with pytest.raises(ValueError, match="pad_boxes_to"):
        tbatch.run_lmd_plus_batch(specs, tiny_bundle, bg_seeds=[4, 5],
                                  num_inference_steps=2, pad_boxes_to=2)
