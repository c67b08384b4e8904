"""The CLI's `--mesh` (`lmdx_torch/cli/generate.py`) on the CPU at tiny-test,
batched LMD+ (`--image-batch-size 2`, pipelined) on the demo prompts (3, 1
and 2 boxes: a batch of two that dp 2 splits and a batch of one that it
cannot, which every rank then runs whole).

- `--mesh dp=2`: without a coordinator the CLI starts two processes on
  localhost itself (gloo); it writes the same files as without `--mesh`, in
  one run directory (the ranks take rank 0's), the masks bit for bit, and
  each image equal bit for bit to `run_lmd_plus_batch` in one process on
  the share of its batch that its dp row ran (the whole batch where dp does
  not divide it). The images are not held to the run without a mesh:
  there a batch of two runs where a dp row runs one, and at tiny-test under
  the CLI's defaults the same image from a batch of one and a batch of two
  differs by up to 7 uint8 levels without any mesh (the JAX package's by
  4), the guidance amplifying float sums taken in another order.
- `--mesh auto` with `--cpu`: a mesh of one rank in this process; its PNGs
  equal the run without `--mesh` bit for bit, and it prints the `mesh:`
  line.
- A rank other than 0 writes nothing.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from lmdx_torch.cli import generate as tgen
from lmdx_torch.dist import mesh as meshlib
from lmdx_torch.eval.prompts import PROMPTS_DEMO
from lmdx_torch.methods import batch as tbatch
from lmdx_torch.runtime import models as tmodels
from lmdx_torch.text import cache as tcache
from tests._torch_tiny import one_torch_thread
from tests._torch_dist import ROOT
from tests.test_torch_generate import RESPONSES

STEPS = 3


@pytest.fixture
def cache_path(tmp_path):
    path = tmp_path / "cache_demo_v0.1_gpt-4.json"
    path.write_text(json.dumps({p.strip().rstrip("."): [r]
                                for p, r in zip(PROMPTS_DEMO, RESPONSES)}))
    return str(path)


ARGV = ["--cpu", "--sd-model", "tiny-test", "--prompt-type", "demo", "--run-model", "lmd_plus",
        "--image-batch-size", "2", "--num_inference_steps", str(STEPS),
        "--no-continue-on-error"]


def _pngs(save_dir):
    return {p.relative_to(save_dir): np.asarray(Image.open(p))
            for p in sorted(save_dir.rglob("*.png"))}


def _run(cache_path, save_dir, *extra):
    with one_torch_thread():
        assert tgen.main([*ARGV, "--cache-path", cache_path, "--save-dir", str(save_dir),
                          *extra]) == 0
    return _pngs(save_dir)


@pytest.fixture
def plain(cache_path, tmp_path):
    return _run(cache_path, tmp_path / "plain")


def test_mesh_dp2_starts_two_ranks_and_writes_the_same_pngs(plain, cache_path, tmp_path):
    # As a user starts it, in a session of its own: a hung rank is killed
    # with its launcher at the timeout.
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    for name in ("LMDX_COORDINATOR", "LMDX_NUM_PROCESSES", "LMDX_PROCESS_ID"):
        env.pop(name, None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lmdx_torch.cli.generate", *ARGV, "--cache-path", cache_path,
         "--save-dir", str(tmp_path / "dp2"), "--mesh", "dp=2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    got = _pngs(tmp_path / "dp2")
    assert "multihost: process 0/2" in out and "multihost: process 1/2" in out
    assert out.count("mesh: {'dp': 2, 'tp': 1} over 2 devices") == 2
    assert sorted(got) == sorted(plain) and len(plain) == 3 * 2  # img_0, masks_0
    assert {p.parts[1] for p in got} == {"run0"}
    args = tgen.build_parser().parse_args(["--image-batch-size", "2"])
    jobs = tgen.build_jobs(args, tcache.LayoutCache(cache_path), PROMPTS_DEMO, "/nonexistent")
    groups, _, _ = tgen.plan_groups(args, jobs)
    assert [len(g) for g in groups] == [2, 1]
    bundle = tmodels.load_bundle("tiny-test", device="cpu")
    for group in groups:
        rows = [[j] for j in group] if len(group) % 2 == 0 else [group]
        for row in rows:
            with one_torch_thread():
                results = tbatch.run_lmd_plus_batch(
                    [j["spec"] for j in row], bundle, bg_seeds=[j["bg_seed"] for j in row],
                    fg_seed_starts=[j["fg_seed_start"] for j in row],
                    num_inference_steps=STEPS)
            for job, r in zip(row, results):
                rel = next(p for p in got if p.parts[-2:] == (str(job["ind"]), "img_0.png"))
                np.testing.assert_array_equal(got[rel], r.image, err_msg=str(rel))
    for rel, image in got.items():
        if not rel.name.startswith("img"):
            np.testing.assert_array_equal(image, plain[rel], err_msg=str(rel))


def test_mesh_auto_on_the_cpu_is_one_rank_bit_for_bit(plain, cache_path, tmp_path, capsys):
    got = _run(cache_path, tmp_path / "auto", "--mesh", "auto")
    assert "mesh: {'dp': 1, 'tp': 1} over 1 devices" in capsys.readouterr().out
    assert sorted(got) == sorted(plain)
    for rel, image in got.items():
        np.testing.assert_array_equal(image, plain[rel], err_msg=str(rel))


def test_a_rank_other_than_0_writes_nothing(cache_path, tmp_path, monkeypatch):
    monkeypatch.setattr(meshlib, "is_writer", lambda: False)
    save_dir = tmp_path / "rank1"
    _run(cache_path, save_dir)
    assert not save_dir.exists() or not any(save_dir.rglob("*"))
    # The sequential loop too.
    with one_torch_thread():
        assert tgen.main(["--cpu", "--sd-model", "tiny-test", "--prompt-type", "demo",
                          "--run-model", "lmd_plus", "--num_prompts", "1",
                          "--num_inference_steps", "2", "--cache-path", cache_path,
                          "--save-dir", str(save_dir), "--no-continue-on-error"]) == 0
    assert not save_dir.exists() or not any(save_dir.rglob("*"))
