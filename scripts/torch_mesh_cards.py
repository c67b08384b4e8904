#!/usr/bin/env python3
"""The stage-2 CLI's `--mesh` across the cards of one host, over NCCL: batched
LMD+ (SD1.4+GLIGEN, random weights, 512x512) on the three demo prompts, four
repeats each (12 images in batches of 4), once without a mesh (one process),
then with `--mesh auto` (dp = the card count: one image a rank a batch) and
`--mesh dp=N/2,tp=2` (two images a dp row, 4 of SD1.x's 8 heads a rank); the
CLI starts one process per card itself.

    python3 scripts/torch_mesh_cards.py [--steps 10] [--out chiprun_out/mesh_cards.json]

Prints one JSON object: each run's wall (process start, bundle and kernel
load included), its PNG count, and the largest uint8 gap of its images to the
run without a mesh (the same image from batches of other sizes and from
tensor-split sums differs by float order: a gap, not a failure), with the
card count and the card's name and power limit. Exits nonzero if a run
fails or writes other files than the run without a mesh. Builds the kernels
once first, so that the ranks load them instead of compiling them each.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RESPONSES = (
    "Objects: [('a blue cube', [232, 135, 132, 132]), ('a red cube', [232, 280, 132, 132]), "
    "('a vase', [80, 250, 90, 160])]\nBackground prompt: An indoor scene\nNegative prompt: ",
    "Objects: [('a wooden table', [60, 250, 392, 200])]\nBackground prompt: A realistic "
    "photo of an indoor scene\nNegative prompt: bananas",
    "Objects: [('a white deer', [60, 200, 180, 230]), ('a gray bear', [290, 210, 190, 220])]"
    "\nBackground prompt: A realistic image of an empty factory scene\nNegative prompt: ",
)


def _pngs(root: str) -> dict:
    import numpy as np
    from PIL import Image

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                with Image.open(os.path.join(d, f)) as im:
                    out[os.path.relpath(os.path.join(d, f), root)] = np.asarray(im)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/mesh_cards.json")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds each CLI run may take")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.nn.kernels import build

    cards = torch.cuda.device_count()
    if cards < 4 or cards % 2:
        sys.exit(f"needs an even number of cards, at least 4; {cards} here")
    t0 = time.perf_counter()
    build.build()
    report = {"cards": cards, "build_s": time.perf_counter() - t0, "steps": args.steps,
              "runs": {}}
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    report["gpu"] = gpu
    with tempfile.TemporaryDirectory(prefix="lmdx_mesh_cards_") as root:
        cache = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
        with open(cache, "w") as f:
            json.dump({p.strip().rstrip("."): [r] for p, r in zip(PROMPTS_DEMO, RESPONSES)}, f)
        argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--repeats", "4",
                "--image-batch-size", "4", "--num_inference_steps", str(args.steps),
                "--cache-path", cache, "--force_run_ind", "0", "--no-continue-on-error"]
        env = {k: v for k, v in os.environ.items()
               if k not in ("LMDX_COORDINATOR", "LMDX_NUM_PROCESSES", "LMDX_PROCESS_ID")}
        env["PYTHONPATH"] = HERE
        plain = None
        for name, mesh in (("no mesh", []), ("--mesh auto", ["--mesh", "auto"]),
                           (f"--mesh dp={cards // 2},tp=2",
                            ["--mesh", f"dp={cards // 2},tp=2"])):
            out_dir = os.path.join(root, name.replace(" ", "_").replace("=", "").replace(",", ""))
            t0 = time.perf_counter()
            # Its own session: at the timeout the CLI and the ranks it started go.
            proc = subprocess.Popen(
                [sys.executable, "-m", "lmdx_torch.cli.generate", *argv, "--save-dir", out_dir,
                 *mesh], cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True)
            try:
                printed, _ = proc.communicate(timeout=args.timeout)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            wall = time.perf_counter() - t0
            lines = [ln for ln in printed.splitlines() if ln.startswith(("mesh:", "multihost:"))]
            if proc.returncode != 0:
                print(printed[-6000:], file=sys.stderr)
                sys.exit(f"{name}: exit {proc.returncode}")
            images = _pngs(out_dir)
            run = {"wall_s": wall, "pngs": len(images), "mesh_lines": sorted(set(lines))}
            if plain is None:
                plain = images
            else:
                if sorted(images) != sorted(plain):
                    sys.exit(f"{name}: wrote {sorted(images)}, without a mesh {sorted(plain)}")
                run["max_gap_to_no_mesh"] = int(max(
                    np.abs(images[k].astype(int) - plain[k].astype(int)).max()
                    for k in plain if os.path.basename(k).startswith("img")))
            report["runs"][name] = run
            print(json.dumps({name: run}), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(gpu)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
