#!/usr/bin/env python3
"""Times the bf16 flash-attention forward (kernel 1, `flash_attention_fwd`)
of several copies of the port side by side on one CUDA card, at the SDXL
refiner's self-attention shapes (head dim 64, CFG batch 2: 12 heads at 4096
tokens, 24 heads at 1024 and at 256 tokens), each against its plain version.

    python3 scripts/torch_flash_fwd_variants.py --tree NAME=DIR [--tree NAME=DIR ...]
        [--rounds 2] [--reps 10]

Each DIR holds a copy of `lmdx_torch/` (the repo's own tree, or a copy with
a constant edited, e.g. the q tile `FlashTile` of `csrc/attention_fwd.cuh`).
The script builds every copy's `flash_fwd.cu` in parallel (each into its own
`DIR/build/kernels/`) and prints its `ptxas -v` registers and spills, then
runs each copy in a process of its own, in turns (the trees in order, then in
reverse, `--rounds` times), on the same seeded inputs, and prints one line a
shape: device ms (CUDA events over `--reps` launches queued behind a device
spin), TFLOP/s, and max|kernel - plain| as a share of max|plain|. The first
tree also times SDPA's flash forward op on the same inputs, a yardstick only.
Compare variants only within one run: cards and their hosts differ between
runs.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HOLD_CYCLES = 10_000_000
# (batch, heads, tokens) of the refiner UNet's self-attention, head dim 64.
SHAPES = ((2, 12, 4096), (2, 24, 1024), (2, 24, 256))
HEAD_DIM = 64


def _child(tree: str, reps: int, library: bool) -> None:
    sys.path.insert(0, tree)
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    rows = []
    for b, h, n in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(n + h)
        q, k, v = (torch.randn((b, h, n, HEAD_DIM), generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o_ref, _ = fa.attention_fwd_plain(q, k, v)
        o, _ = fa.flash_attention_fwd(q, k, v)
        err = ((o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max()).item()
        flops = 4 * b * h * n * n * HEAD_DIM
        shape = f"B={b} h={h} L={n} d={HEAD_DIM}"
        rows.append({"kernel": "kernel 1", "shape": shape, "flops": flops, "err": err,
                     "ms": ms(lambda: fa.flash_attention_fwd(q, k, v))})
        if library:
            rows.append({"kernel": "SDPA flash", "shape": shape, "flops": flops, "err": 0.0,
                         "ms": ms(lambda: sdpa(q, k, v, 0.0, False, False,
                                               scale=HEAD_DIM ** -0.5))})
        del q, k, v, o, o_ref
        torch.cuda.empty_cache()
    print(json.dumps(rows), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--child", nargs=2, metavar=("DIR", "LIBRARY"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child[0], args.reps, args.child[1] == "1")
        return
    trees = [t.split("=", 1) for t in args.tree]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from lmdx_torch.nn.kernels import build as b; b.build(['flash_fwd']); "
             "from lmdx_torch.nn.kernels.build import ptxas_report as r; "
             "[print(sys.argv[1], k) for k in r(b.BUILD_LOG.get('flash_fwd', ''))]")
    procs = [subprocess.Popen([sys.executable, "-c", build, os.path.abspath(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _, d in trees]
    for (name, _), p in zip(trees, procs):
        out, _ = p.communicate()
        print(f"build {name}: exit {p.returncode}\n{out}", flush=True)
        if p.returncode:
            sys.exit(1)
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for i, (name, d) in enumerate(order):
        out = subprocess.run([sys.executable, __file__, "--tree", "x=x", "--reps", str(args.reps),
                              "--child", os.path.abspath(d), "1" if i == 0 else "0"],
                             capture_output=True, text=True)
        if out.returncode:
            print(f"{name}: exit {out.returncode}\n{out.stdout}\n{out.stderr}", flush=True)
            sys.exit(1)
        for row in json.loads(out.stdout.strip().splitlines()[-1]):
            print(f"{name:>10} {row['kernel']:>10} {row['shape']:<24} {row['ms']:.4f} ms "
                  f"{row['flops'] / row['ms'] / 1e9:.1f} TFLOP/s err {row['err']:.1e}",
                  flush=True)


if __name__ == "__main__":
    main()
