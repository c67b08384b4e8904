#!/usr/bin/env python3
"""Times the bf16 flash-attention backward (kernel 2, `flash_attention_bwd`)
of several copies of the port side by side on one CUDA card, at the four
largest shapes of the GLIGEN training step (batch 16 x 8 heads: 4096 tokens
at head dim 40 with KV 4096 and the fuser's 4126, 1024 tokens at head dim 80
with KV 1024 and 1054), each against its plain version.

    python3 scripts/torch_flash_bwd_variants.py --tree NAME=DIR [--tree NAME=DIR ...]
        [--rounds 2] [--reps 10]

Each DIR holds a copy of `lmdx_torch/` (the repo's own tree, a parent
commit's, or a copy with a constant edited, e.g. `Sm90Bwd`'s warpgroups,
stages or dQ KV tile in `csrc/flash_bwd_sm90.cuh`). The script builds every
copy's `flash_bwd.cu` in parallel (each into its own `DIR/build/kernels/`)
and prints its `ptxas -v` registers and spills, then runs each copy in a
process of its own, in turns (the trees in order, then in reverse,
`--rounds` times), on the same seeded inputs, and prints one line a shape:
device ms (CUDA events over `--reps` calls queued behind a device spin),
TFLOP/s and the share of the bound (10 B*h*Lq*Lk*d operations at 989
TFLOP/s), and max|kernel - plain| over dQ, dK, dV as a share of max|plain|
(on the first 16 heads), then the device ms of each of its kernels
(torch.profiler). The first tree also times SDPA's flash backward op
on the same inputs, a yardstick only. Compare variants only within one run:
cards and their hosts differ between runs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HOLD_CYCLES = 10_000_000
PEAK_BF16 = 989e12
# (batch * heads, Lq, Lk, head dim) of the training step's attention backward.
SHAPES = ((128, 4096, 4096, 40), (128, 4096, 4126, 40), (128, 1024, 1024, 80),
          (128, 1024, 1054, 80))
CHECK_HEADS = 16


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

    def split_ms(fn, calls=3):
        """Device ms a call of each of the port's kernels, by torch.profiler."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            m = re.search(r"(\w+_kernel)<(\d+)", e.key)
            if m:
                name = f"{m.group(1)}<{m.group(2)}>"
                out[name] = out.get(name, 0.0) + e.device_time_total / calls / 1000
        return out

    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    rows = []
    for bh, lq, lk, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(lq + lk + d)
        q, do = (torch.randn((1, bh, lq, d), generator=g, device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn((1, bh, lk, d), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        o, lse = fa.flash_attention_fwd(q, k, v)
        got = fa.flash_attention_bwd(q, k, v, lse, o, do)
        part = [t[:, :CHECK_HEADS] for t in (q, k, v, lse, o, do)]
        want = fa.attention_bwd_plain(*part)
        err = max(((x[:, :CHECK_HEADS].float() - w.float()).abs().max()
                   / w.float().abs().max()).item() for x, w in zip(got, want))
        flops = 10 * bh * lq * lk * d
        shape = f"BH={bh} Lq={lq} Lk={lk} d={d}"
        rows.append({"kernel": "kernel 2", "shape": shape, "flops": flops, "err": err,
                     "ms": ms(lambda: fa.flash_attention_bwd(q, k, v, lse, o, do)),
                     "split": split_ms(lambda: fa.flash_attention_bwd(q, k, v, lse, o, do))})
        if library:
            outs = sdpa(q, k, v, 0.0, False, False, scale=d ** -0.5)
            lo, llse, cq, ck, mq, mk, seed, off = outs[:8]
            rows.append({"kernel": "SDPA flash", "shape": shape, "flops": flops, "err": 0.0,
                         "ms": ms(lambda: sdpa_bwd(do, q, k, v, lo, llse, cq, ck, mq, mk, 0.0,
                                                   False, seed, off, scale=d ** -0.5))})
        del q, k, v, o, lse, do, got, want, part
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
    build = ("import sys, time; sys.path.insert(0, sys.argv[1]); t = time.perf_counter(); "
             "from lmdx_torch.nn.kernels import build as b; b.build(['flash_bwd']); "
             "print(sys.argv[1], 'build', round(time.perf_counter() - t, 1), 's'); "
             "from lmdx_torch.nn.kernels.build import ptxas_report as r; "
             "[print(sys.argv[1], k) for k in r(b.BUILD_LOG.get('flash_bwd', ''))]")
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
            rate = row["flops"] / row["ms"] / 1e9
            print(f"{name:>10} {row['kernel']:>10} {row['shape']:<28} {row['ms']:.4f} ms "
                  f"{rate:.1f} TFLOP/s {rate * 1e12 / PEAK_BF16:.1%} of bound "
                  f"err {row['err']:.1e}"
                  + "".join(f" {k} {v:.4f}" for k, v in row.get("split", {}).items()),
                  flush=True)


if __name__ == "__main__":
    main()
