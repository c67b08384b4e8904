#!/usr/bin/env python3
"""Times the float32 forward kernels of several copies of the port side by
side on one CUDA card: kernels 1-f32 (`flash_attention_fwd`), 3-f32
(`flash_attention_fwd_packed`), 4-f32 (`flash_attention_fwd_fusedheads`) and
5-f32 (`sam_attention`) at float32, each against its plain version.

    python3 scripts/torch_f32_attention_variants.py --tree NAME=DIR [--tree NAME=DIR ...]
        [--rounds 2] [--reps 5] [--shapes dominant|paths] [--phase2]

Each DIR holds a copy of `lmdx_torch/` (a variant: the repo's own tree, a
`git archive` of another commit, or a copy with a constant edited). The
script builds every copy's `attention_f32.cu` in parallel (each into its own
`DIR/build/kernels/`), then runs each copy in a process of its own, in turns
(the trees in order, then in reverse, `--rounds` times), on the same seeded
inputs, and prints one line a kernel and shape: device ms (CUDA events over
`--reps` launches queued behind a device spin), TFLOP/s, and
max|kernel - plain| as a share of max|plain| (TF32 off). The first tree also
times `F.scaled_dot_product_attention` at float32 on the same inputs (SAM
with its dense bias as the mask), a yardstick only. Compare variants only
within one run: cards and their hosts differ between runs.

`--shapes dominant` is the 4096-token self-attention of the UNet's first
level (B*H 48, d 40) through all four kernels (the fused-heads one on the
projection layout of the same values) and SAM ViT-B's global and windowed
layers of one image; `paths` adds the 1024- and 256-token levels at batch 6
and 1, KV L and L + 30.

`--phase2` runs, in turns as above, each tree's own `chip_smoke.py`
float32 kernel checks instead (`phase_f32_kernels` and
`phase_f32_optin_kernels`: every float32 kernel at every shape the paths give
it, against its plain version and the library call), so that a commit and
its parent are compared in one run; each tree then needs its `chip_smoke.py`
beside `lmdx_torch/`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HOLD_CYCLES = 10_000_000


def _child(tree: str, shapes: str, reps: int, library: bool) -> None:
    sys.path.insert(0, tree)
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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

    def share(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    def rand(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda")

    rows = []
    flash = [(6, 4096, 0, 40)]
    if shapes == "paths":
        flash += [(b, L, e, d) for L, d in ((4096, 40), (1024, 80), (256, 160))
                  for b in (6, 1) for e in (0, 30) if (b, L, e) != (6, 4096, 0)]
    for b, L, extra, d in flash:
        h, lk = 8, L + extra
        q, k, v = (rand((b, h, n, d), L + lk + b + i) for i, n in enumerate((L, lk, lk)))
        o_ref, _ = fa.attention_fwd_plain(q, k, v)
        flops = 4 * b * h * L * lk * d
        qf, kf, vf = (t.transpose(1, 2).reshape(b, -1, h * d).contiguous() for t in (q, k, v))
        calls = {"1-f32": lambda: fa.flash_attention_fwd(q, k, v),
                 "3-f32": lambda: fa.flash_attention_fwd_packed(q, k, v),
                 "4-f32": lambda: fa.flash_attention_fwd_fusedheads(qf, kf, vf, h)}
        for name, fn in calls.items():
            o = fn()[0]
            if name == "4-f32":
                o = fa.split_heads(o, h)
            rows.append({"kernel": name, "shape": f"B={b} h={h} Lq={L} Lk={lk} d={d}",
                         "ms": ms(fn), "flops": flops, "err": share(o, o_ref)})
        if library:
            rows.append({"kernel": "SDPA f32", "shape": rows[-1]["shape"], "flops": flops,
                         "ms": ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                         "err": share(F.scaled_dot_product_attention(q, k, v), o_ref)})
        del q, k, v, qf, kf, vf, o_ref
        torch.cuda.empty_cache()
    for bh, g in ((12, 64), (300, 14)):
        n, d = g * g, 64
        q, k, v = (rand((1, bh, n, d), n + i) for i in range(3))
        bias_h, bias_w = rand((1, bh, n, g), n + 3), rand((1, bh, n, g), n + 4)
        o_ref = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
        flops = 4 * bh * n * n * d
        shape = f"B*H={bh} N={n} d={d}"
        fn = lambda: sa.sam_attention(q, k, v, bias_h, bias_w)  # noqa: E731
        rows.append({"kernel": "5-f32", "shape": shape, "ms": ms(fn), "flops": flops,
                     "err": share(fn(), o_ref)})
        if library:
            mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(1, bh, n, n)
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)  # noqa: E731
            rows.append({"kernel": "SDPA f32 (dense bias)", "shape": shape, "ms": ms(lib),
                         "flops": flops, "err": share(lib(), o_ref)})
            del mask
        torch.cuda.empty_cache()
    print(json.dumps(rows), flush=True)


def _child_phase2(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from lmdx_torch.nn.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["attention_f32", "pair_stats"])
    kernels = chip_smoke.phase_f32_kernels()
    kernels.update(chip_smoke.phase_f32_optin_kernels(kernels["flash_attention_bwd_f32"],
                                                      chip_smoke._totals()))
    for name, t in kernels.items():
        print(f"total {name}: ms {t['ms']:.3f} plain {t['plain_ms']:.3f} library "
              f"{t['library_ms']:.3f} bound {t['bound_ms']:.3f} err {t['err']:.2e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="NAME=DIR")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", choices=("dominant", "paths"), default="dominant")
    ap.add_argument("--phase2", action="store_true")
    ap.add_argument("--child", nargs=2, metavar=("DIR", "LIBRARY"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        if args.phase2:
            _child_phase2(args.child[0])
        else:
            _child(args.child[0], args.shapes, args.reps, args.child[1] == "1")
        return
    trees = [t.split("=", 1) for t in args.tree]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from lmdx_torch.nn.kernels import build as b; b.build(['attention_f32']); "
             "from lmdx_torch.nn.kernels.build import ptxas_report as r; "
             "[print(sys.argv[1], k) for k in r(b.BUILD_LOG.get('attention_f32', ''))]")
    procs = [subprocess.Popen([sys.executable, "-c", build, os.path.abspath(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _, d in trees]
    for (name, _), p in zip(trees, procs):
        out, _ = p.communicate()
        print(f"build {name}: exit {p.returncode}", flush=True)
        print(out, flush=True)
        if p.returncode:
            sys.exit(1)
    order = []
    for r in range(args.rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    for i, (name, d) in enumerate(order):
        out = subprocess.run([sys.executable, __file__, "--tree", "x=x", "--shapes", args.shapes,
                              "--reps", str(args.reps), *(["--phase2"] if args.phase2 else []),
                              "--child", os.path.abspath(d), "1" if i == 0 else "0"],
                             capture_output=True, text=True)
        if out.returncode:
            print(f"{name}: exit {out.returncode}\n{out.stdout}\n{out.stderr}", flush=True)
            sys.exit(1)
        if args.phase2:
            print("\n".join(f"{name:>10} {line}" for line in out.stdout.splitlines()), flush=True)
            continue
        for row in json.loads(out.stdout.strip().splitlines()[-1]):
            print(f"{name:>10} {row['kernel']:>22} {row['shape']:<32} {row['ms']:.3f} ms "
                  f"{row['flops'] / row['ms'] / 1e9:.1f} TFLOP/s err {row['err']:.1e}",
                  flush=True)


if __name__ == "__main__":
    main()
