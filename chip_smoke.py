#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmdx_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N]

Three phases; any failure exits nonzero before the final line is printed.

1. Build: compiles every CUDA source of the port (`lmdx_torch/csrc/*.cu`),
   one nvcc per source, all started together, into build/kernels/.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (8 heads; (L, head_dim) = (4096, 40), (1024, 80),
   (256, 160); KV = L and L + 30, the GLIGEN fuser). The forward runs at
   batch 8 (2 images x 2 boxes x CFG), the backward at batch 2 (the guidance
   batch). Tolerance: max|kernel - plain| <= 2e-2 * max|plain| for each bf16
   output (the kernels round p and dS to bf16 for the tensor cores) and 1e-3
   for the f32 LSE. Times: CUDA events over repeated launches; bound = the
   larger of (bytes each input read once + each output written once) / 3.35
   TB/s and operations / 989 TFLOP/s (H100 SXM dense bf16); library = one
   PyTorch call computing the same function (SDPA's flash forward, and its
   backward op), a yardstick only.
3. Main path: `run_lmd_plus_batch` on the full-width SD1.4+GLIGEN bundle
   (random weights from seed 0), 512x512, DDIM, CFG 7.5, frozen ratio 0.5,
   GLIGEN beta 0.4, CA-energy guidance with reference-CA transfer, on the
   first two of bench.py's layouts (2 images x 2 boxes). Checks the images,
   the frozen masks, and that the kernels' launch counts match what the
   schedule and the guidance iterations imply.

Matmuls and convolutions run in bf16; TF32 is turned off for both
(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32),
so the plain versions' f32 products are full f32.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2
TOL_LSE = 1e-3

# The first two of bench.py's layouts (2 boxes each).
SPECS = [
    {"prompt": "A realistic photo of a scene with brown dog and white cat",
     "gen_boxes": [("a brown dog", (60, 270, 170, 180)),
                   ("a white cat", (290, 300, 150, 150))],
     "bg_prompt": "A realistic photo of a scene", "extra_neg_prompt": ""},
    {"prompt": "A realistic photo of a scene with red car and blue bus",
     "gen_boxes": [("a red car", (70, 278, 170, 180)),
                   ("a blue bus", (284, 300, 150, 150))],
     "bg_prompt": "A realistic photo of a scene", "extra_neg_prompt": ""},
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from lmdx_torch.nn.kernels import build as buildlib

    t0 = time.perf_counter()
    paths = buildlib.build()
    log(f"build: {len(paths)} sources in {time.perf_counter() - t0:.2f} s -> "
        f"{sorted(str(p.relative_to(HERE)) for p in paths.values())}")
    for name, text in buildlib.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _inputs(b, h, lq, lk, d, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(L):
        return torch.randn((b, h, L, d), generator=g, device="cuda").to(torch.bfloat16)

    return mk(lq), mk(lk), mk(lk), mk(lq)


def _err(got, want, rel=TOL_REL):
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= rel * max(want.float().abs().max().item(), 1e-6)
    return err, ok


def _bound(total: dict, flops: float, nbytes: float) -> float:
    """Least time (ms) for the work: operations at the bf16 peak or bytes at
    the memory rate, whichever is longer; tallies both in `total`."""
    ops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    total["ops_ms"] += ops_ms
    total["bytes_ms"] += bytes_ms
    return max(ops_ms, bytes_ms)


def phase_kernels():
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    heads, fwd_batch, bwd_batch = 8, 8, 2
    totals = {
        name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
                   ops_ms=0.0, bytes_ms=0.0)
        for name in ("flash_attention_fwd", "flash_attention_bwd")
    }
    library_ok = {"flash_attention_fwd": True, "flash_attention_bwd": True}
    for L, d in ((4096, 40), (1024, 80), (256, 160)):
        for lk in (L, L + 30):
            reps = 5 if L == 4096 else 20
            scale = d ** -0.5
            # forward, batch 8
            q, k, v, _ = _inputs(fwd_batch, heads, L, lk, d, seed=L + lk)
            o, lse = fa.flash_attention_fwd(q, k, v)
            o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
            torch.cuda.synchronize()
            e_o, ok_o = _err(o, o_ref)
            e_l = (lse - lse_ref).abs().max().item()
            if not (ok_o and e_l <= TOL_LSE):
                fail(f"forward disagrees at L={L} Lk={lk} d={d}: |dO|={e_o} |dLSE|={e_l}")
            bh = fwd_batch * heads
            flops = 4 * bh * L * lk * d
            nbytes = 2 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
            bound = _bound(totals["flash_attention_fwd"], flops, nbytes)
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
            plain = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v), reps)
            lib = None
            try:
                lib = cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, False, False, scale=scale), reps)
            except (RuntimeError, TypeError) as exc:  # a yardstick only; the port never calls it
                library_ok["flash_attention_fwd"] = False
                log(f"  library forward unavailable: {type(exc).__name__}: {exc}")
            t = totals["flash_attention_fwd"]
            t["ms"] += ms
            t["plain_ms"] += plain
            t["bound_ms"] += bound
            t["library_ms"] += lib or 0.0
            t["err"] = max(t["err"], e_o)
            log(f"  fwd B={fwd_batch} h={heads} Lq={L} Lk={lk} d={d}: {ms:.3f} ms "
                f"(plain {plain:.3f}, library {lib if lib is None else round(lib, 3)}, "
                f"bound {bound:.3f}, {flops / ms / 1e9:.1f} TFLOP/s) "
                f"err O {e_o:.2e} LSE {e_l:.2e}")
            del q, k, v, o, lse, o_ref, lse_ref
            torch.cuda.empty_cache()

            # backward, batch 2
            q, k, v, do = _inputs(bwd_batch, heads, L, lk, d, seed=L + lk + 1)
            o, lse = fa.flash_attention_fwd(q, k, v)
            got = fa.flash_attention_bwd(q, k, v, lse, o, do)
            want = fa.attention_bwd_plain(q, k, v, lse, o, do)
            torch.cuda.synchronize()
            errs = [_err(g_, w_) for g_, w_ in zip(got, want)]
            if not all(ok for _, ok in errs):
                fail(f"backward disagrees at L={L} Lk={lk} d={d}: "
                     f"{[e for e, _ in errs]}")
            bh = bwd_batch * heads
            flops = 10 * bh * L * lk * d
            nbytes = 2 * bh * d * (3 * L + 2 * lk) + 4 * bh * L + 2 * bh * d * (L + 2 * lk)
            bound = _bound(totals["flash_attention_bwd"], flops, nbytes)
            ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, lse, o, do), reps)
            plain = cuda_ms(lambda: fa.attention_bwd_plain(q, k, v, lse, o, do), reps)
            lib = None
            try:
                outs = torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, False, False, scale=scale)
                lo, llse, cq, ck, mq, mk_, seed_, off_ = outs[:8]
                lib = cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    do, q, k, v, lo, llse, cq, ck, mq, mk_, 0.0, False, seed_, off_,
                    scale=scale), reps)
            except (RuntimeError, TypeError) as exc:  # a yardstick only; the port never calls it
                library_ok["flash_attention_bwd"] = False
                log(f"  library backward unavailable: {type(exc).__name__}: {exc}")
            t = totals["flash_attention_bwd"]
            t["ms"] += ms
            t["plain_ms"] += plain
            t["bound_ms"] += bound
            t["library_ms"] += lib or 0.0
            t["err"] = max(t["err"], max(e for e, _ in errs))
            log(f"  bwd B={bwd_batch} h={heads} Lq={L} Lk={lk} d={d}: {ms:.3f} ms "
                f"(plain {plain:.3f}, library {lib if lib is None else round(lib, 3)}, "
                f"bound {bound:.3f}, {flops / ms / 1e9:.1f} TFLOP/s) "
                f"err dq/dk/dv {[f'{e:.2e}' for e, _ in errs]}")
            del q, k, v, do, o, lse, got, want
            torch.cuda.empty_cache()
    for name in totals:
        if not library_ok[name]:
            totals[name]["library_ms"] = None
    return totals


def _expected_launches(cfg, num_steps, fuser_beta, guidance_iters):
    """Forward/backward flash launches implied by the schedule.

    Every self-attention and GLIGEN-fuser attention with >= 256 tokens takes
    the kernel. A full UNet forward has `full` such self-attention layers
    (and as many fuser layers while the fuser is on); the guidance forward
    exits after the last tapped block (up_1) and has `early` of each.
    guidance_iters: [(step_index, iterations)] from the overall pass."""
    from lmdx_torch.sampling.guidance import default_guidance_keys

    ucfg = cfg.unet
    res = cfg.latent_height  # tokens per side at level 0
    levels = len(ucfg.block_out_channels)
    full = early = 0
    last_up = max(k[1] for k in default_guidance_keys(ucfg) if k[0] == "up")
    for i, kind in enumerate(ucfg.down_block_types):
        if kind == "CrossAttnDownBlock2D" and (res >> i) ** 2 >= 256:
            full += ucfg.layers_per_block
            early += ucfg.layers_per_block
    for i, kind in enumerate(ucfg.up_block_types):
        level = levels - 1 - i
        if kind == "CrossAttnUpBlock2D" and (res >> level) ** 2 >= 256:
            full += ucfg.layers_per_block + 1
            if i <= last_up:
                early += ucfg.layers_per_block + 1
    if (res >> (levels - 1)) ** 2 >= 256:
        full += 1
        early += 1
    fuser_steps = int(fuser_beta * num_steps)
    per_pass = num_steps * full + fuser_steps * full
    guid = sum(n * (early + (early if step < fuser_steps else 0))
               for step, n in guidance_iters)
    return 2 * per_pass + guid, guid, full, early, fuser_steps


def _profile_summary(prof, wall: float, path: str) -> None:
    """Device time by kernel over the profiled main path: the flash kernels'
    share, the rest, and the idle share of the wall time; the top kernels go
    to `path`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        log("profile: the profiler reported no device time")
        return
    flash = sum(ms for k, ms, _ in rows if "flash_" in k)
    rows.sort(key=lambda r: -r[1])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"device busy {busy:.1f} ms of wall {wall * 1e3:.1f} ms\n")
        for k, ms, n in rows[:40]:
            f.write(f"{ms:10.1f} ms {100 * ms / busy:5.1f}% {n:7d}x  {k[:110]}\n")
    log(f"profile: device busy {busy / 1e3:.2f} s of {wall:.2f} s wall "
        f"(idle {100 * (1 - busy / (wall * 1e3)):.1f}%); flash kernels {flash / 1e3:.2f} s "
        f"({100 * flash / busy:.1f}% of busy); top kernels in {os.path.relpath(path, HERE)}")
    for k, ms, n in rows[:8]:
        log(f"  {ms:9.1f} ms {100 * ms / busy:5.1f}% {n:6d}x  {k[:90]}")


def phase_main_path(steps: int, profile: str | None = None):
    import numpy as np
    import torch

    from lmdx_torch.methods import base
    from lmdx_torch.methods.batch import run_lmd_plus_batch
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.runtime import models
    from lmdx_torch.sampling import guidance as guidance_lib
    from lmdx_torch.sampling import loop as loop_lib

    t0 = time.perf_counter()
    bundle = models.load_bundle("gligen/diffusers-generation-text-box", seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    log(f"main path: bundle (random weights, seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")

    # Instrumentation: guidance iterations per step, and the decoded latents.
    iters, decoded = [], []
    step_of_call = {"step": None}
    orig_update = guidance_lib.guidance_update_batched
    orig_loss = guidance_lib.ca_loss_batched
    orig_decode = base.decode_latents

    def update(unet_taps, latents, loss_in, **kw):
        step_of_call["step"] = len(iters)
        iters.append([len(iters), 0])
        return orig_update(unet_taps, latents, loss_in, **kw)

    def loss(*a, **kw):
        iters[-1][1] += 1
        return orig_loss(*a, **kw)

    def decode(bundle_, latents):
        decoded.append(bool(torch.isfinite(latents).all().item()))
        return orig_decode(bundle_, latents)

    loop_lib.guidance_lib.guidance_update_batched = update
    guidance_lib.ca_loss_batched = loss
    base.decode_latents = decode
    try:
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        prof = None
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        results = run_lmd_plus_batch(SPECS, bundle, bg_seeds=[1, 2],
                                     num_inference_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        if prof is not None:
            prof.__exit__(None, None, None)
            _profile_summary(prof, wall, profile)
    finally:
        loop_lib.guidance_lib.guidance_update_batched = orig_update
        guidance_lib.ca_loss_batched = orig_loss
        base.decode_latents = orig_decode

    cfg = bundle.config
    for r in results:
        img = r.image
        if img.dtype != np.uint8 or img.shape != (cfg.height, cfg.width, 3):
            fail(f"image {img.dtype} {img.shape}")
        if img.std() == 0:
            fail("constant image")
        if r.aux["frozen_mask"].sum() <= 0:
            fail("empty frozen mask")
    if not decoded or not all(decoded):
        fail(f"non-finite latents reached the VAE: {decoded}")

    p = GroundedParams(num_inference_steps=steps)
    expected_fwd, expected_bwd, full, early, fuser_steps = _expected_launches(
        cfg, steps, 0.4, [tuple(x) for x in iters])
    budgets = p.overall_max_iter
    ladder_max = sum(
        (budgets[i] if i < len(budgets) else budgets[-1])
        * (early + (early if i < fuser_steps else 0))
        for i in range(min(p.overall_max_index_step, steps)))
    log(f"main path: guidance iterations per step {[n for _, n in iters]}")
    log(f"main path: launches {launches}; expected forward {expected_fwd} "
        f"(full UNet {full} per forward, early-exit {early}), backward "
        f"{expected_bwd} (ladder max {ladder_max})")
    if launches["flash_attention_fwd"] != expected_fwd:
        fail(f"forward launches {launches['flash_attention_fwd']} != {expected_fwd}")
    if not (0 < launches["flash_attention_bwd"] <= ladder_max
            and launches["flash_attention_bwd"] == expected_bwd):
        fail(f"backward launches {launches['flash_attention_bwd']} "
             f"(expected {expected_bwd}, ladder max {ladder_max})")
    n_img = len(results)
    log(f"main path: {n_img} images x 2 boxes, 512x512, {steps} DDIM steps: "
        f"wall {wall:.2f} s, {n_img / wall:.4f} images/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the main path (depth only; width is full)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the main path with torch.profiler and write the "
                         "device time by kernel to PATH (the wall time then "
                         "includes the tracing cost)")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(HERE, "lmdx_torch")):
        fail("lmdx_torch/ is not beside chip_smoke.py: run it from a checkout of the repo")
    try:
        import torch
    except ImportError as exc:
        fail(f"PyTorch is not installed: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = gpu_name_and_limit()
    log(f"gpu: {card}")

    t_all = time.perf_counter()
    phase_build()
    kernels = phase_kernels()
    launches = phase_main_path(args.steps, args.profile)

    sources = {"flash_attention_fwd": ("lmdx_torch/csrc/flash_fwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:107"),
               "flash_attention_bwd": ("lmdx_torch/csrc/flash_bwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:384")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"],
         "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
         "library_ms": t["library_ms"]}
        for name, t in kernels.items()]}
    log("kernel times: ms, plain_ms, bound_ms and library_ms are sums of one call "
        "at each of the six main-path shapes above")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
