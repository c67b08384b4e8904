#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmdx_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--lmd-steps N] [--profile PATH]

Four phases; any failure exits nonzero before the final line is printed.

1. Build: compiles every CUDA source of the port (`lmdx_torch/csrc/*.cu`),
   one nvcc per source, all started together, into build/kernels/.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes. Flash attention: 8 heads; (L, head_dim) =
   (4096, 40), (1024, 80), (256, 160); at every batch and KV the two driven
   paths give each kernel (FWD_CASES, BWD_CASES): the forward at batch 8
   (per-box passes: 4 boxes x CFG), 4 (overall passes: 2 images x CFG; LMD's
   per-box guidance) and 2 (overall guidance), each with KV = L and L + 30
   (the GLIGEN fuser); the backward at batch 2 (overall guidance; KV = L and
   L + 30) and batch 4 (LMD's per-box guidance of 4 boxes; KV = L, as SD1.5
   has no fuser). SAM attention: one 4-image chunk of SAM ViT-B, the
   global layers (B*H = 48, N = 64 x 64, d = 64) and the windowed ones
   (B*H = 1200, N = 14 x 14), with random f32 bias. Tolerance:
   max|kernel - plain| <= 2e-2 * max|plain| for each bf16 output (the
   kernels round p and dS to bf16 for the tensor cores) and 1e-3 for the
   f32 LSE. Times: CUDA events over repeated launches; bound = the larger of
   (bytes each input read once + each output written once) / 3.35 TB/s and
   tensor-core operations / 989 TFLOP/s (H100 SXM dense bf16); library =
   one PyTorch call computing the same function (SDPA's flash forward and
   its backward op; for SAM, SDPA with the dense (B, H, N, N) bias
   materialized outside the timed call as its mask), a yardstick only.
3. LMD+ path: `run_lmd_plus_batch` on the full-width SD1.4+GLIGEN bundle
   (random weights from seed 0), 512x512, DDIM, CFG 7.5, frozen ratio 0.5,
   GLIGEN beta 0.4, CA-energy guidance with reference-CA transfer, the
   weightless CoarseSegmenter, on the first two of bench.py's layouts
   (2 images x 2 boxes). Checks the images, the frozen masks, and that the
   kernels' launch counts match what the schedule and the guidance
   iterations imply.
4. LMD path: `run_lmd_batch` (training-free LMD: per-box guidance, SAM masks
   prompted by the boxes' attention, host alignment) on full-width SD1.5
   (random weights, seed 0) with SAM ViT-B at its published size (random
   weights, seed 0), same layouts, 512x512, 50 DDIM steps. Checks the
   images, the per-box masks (64x64, not all empty), the flash launches
   against the schedule and both passes' guidance iterations, the SAM
   launches (12 per chunk of 4 boxes), then one more box-prompted
   `segment_batch` on the per-box images (+12 launches).

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


# (batch, Lk - L) of every call the driven paths make to each flash kernel.
# Forward: UNet batch 8 (per-box passes: 4 boxes x CFG), 4 (overall passes:
# 2 images x CFG; LMD's per-box guidance: 4 boxes) and 2 (overall guidance),
# each with KV = L and, in LMD+, the GLIGEN fuser's L + 30. Backward: batch 2
# (overall guidance of both paths, fuser KV in LMD+) and 4 (LMD's per-box
# guidance; SD1.5 has no fuser).
FWD_CASES = [(b, extra) for b in (8, 4, 2) for extra in (0, 30)]
BWD_CASES = [(2, 0), (2, 30), (4, 0)]


def _totals():
    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
                ops_ms=0.0, bytes_ms=0.0, library_ok=True)


def _library_ms(t, what, fn, reps):
    """Times one PyTorch call computing the same function (a yardstick only;
    the port never calls it), or records that this build lacks it."""
    try:
        return cuda_ms(fn, reps)
    except (RuntimeError, TypeError) as exc:
        t["library_ok"] = False
        log(f"  library {what} unavailable: {type(exc).__name__}: {exc}")
        return None


def _add(t, ms, plain, bound, lib, err):
    t["ms"] += ms
    t["plain_ms"] += plain
    t["bound_ms"] += bound
    t["library_ms"] += lib or 0.0
    t["err"] = max(t["err"], err)


def _fmt(ms, plain, lib, bound, flops):
    return (f"{ms:.3f} ms (plain {plain:.3f}, library "
            f"{lib if lib is None else round(lib, 3)}, bound {bound:.4f}, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")


def phase_kernels():
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    heads = 8
    fwd, bwd = _totals(), _totals()
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    for L, d in ((4096, 40), (1024, 80), (256, 160)):
        reps = 5 if L == 4096 else 20
        scale = d ** -0.5
        for b, extra in FWD_CASES:
            lk = L + extra
            q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b)
            o, lse = fa.flash_attention_fwd(q, k, v)
            o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
            torch.cuda.synchronize()
            e_o, ok_o = _err(o, o_ref)
            e_l = (lse - lse_ref).abs().max().item()
            if not (ok_o and e_l <= TOL_LSE):
                fail(f"forward disagrees at B={b} L={L} Lk={lk} d={d}: |dO|={e_o} "
                     f"|dLSE|={e_l}")
            bh = b * heads
            flops = 4 * bh * L * lk * d
            nbytes = 2 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
            bound = _bound(fwd, flops, nbytes)
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
            plain = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v), reps)
            lib = _library_ms(fwd, "forward", lambda: sdpa(
                q, k, v, 0.0, False, False, scale=scale), reps)
            _add(fwd, ms, plain, bound, lib, e_o)
            log(f"  fwd B={b} h={heads} Lq={L} Lk={lk} d={d}: "
                f"{_fmt(ms, plain, lib, bound, flops)} err O {e_o:.2e} LSE {e_l:.2e}")
            del q, k, v, o, lse, o_ref, lse_ref
            torch.cuda.empty_cache()

        for b, extra in BWD_CASES:
            lk = L + extra
            q, k, v, do = _inputs(b, heads, L, lk, d, seed=L + lk + b + 1)
            o, lse = fa.flash_attention_fwd(q, k, v)
            got = fa.flash_attention_bwd(q, k, v, lse, o, do)
            want = fa.attention_bwd_plain(q, k, v, lse, o, do)
            torch.cuda.synchronize()
            errs = [_err(g_, w_) for g_, w_ in zip(got, want)]
            if not all(ok for _, ok in errs):
                fail(f"backward disagrees at B={b} L={L} Lk={lk} d={d}: "
                     f"{[e for e, _ in errs]}")
            bh = b * heads
            flops = 10 * bh * L * lk * d
            nbytes = 2 * bh * d * (3 * L + 2 * lk) + 4 * bh * L + 2 * bh * d * (L + 2 * lk)
            bound = _bound(bwd, flops, nbytes)
            ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, lse, o, do), reps)
            plain = cuda_ms(lambda: fa.attention_bwd_plain(q, k, v, lse, o, do), reps)
            lib = None
            try:
                outs = sdpa(q, k, v, 0.0, False, False, scale=scale)
            except (RuntimeError, TypeError) as exc:  # a yardstick only
                bwd["library_ok"] = False
                log(f"  library backward unavailable: {type(exc).__name__}: {exc}")
            else:
                lo, llse, cq, ck, mq, mk_, seed_, off_ = outs[:8]
                lib = _library_ms(bwd, "backward", lambda: sdpa_bwd(
                    do, q, k, v, lo, llse, cq, ck, mq, mk_, 0.0, False, seed_, off_,
                    scale=scale), reps)
            _add(bwd, ms, plain, bound, lib, max(e for e, _ in errs))
            log(f"  bwd B={b} h={heads} Lq={L} Lk={lk} d={d}: "
                f"{_fmt(ms, plain, lib, bound, flops)} "
                f"err dq/dk/dv {[f'{e:.2e}' for e, _ in errs]}")
            del q, k, v, do, o, lse, got, want
            torch.cuda.empty_cache()
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def phase_sam_kernel():
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import sam_attention as sa

    t = _totals()
    heads, d = 12, 64
    # One 4-box chunk of SAM ViT-B: the global layers and the 14x14 windows.
    for bh, g, reps in ((4 * heads, 64, 5), (4 * 25 * heads, 14, 20)):
        n = g * g
        gen = torch.Generator(device="cuda").manual_seed(n)

        def mk(last, dtype):
            return torch.randn((1, bh, n, last), generator=gen, device="cuda").to(dtype)

        q, k, v = (mk(d, torch.bfloat16) for _ in range(3))
        bias_h, bias_w = mk(g, torch.float32), mk(g, torch.float32)
        o = sa.sam_attention(q, k, v, bias_h, bias_w)
        o_ref = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
        torch.cuda.synchronize()
        err, ok = _err(o, o_ref)
        if not ok:
            fail(f"sam_attention disagrees at B*H={bh} N={n}: |dO|={err}")
        del o_ref
        flops = 4 * bh * n * n * d
        nbytes = 2 * bh * n * d * 4 + 4 * bh * n * 2 * g
        bound = _bound(t, flops, nbytes)
        ms = cuda_ms(lambda: sa.sam_attention(q, k, v, bias_h, bias_w), reps)
        plain = cuda_ms(lambda: sa.sam_attention_plain(q, k, v, bias_h, bias_w), reps)
        torch.cuda.empty_cache()
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(1, bh, n, n)
        mask = mask.to(torch.bfloat16)
        lib = _library_ms(t, "SAM attention", lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), reps)
        del mask
        _add(t, ms, plain, bound, lib, err)
        log(f"  sam B*H={bh} N={n} d={d} grid {g}x{g}: "
            f"{_fmt(ms, plain, lib, bound, flops)}, {nbytes / ms / 1e6:.1f} GB/s, "
            f"err O {err:.2e}")
        del q, k, v, bias_h, bias_w, o
        torch.cuda.empty_cache()
    return t


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
    """Device time by kernel over a profiled path: the port's kernels'
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
    sam = sum(ms for k, ms, _ in rows if "sam_attention" in k)
    rows.sort(key=lambda r: -r[1])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"device busy {busy:.1f} ms of wall {wall * 1e3:.1f} ms\n")
        for k, ms, n in rows[:40]:
            f.write(f"{ms:10.1f} ms {100 * ms / busy:5.1f}% {n:7d}x  {k[:110]}\n")
    log(f"profile: device busy {busy / 1e3:.2f} s of {wall:.2f} s wall "
        f"(idle {100 * (1 - busy / (wall * 1e3)):.1f}%); flash kernels {flash / 1e3:.2f} s "
        f"({100 * flash / busy:.1f}% of busy); sam_attention {sam / 1e3:.2f} s "
        f"({100 * sam / busy:.1f}%); top kernels in {os.path.relpath(path, HERE)}")
    for k, ms, n in rows[:8]:
        log(f"  {ms:9.1f} ms {100 * ms / busy:5.1f}% {n:6d}x  {k[:90]}")


def _ladder_max(budgets, max_index_step, steps, early, fuser_steps=0) -> int:
    """Backward launches if every guided step of a pass runs its full budget."""
    return sum((budgets[i] if i < len(budgets) else budgets[-1])
               * early * (2 if i < fuser_steps else 1)
               for i in range(min(max_index_step, steps)))


def _drive(label, run, cfg, steps, fuser_beta, ladders, expected_sam, profile=None,
           segmenter=None):
    """Drives one main path through its entry point and checks it.

    `run()` is called once with every launch count set to 0 just before it;
    the counts are read just after. Meanwhile each sampling pass's guidance
    iterations per step, the decoded latents' finiteness and the segmenter's
    wall time are recorded (and with `profile`, a torch.profiler breakdown
    is written there). Checks the images (uint8, cfg-sized, non-constant,
    from finite latents), that the flash launches equal what the schedule and
    the recorded iterations imply (the backward also within the ladders'
    maximum; ladders: (iteration budgets, max_index_step) of each guided
    pass) and that SAM launched `expected_sam` times. Returns the results and
    the launch counts."""
    import numpy as np
    import torch

    from lmdx_torch.methods import base
    from lmdx_torch.methods import batch as batch_lib
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.sampling import guidance as guidance_lib

    passes, decoded, seg_walls = [], [], []
    orig_sample = batch_lib.sample
    orig_update = guidance_lib.guidance_update_batched
    orig_loss = guidance_lib.ca_loss_batched
    orig_decode = base.decode_latents
    orig_segment = segmenter.segment_batch if segmenter is not None else None

    def sample(*a, **kw):
        passes.append([])
        return orig_sample(*a, **kw)

    def update(*a, **kw):
        passes[-1].append(0)
        return orig_update(*a, **kw)

    def loss(*a, **kw):
        passes[-1][-1] += 1
        return orig_loss(*a, **kw)

    def decode(bundle_, latents):
        decoded.append(bool(torch.isfinite(latents).all().item()))
        return orig_decode(bundle_, latents)

    def segment_batch(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_segment(*a, **kw)  # host numpy: synchronous
        seg_walls.append(time.perf_counter() - t)
        return out

    batch_lib.sample = sample
    guidance_lib.guidance_update_batched = update
    guidance_lib.ca_loss_batched = loss
    base.decode_latents = decode
    if segmenter is not None:
        segmenter.segment_batch = segment_batch
    try:
        fa.reset_launch_counts()
        sa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        prof = None
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        results = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **sa.LAUNCHES}
        if prof is not None:
            prof.__exit__(None, None, None)
            _profile_summary(prof, wall, profile)
    finally:
        batch_lib.sample = orig_sample
        guidance_lib.guidance_update_batched = orig_update
        guidance_lib.ca_loss_batched = orig_loss
        base.decode_latents = orig_decode
        if segmenter is not None:
            segmenter.segment_batch = orig_segment

    for r in results:
        img = r.image
        if img.dtype != np.uint8 or img.shape != (cfg.height, cfg.width, 3):
            fail(f"{label}: image {img.dtype} {img.shape}")
        if img.std() == 0:
            fail(f"{label}: constant image")
    if not decoded or not all(decoded):
        fail(f"{label}: non-finite latents reached the VAE: {decoded}")

    if len(passes) != 2:
        fail(f"{label}: {len(passes)} sampling passes, expected 2")
    iters = [(i, n) for pass_iters in passes for i, n in enumerate(pass_iters)]
    expected_fwd, expected_bwd, full, early, fuser_steps = _expected_launches(
        cfg, steps, fuser_beta, iters)
    ladder_max = sum(_ladder_max(budgets, max_index, steps, early, fuser_steps)
                     for budgets, max_index in ladders)
    log(f"{label}: guidance iterations per step, per-box pass {passes[0]}, overall "
        f"pass {passes[1]}")
    log(f"{label}: launches {launches}; expected forward {expected_fwd} (full UNet "
        f"{full} per forward, early-exit {early}), backward {expected_bwd} (ladder "
        f"max {ladder_max}), sam_attention {expected_sam}")
    if launches["flash_attention_fwd"] != expected_fwd:
        fail(f"{label}: forward launches {launches['flash_attention_fwd']} != "
             f"{expected_fwd}")
    if not (0 < launches["flash_attention_bwd"] <= ladder_max
            and launches["flash_attention_bwd"] == expected_bwd):
        fail(f"{label}: backward launches {launches['flash_attention_bwd']} "
             f"(expected {expected_bwd}, ladder max {ladder_max})")
    if launches["sam_attention"] != expected_sam:
        fail(f"{label}: sam_attention launches {launches['sam_attention']} != "
             f"{expected_sam}")
    seg = f", SAM segment wall {sum(seg_walls):.3f} s" if segmenter is not None else ""
    log(f"{label}: {len(results)} images x 2 boxes, {cfg.height}x{cfg.width}, {steps} "
        f"DDIM steps: wall {wall:.2f} s, {len(results) / wall:.4f} images/s{seg}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return results, launches


def phase_main_path(steps: int, profile: str | None = None):
    import torch

    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.methods.batch import run_lmd_plus_batch
    from lmdx_torch.runtime import models

    t0 = time.perf_counter()
    bundle = models.load_bundle("gligen/diffusers-generation-text-box", seed=0,
                                device="cuda")
    torch.cuda.synchronize()
    log(f"main path: bundle (random weights, seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")
    p = GroundedParams(num_inference_steps=steps)
    results, launches = _drive(
        "main path",
        lambda: run_lmd_plus_batch(SPECS, bundle, bg_seeds=[1, 2],
                                   num_inference_steps=steps),
        bundle.config, steps, 0.4, [(p.overall_max_iter, p.overall_max_index_step)],
        expected_sam=0, profile=profile)
    for r in results:
        if r.aux["frozen_mask"].sum() <= 0:
            fail("main path: empty frozen mask")
    del bundle
    torch.cuda.empty_cache()
    return launches


def phase_lmd(steps: int, profile: str | None = None):
    import numpy as np
    import torch

    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.methods.batch import run_lmd_batch
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.nn.sam import SamSegmenter
    from lmdx_torch.runtime import models

    t0 = time.perf_counter()
    bundle = models.load_bundle("runwayml/stable-diffusion-v1-5", seed=0, device="cuda")
    segmenter = SamSegmenter(models.build_sam(seed=0, device="cuda"))
    torch.cuda.synchronize()
    log(f"lmd: SD1.5 bundle and SAM ViT-B (random weights, seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = bundle.config
    p = GroundedParams(num_inference_steps=steps)
    n_boxes = sum(len(spec["gen_boxes"]) for spec in SPECS)
    expected_sam = segmenter.config.encoder_layers * -(-n_boxes // SamSegmenter.CHUNK)
    results, launches = _drive(
        "lmd",
        lambda: run_lmd_batch(SPECS, bundle, segmenter=segmenter, bg_seeds=[1, 2],
                              num_inference_steps=steps, return_so_images=True),
        cfg, steps, 0.0,
        [(p.max_iter, p.max_index_step), (p.overall_max_iter, p.overall_max_index_step)],
        expected_sam, profile=profile, segmenter=segmenter)
    areas = []
    for r in results:
        for m in r.aux["masks"]:
            if m.shape != (cfg.latent_height, cfg.latent_width):
                fail(f"lmd: per-box mask of shape {m.shape}")
            areas.append(int(m.sum()))
    log(f"lmd: per-box mask areas (of {cfg.latent_height * cfg.latent_width}) {areas}")
    if len(areas) != n_boxes or not any(areas):
        fail(f"lmd: per-box masks {areas} for {n_boxes} boxes: missing or all empty")

    # The LMD+ prompt kind (boxes) on the same per-box images.
    so_images = [im for r in results for im in r.so_img_list]
    boxes = [[(x / 512, y / 512, (x + w) / 512, (y + h) / 512)]
             for spec in SPECS for _, (x, y, w, h) in spec["gen_boxes"]]
    before = sa.LAUNCHES["sam_attention"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    box_out = segmenter.segment_batch(so_images, input_boxes=boxes,
                                      target_hw=(cfg.latent_height, cfg.latent_width))
    seg_wall = time.perf_counter() - t0
    added = sa.LAUNCHES["sam_attention"] - before
    box_areas = [[int(m.sum()) for m in masks] for masks, _ in box_out]
    log(f"lmd: box-prompted segment_batch of {len(so_images)} images: {seg_wall:.3f} s, "
        f"{added} sam_attention launches, mask areas {box_areas}")
    if added != expected_sam:
        fail(f"box-prompted segment_batch launched sam_attention {added} times, "
             f"expected {expected_sam}")
    if not all(np.isfinite(iou).all() for _, iou in box_out):
        fail("box-prompted segment_batch: non-finite IoU")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the main path (depth only; width is full)")
    ap.add_argument("--lmd-steps", type=int, default=50,
                    help="DDIM steps of the LMD path (depth only; width is full)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the LMD+ and LMD paths with torch.profiler and write "
                         "the device time by kernel to PATH and PATH with _lmd before "
                         "its extension (the wall times then include the tracing cost)")
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
    kernels["sam_attention"] = phase_sam_kernel()
    plus = phase_main_path(args.steps, args.profile)
    lmd_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        lmd_profile = f"{root}_lmd{ext}"
    lmd = phase_lmd(args.lmd_steps, lmd_profile)
    launches = {name: plus[name] + lmd[name] for name in kernels}
    log(f"launches: LMD+ path {plus}, LMD path {lmd}")

    sources = {"flash_attention_fwd": ("lmdx_torch/csrc/flash_fwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:107"),
               "flash_attention_bwd": ("lmdx_torch/csrc/flash_bwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:384"),
               "sam_attention": ("lmdx_torch/csrc/sam_attention.cu",
                                 "lmdx/nn/pallas/sam_attention.py:101")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"],
         "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
         "library_ms": t["library_ms"] if t["library_ok"] else None}
        for name, t in kernels.items()]}
    log(f"kernel times: ms, plain_ms, bound_ms and library_ms are sums of one call "
        f"at each shape above ({3 * len(FWD_CASES)} for the flash forward, "
        f"{3 * len(BWD_CASES)} for the backward, 2 for SAM); launches are those of "
        f"the LMD+ and LMD paths together")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
