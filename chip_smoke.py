#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmdx_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--lmd-steps N] [--optin-steps N]
                          [--single-steps N] [--baseline-steps N] [--ckpt-steps N]
                          [--profile PATH]

Eight phases; any failure exits nonzero before the final line is printed.
Phases 3-7 run on random weights (LMDX_CHECKPOINT_DIR is unset for them);
phase 8 loads checkpoints from disk.

1. Build: compiles every CUDA source of the port (`lmdx_torch/csrc/*.cu`,
   six), one nvcc per source, all started together, into build/kernels/, and
   prints each kernel's registers and spilled bytes (`ptxas -v`). Fails if
   an attention kernel (the forward body's four kernels and the backward's
   two) instantiated for a head dim the paths use (48, 64, 80, 160) spills.
2. Kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes. Flash attention: 8 heads; (L, head_dim) =
   (4096, 40), (1024, 80), (256, 160); at every batch and KV the driven
   paths give each kernel (FWD_CASES, BWD_CASES): the forward at batch 8
   (per-box passes: 4 boxes x CFG), 6 (MultiDiffusion: 3 regions x CFG, KV =
   L only), 4 (overall passes: 2 images x CFG; LMD's
   per-box guidance; a 2-box layout's per-box pass), 2 (overall guidance;
   one image x CFG; LMD's per-box guidance of 2 boxes) and 1 (single-image
   guidance), each with KV = L and L + 30 (the GLIGEN fuser); the backward
   at batch 4 (LMD's per-box guidance of 4 boxes; KV = L, as SD1.5 has no
   fuser), 2 (overall guidance; KV = L and L + 30) and 1 (single-image
   guidance; KV = L and L + 30). SAM attention: one 4-image chunk and one
   2-image chunk of SAM ViT-B, the global layers (B*H = 48 and 24, N =
   64 x 64, d = 64) and the windowed ones (B*H = 1200 and 600, N = 14 x 14),
   with random f32 bias. Tolerance:
   max|kernel - plain| <= 2e-2 * max|plain| for each bf16 output (the
   kernels round p and dS to bf16 for the tensor cores) and 1e-3 for the
   f32 LSE. Times: CUDA events over repeated launches queued behind a short
   device spin (device time, not the host's launch rate); bound = the larger of
   (bytes each input read once + each output written once) / 3.35 TB/s and
   tensor-core operations / 989 TFLOP/s (H100 SXM dense bf16); library =
   one PyTorch call computing the same function (SDPA's flash forward and
   its backward op; for SAM, SDPA with the dense (B, H, N, N) bias
   materialized outside the timed call as its mask), a yardstick only.
   The opt-in kernels, at every shape and batch the opt-in path (phase 5)
   gives them: the head-packed forward at L = 4096, d = 40 (KV = L and
   L + 30, batch 8/4/2), timed in turn with the per-head forward on the same
   inputs, which it must equal bit for bit (one block per q tile and head on
   kernel 1's tile); the fused-heads forward on the projection layout
   (B, L, 8 * d) at the self and fuser shapes of the 1024-, 256- and 64-token
   levels and the 77-token cross-attention of every level (batch 8/4/2); the
   backward at the short KV lengths the fused-heads gradient adds (KV = 77,
   64, 94; batch 2); `pair_stats` on bf16 (x, x) at every (C, N) of the UNet's
   GroupNorms (batch 8/4/2) and on f32 (a, b) at those of the guidance
   forward (batch 2), held to 1e-3 * max|plain| (f32 sums in another
   order), bound by bytes, library = `a.sum(-1)` with `(a * b).sum(-1)`
   (two calls).
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
5. Opt-in LMD+ path: the bundle of phase 3 built with
   `KernelOptions(packed_attention, fused_heads, fused_group_norm)` all on.
   First one UNet forward and one gradient of the guidance taps w.r.t. the
   latents (batch 2, GLIGEN on, same weights and inputs) against the bundle
   with the options off: max|on - off| <= 5e-2 * max|off| for each (bf16
   activations through 16 transformer blocks; the fused norms' f32
   var = m2 - mean^2 and the kernels' bf16 probabilities are the
   differences). Then `run_lmd_plus_batch` as in phase 3 (same layouts and
   seeds, 512x512, 50 DDIM steps) with phase 3's checks and the launch
   counts of all five UNet kernels against what the dispatch rule, the
   schedule and the guidance iterations imply (the per-head forward: 0).
6. Single-image methods: `lmdx_torch.methods.get_method(name).run(...)` on
   the first layout (2 boxes), 512x512, 50 DDIM steps, random weights from
   seed 0 at full width: `lmd_plus` and `gligen` on the SD1.4+GLIGEN bundle
   (LMD+ with the CoarseSegmenter), then `lmd` (with SAM ViT-B), `sd` and
   `backward_guidance` on the SD1.5 bundle; each bundle is built once for
   its methods and freed after. Checks each image and, for LMD and LMD+, the
   frozen mask as phases 3 and 4 do, the launches of every kernel against
   what the dispatch, the schedule and the recorded guidance iterations
   imply, and that every shape the flash and SAM wrappers were given is one
   that phase 2 checked.
7. Baselines and solvers: on one SD1.5 bundle (random weights, seed 0, full
   width, 512x512, 50 steps) and the first layout, `boxdiff` at its
   defaults (25 guided steps, one gradient step each), `multidiffusion` at
   its defaults (CFG 10, 20 bootstrap steps over 20 VAE-encoded
   backgrounds, one 64x64 view, the 3 regions one UNet batch of 6), `sd`
   and `backward_guidance` on DPM-Solver++(2M), then one DDIM `invert` of
   `sd`'s final latents at CFG 7.5 (decoded for the image checks). Each run
   has `_drive`'s image and launch checks (the launches as the schedule and
   the recorded guidance iterations imply: BoxDiff's guidance forwards keep
   the self-attentions on the flash kernels and its gradient on the
   backward kernel, as the JAX side routes them; invert launches 49 x 15),
   and every shape the flash wrappers were given must be one phase 2
   checked. `--baseline-steps` cuts the depth for a rehearsal.
8. Checkpoint path: fabricates `gligen/diffusers-generation-text-box` and
   `runwayml/stable-diffusion-v1-5` (diffusers layout) and
   `facebook--sam-vit-base` in fp16 at the published key names and shapes
   (`lmdx_torch.runtime.fabricate`, 2.43B values, ~4.9 GB) into a temporary
   directory, removed at the end; checks that `validate_checkpoint` is clean
   for both, that `load_bundle` refuses the checkpoint without a tokenizer
   (and loads it with LMDX_ALLOW_WORD_TOKENIZER=1, set for this phase only)
   and refuses dtype float32 on the card at load time; takes the template's
   in-context response for STAGE1_CAPTION through the port's parser and a
   LayoutCache file into a spec; then loads each bundle (and, for LMD, SAM
   through `load_segmenter`) on the card, printing the load wall, GB/s of
   file and peak memory, checks every loaded parameter bit for bit against
   the file's tensor cast to its dtype, and renders `lmd_plus` on the
   SD1.4+GLIGEN bundle and `lmd` with SAM on the SD1.5 bundle at 512x512,
   `--ckpt-steps` DDIM steps, with phase 6's checks (images, masks, launches,
   every wrapper shape one phase 2 checked). Each bundle is freed before the
   next.

Matmuls and convolutions run in bf16; TF32 is turned off for both
(torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32),
so the plain versions' f32 products are full f32.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2
TOL_LSE = 1e-3
TOL_SUMS = 1e-3           # pair_stats: f32 sums in another order
TOL_OPTIN = 5e-2          # options-on UNet against options-off, share of max|off|

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


HOLD_CYCLES = 10_000_000  # ~5 ms of device spin at the H100's clock


def cuda_ms(fn, reps: int) -> float:
    """Device time of one call: CUDA events around `reps` calls queued behind
    a short device spin, so that the host's launch cost (tens of microseconds
    a call through ctypes or a chain of small PyTorch ops) is paid while the
    device waits and the calls then run back to back."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# Head dims the attention kernels are instantiated for and the three paths
# use (40 -> 48, 64, 80, 160): none of their kernels may spill.
PATH_HEAD_DIMS = ("48", "64", "80", "160")
ATTENTION_SOURCES = ("flash_fwd", "flash_bwd", "sam_attention", "flash_fwd_packed",
                     "flash_fwd_fusedheads")


def phase_build():
    from lmdx_torch.nn.kernels import build as buildlib

    t0 = time.perf_counter()
    paths = buildlib.build()
    log(f"build: {len(paths)} sources in {time.perf_counter() - t0:.2f} s -> "
        f"{sorted(str(p.relative_to(HERE)) for p in paths.values())}")
    spilled = []
    for name, text in buildlib.BUILD_LOG.items():
        for k in buildlib.ptxas_report(text):
            log(f"  ptxas {name}: {k['kernel']}: {k['registers']} registers, "
                f"{k['spill_bytes']} bytes spilled")
            head_dim = re.split(r"[,>]", k["kernel"].partition("<")[2])[0]
            if k["spill_bytes"] and name in ATTENTION_SOURCES and head_dim in PATH_HEAD_DIMS:
                spilled.append(k["kernel"])
    if spilled:
        fail(f"build: kernels of the paths' head dims spill registers: {spilled}")


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


def _bound(total: dict, flops: float, nbytes: float,
           peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """Least time (ms) for the work: operations at the peak rate of their
    type (bf16 tensor cores unless given) or bytes at the memory rate,
    whichever is longer; tallies both in `total`."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    total["ops_ms"] += ops_ms
    total["bytes_ms"] += bytes_ms
    return max(ops_ms, bytes_ms)


# (batch, Lk - L) of every call the driven paths make to each flash kernel.
# Forward: UNet batch 8 (per-box passes: 4 boxes x CFG), 6 (MultiDiffusion's
# 3 regions of a 2-box layout x CFG; SD1.5 has no fuser), 4 (overall passes:
# 2 images x CFG; LMD's per-box guidance: 4 boxes; a 2-box layout's per-box
# pass), 2 (overall guidance; one image x CFG; LMD's per-box guidance of a
# 2-box layout) and 1 (single-image guidance), each with KV = L and, with
# GLIGEN, the fuser's L + 30. Backward: batch 2 (overall guidance of two
# images, fuser KV in LMD+; LMD's per-box guidance of 2 boxes), 4 (LMD's
# per-box guidance of 4 boxes; SD1.5 has no fuser) and 1 (single-image
# guidance, fuser KV in LMD+).
FWD_CASES = [(b, extra) for b in (8, 4, 2, 1) for extra in (0, 30)] + [(6, 0)]
BWD_CASES = [(2, 0), (2, 30), (4, 0), (1, 0), (1, 30)]
FLASH_LEVELS = ((4096, 40), (1024, 80), (256, 160))   # (tokens, head_dim) at 8 heads
# (B * heads, grid side) of SAM ViT-B's attention on a chunk of 4 images
# (the batched LMD path) and of 2 (one 2-box layout): global and windowed.
SAM_CASES = [(4 * 12, 64), (4 * 25 * 12, 14), (2 * 12, 64), (2 * 25 * 12, 14)]


# (Lq, Lk, head_dim) of the backward calls only the opt-in path makes.
BWD_SHORT_KV = [(4096, 77, 40), (1024, 77, 80), (256, 77, 160), (64, 77, 160),
                (64, 64, 160), (64, 94, 160)]


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


def _check_bwd(bwd, b, heads, L, lk, d, reps):
    """Holds the flash backward against its plain version at one shape and
    times it, its plain version and SDPA's flash backward op."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    scale = d ** -0.5
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
    torch.cuda.empty_cache()


def phase_kernels():
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    heads = 8
    fwd, bwd = _totals(), _totals()
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    for L, d in FLASH_LEVELS:
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
            _check_bwd(bwd, b, heads, L, L + extra, d, reps)
    default_ms = bwd["ms"]
    # The fused-heads gradient (phase 5) splits heads and calls the backward at
    # the KV lengths the default dispatch keeps on plain math: the 77-token
    # cross-attention of every level and the 64-token mid block (KV 64, and 94
    # with the fuser), at the guidance batch.
    for L, lk, d in BWD_SHORT_KV:
        _check_bwd(bwd, 2, heads, L, lk, d, 20)
    log(f"  bwd: {default_ms:.3f} ms over the {3 * len(BWD_CASES)} shapes of the default "
        f"paths, {bwd['ms'] - default_ms:.3f} ms over the {len(BWD_SHORT_KV)} short-KV "
        f"shapes of the opt-in path")
    return {"flash_attention_fwd": fwd, "flash_attention_bwd": bwd}


def phase_sam_kernel():
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import sam_attention as sa

    t = _totals()
    d = 64
    for bh, g in SAM_CASES:
        n, reps = g * g, 5 if g == 64 else 20
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


# The opt-in path's shapes (SD1.x at 512x512: 8 heads; (tokens, width) =
# (4096, 320), (1024, 640), (256, 1280), (64, 1280); 30 grounding tokens).
# Packed forward: what the fused-heads size rule refuses, (Lq, Lk - Lq).
PACKED_CASES = [(4096, 0), (4096, 30)]
# Fused-heads forward (Lq, Lk, heads * d): self and fuser attention of the
# three lower levels, then the 77-token cross-attention of every level.
FUSED_CASES = [(1024, 1024, 640), (1024, 1054, 640), (256, 256, 1280), (256, 286, 1280),
               (64, 64, 1280), (64, 94, 1280),
               (4096, 77, 320), (1024, 77, 640), (256, 77, 1280), (64, 77, 1280)]
# GroupNorm inputs (C, N) of a full UNet forward, and those of the guidance
# forward (which ends after up block 1), whose backward reads f32 pairs.
STAT_CASES = [(320, 4096), (640, 4096), (960, 4096),
              (320, 1024), (640, 1024), (960, 1024), (1280, 1024), (1920, 1024),
              (640, 256), (1280, 256), (1920, 256), (2560, 256), (1280, 64), (2560, 64)]
STAT_BWD_CASES = [(320, 4096), (320, 1024), (640, 1024), (640, 256), (1280, 256),
                  (1920, 256), (2560, 256), (1280, 64), (2560, 64)]
OPTIN_BATCHES = (8, 4, 2)


def phase_optin_kernels():
    """The three opt-in kernels against their plain versions, with times."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn

    heads = 8
    packed, fused, stats = _totals(), _totals(), _totals()
    sdpa = torch.ops.aten._scaled_dot_product_flash_attention

    d = 40
    per_head_total = 0.0
    for L, extra in PACKED_CASES:
        for b in OPTIN_BATCHES:
            lk = L + extra
            q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b + 2)
            o, lse = fa.flash_attention_fwd_packed(q, k, v)
            o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
            torch.cuda.synchronize()
            e_o, ok_o = _err(o, o_ref)
            e_l = (lse - lse_ref).abs().max().item()
            if not (ok_o and e_l <= TOL_LSE):
                fail(f"packed forward disagrees at B={b} L={L} Lk={lk} d={d}: |dO|={e_o} "
                     f"|dLSE|={e_l}")
            o_one, lse_one = fa.flash_attention_fwd(q, k, v)
            if not (torch.equal(o, o_one) and torch.equal(lse, lse_one)):
                fail(f"packed forward differs from the per-head kernel at B={b} L={L} "
                     f"Lk={lk} d={d}")
            del o, lse, o_ref, lse_ref, o_one, lse_one
            bh = b * heads
            flops = 4 * bh * L * lk * d
            nbytes = 2 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
            bound = _bound(packed, flops, nbytes)
            # Per-head and packed kernels in turns on the same inputs.
            turns = [cuda_ms(lambda: fn(q, k, v), 5)
                     for fn in (fa.flash_attention_fwd, fa.flash_attention_fwd_packed,
                                fa.flash_attention_fwd_packed, fa.flash_attention_fwd)]
            per_head, ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            per_head_total += per_head
            plain = cuda_ms(lambda: fa.attention_fwd_packed_plain(q, k, v), 5)
            lib = _library_ms(packed, "packed forward", lambda: sdpa(
                q, k, v, 0.0, False, False, scale=d ** -0.5), 5)
            _add(packed, ms, plain, bound, lib, e_o)
            log(f"  packed B={b} h={heads} Lq={L} Lk={lk} d={d}: "
                f"{_fmt(ms, plain, lib, bound, flops)}, per-head kernel {per_head:.3f} ms "
                f"(turns {[round(t, 3) for t in turns]}, packed/per-head {ms / per_head:.3f}; "
                f"equal bit for bit) err O {e_o:.2e} LSE {e_l:.2e}")
            del q, k, v
            torch.cuda.empty_cache()
    log(f"  packed: {packed['ms']:.3f} ms over {len(PACKED_CASES) * len(OPTIN_BATCHES)} "
        f"shapes, the per-head kernel {per_head_total:.3f} ms on the same inputs")

    for L, lk, hd in FUSED_CASES:
        d = hd // heads
        for b in OPTIN_BATCHES:
            gen = torch.Generator(device="cuda").manual_seed(L + lk + hd + b)

            def mk(rows):
                return torch.randn((b, rows, hd), generator=gen, device="cuda").to(
                    torch.bfloat16)

            qf, kf, vf = mk(L), mk(lk), mk(lk)
            o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, heads)
            o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, heads)
            torch.cuda.synchronize()
            e_o, ok_o = _err(o, o_ref)
            e_l = (lse - lse_ref).abs().max().item()
            if not (ok_o and e_l <= TOL_LSE):
                fail(f"fused-heads forward disagrees at B={b} Lq={L} Lk={lk} hd={hd}: "
                     f"|dO|={e_o} |dLSE|={e_l}")
            del o, lse, o_ref, lse_ref
            flops = 4 * b * heads * L * lk * d
            nbytes = 2 * b * hd * (2 * L + 2 * lk) + 4 * b * heads * L
            bound = _bound(fused, flops, nbytes)
            ms = cuda_ms(lambda: fa.flash_attention_fwd_fusedheads(qf, kf, vf, heads), 20)
            plain = cuda_ms(lambda: fa.attention_fwd_fusedheads_plain(qf, kf, vf, heads), 20)
            # SDPA's flash forward on the same memory: (B, h, L, d) views.
            q4, k4, v4 = (t.view(b, -1, heads, d).transpose(1, 2) for t in (qf, kf, vf))
            lib = _library_ms(fused, "fused-heads forward", lambda: sdpa(
                q4, k4, v4, 0.0, False, False, scale=d ** -0.5), 20)
            _add(fused, ms, plain, bound, lib, e_o)
            log(f"  fusedheads B={b} h={heads} Lq={L} Lk={lk} hd={hd}: "
                f"{_fmt(ms, plain, lib, bound, flops)}, {nbytes / ms / 1e6:.1f} GB/s, "
                f"err O {e_o:.2e} LSE {e_l:.2e}")
            del qf, kf, vf, q4, k4, v4
            torch.cuda.empty_cache()

    def stat_case(b, c, n, dtype, same):
        gen = torch.Generator(device="cuda").manual_seed(c + n + b)

        def mk():
            return (torch.randn((b, c, n), generator=gen, device="cuda") + 0.5).to(dtype)

        a = mk()
        other = a if same else mk()
        got = gn.pair_stats(a, other)
        want = gn.pair_stats_plain(a, other)
        torch.cuda.synchronize()
        errs = [_err(g_, w_, TOL_SUMS) for g_, w_ in zip(got, want)]
        if not all(ok for _, ok in errs):
            fail(f"pair_stats disagrees at B={b} C={c} N={n} {dtype}: "
                 f"{[e for e, _ in errs]}")
        elems = b * c * n
        nbytes = elems * a.element_size() * (1 if same else 2) + 2 * 4 * b * c
        bound = _bound(stats, 3 * elems, nbytes, PEAK_F32_FLOPS)
        ms = cuda_ms(lambda: gn.pair_stats(a, other), 20)
        plain = cuda_ms(lambda: gn.pair_stats_plain(a, other), 20)
        lib = _library_ms(stats, "pair_stats", lambda: (
            a.sum(-1, dtype=torch.float32), (a * other).sum(-1, dtype=torch.float32)), 20)
        # Relative error of the sums, so that sizes compare.
        rel = max(e / max(w_.abs().max().item(), 1e-6) for (e, _), w_ in zip(errs, want))
        _add(stats, ms, plain, bound, lib, max(e for e, _ in errs))
        log(f"  pair_stats B={b} C={c} N={n} {str(dtype).split('.')[-1]} "
            f"{'(x, x)' if same else '(a, b)'}: {ms:.4f} ms (plain {plain:.4f}, library "
            f"{lib if lib is None else round(lib, 4)} [two calls], bound {bound:.5f}, "
            f"{nbytes / ms / 1e6:.1f} GB/s) rel err {rel:.2e}")

    # What one call costs the host (one allocation, the ctypes launch): the
    # floor under the device times below when calls are not queued ahead.
    x = torch.zeros((2, 1280, 64), device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        gn.pair_stats(x, x)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"  pair_stats host time per call (B=2 C=1280 N=64): {host_us:.1f} us")
    for c, n in STAT_CASES:
        for b in OPTIN_BATCHES:
            stat_case(b, c, n, torch.bfloat16, True)
    for c, n in STAT_BWD_CASES:
        stat_case(2, c, n, torch.float32, False)
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_packed": packed, "flash_attention_fwd_fusedheads": fused,
            "pair_stats": stats}


def _expected_launches(cfg, num_steps, fuser_beta, guidance_iters, passes=2,
                       guidance_keys=None):
    """Forward/backward flash launches implied by the schedule.

    Every self-attention and GLIGEN-fuser attention with >= 256 tokens takes
    the kernel. A full UNet forward has `full` such self-attention layers
    (and as many fuser layers while the fuser is on); the guidance forward
    exits after the last tapped block (up_1 for the default guidance keys
    and BoxDiff's, `guidance_keys` else) and has `early` of each.
    `passes` sampling passes of `num_steps` steps each, the fuser on for the
    first `fuser_beta` of each; guidance_iters: [(step_index, iterations)]
    of every guided pass."""
    from lmdx_torch.sampling.guidance import default_guidance_keys

    ucfg = cfg.unet
    res = cfg.latent_height  # tokens per side at level 0
    levels = len(ucfg.block_out_channels)
    full = early = 0
    keys = guidance_keys or default_guidance_keys(ucfg)
    last_up = max(k[1] for k in keys if k[0] == "up")
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
    return passes * per_pass + guid, guid, full, early, fuser_steps


def _profile_summary(prof, wall: float, path: str) -> None:
    """Device time by kernel over a profiled path: the port's kernels'
    share, the rest, and the idle share of the wall time; the top kernels go
    to `path`."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    # The port's kernels by name, whatever their template arguments.
    by_name: dict[str, list] = {}
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        own = re.search(r"lmdx::.*?(\w+_kernel)", e.key)
        row = by_name.setdefault(own.group(1) if own else e.key, [0.0, 0])
        row[0] += e.self_device_time_total / 1e3
        row[1] += e.count
    rows = [(k, ms, n) for k, (ms, n) in by_name.items()]
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


def _ladder_max(budgets, max_index_step, steps, per_iteration) -> int:
    """Backward launches if every guided step of a pass runs its full budget;
    per_iteration(step): the launches of one guidance iteration at `step`."""
    return sum((budgets[i] if i < len(budgets) else budgets[-1]) * per_iteration(i)
               for i in range(min(max_index_step, steps)))


def _default_expect(cfg, steps, fuser_beta, ladders, expected_sam, passes=2,
                    guidance_keys=None):
    """Expected launch counts of a path of `passes` sampling passes on the
    default dispatch (options off), given the guidance iterations it ran;
    ladders: (iteration budgets, max_index_step) of each guided pass."""

    def expect(iters):
        fwd, bwd, full, early, fuser_steps = _expected_launches(cfg, steps, fuser_beta, iters,
                                                                passes, guidance_keys)
        ladder_max = sum(
            _ladder_max(budgets, max_index, steps,
                        lambda i: early * (2 if i < fuser_steps else 1))
            for budgets, max_index in ladders)
        return ({"flash_attention_fwd": fwd, "flash_attention_bwd": bwd,
                 "flash_attention_fwd_packed": 0, "flash_attention_fwd_fusedheads": 0,
                 "pair_stats": 0, "sam_attention": expected_sam}, ladder_max,
                f"full UNet {full} flash layers per forward, early-exit {early}")

    return expect


def _unet_layout(cfg):
    """The UNet's transformer blocks in forward order, each (key, tokens,
    width), the GroupNorm count before and including each one's block, and
    the index just past the guidance forward's last block."""
    from lmdx_torch.sampling.guidance import default_guidance_keys

    ucfg = cfg.unet
    res, ch = cfg.latent_height, ucfg.block_out_channels
    levels = len(ch)
    blocks, norms_after, norms = [], {}, 0
    for i, kind in enumerate(ucfg.down_block_types):
        for j in range(ucfg.layers_per_block):
            norms += 2
            if kind == "CrossAttnDownBlock2D":
                blocks.append((("down", i, j, 0), (res >> i) ** 2, ch[i]))
                norms += 1
        norms_after[("down", i)] = norms
    norms += 2 * 2 + 1
    blocks.append((("mid", 0, 0, 0), (res >> (levels - 1)) ** 2, ch[-1]))
    norms_after[("mid", 0)] = norms
    for i, kind in enumerate(ucfg.up_block_types):
        level = levels - 1 - i
        for j in range(ucfg.layers_per_block + 1):
            norms += 2
            if kind == "CrossAttnUpBlock2D":
                blocks.append((("up", i, j, 0), (res >> level) ** 2, ch[level]))
                norms += 1
        norms_after[("up", i)] = norms
    last_up = max(k[1] for k in default_guidance_keys(ucfg) if k[0] == "up")
    return blocks, norms + 1, norms_after[("up", last_up)], last_up


def _optin_expect(cfg, steps, fuser_beta, ladder, per_box_taps):
    """Expected launch counts of the LMD+ path with every option on. The
    dispatch: an untapped attention runs the fused-heads kernel where
    `fusedheads_supported` holds, else the per-head gate and there the packed
    kernel; tapped cross-attentions stay plain math; every GroupNorm launches
    `pair_stats` once forward and once backward. The backward kernel runs once
    for every kernel forward inside a guidance iteration."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.sampling.guidance import default_guidance_keys

    ucfg = cfg.unet
    blocks, norms_full, norms_early, last_up = _unet_layout(cfg)
    early_blocks = [b for b in blocks if not (b[0][0] == "up" and b[0][1] > last_up)]
    guidance_keys = set(default_guidance_keys(ucfg))
    ctx_len, heads = cfg.clip.max_length, ucfg.num_attention_heads[0]

    def counts(layers, tapped, fuser):
        """(packed, fused-heads) launches of one forward over `layers`."""
        packed = fused = 0
        for key, n, width in layers:
            calls = [(n, n)] + ([(n, n + ucfg.gligen_max_objs)] if fuser else [])
            if key not in tapped:
                calls.append((n, ctx_len))
            for lq, lk in calls:
                qf = torch.empty((1, lq, width), dtype=torch.bfloat16, device="meta")
                kf = torch.empty((1, lk, width), dtype=torch.bfloat16, device="meta")
                if fa.fusedheads_supported(qf, kf, heads):
                    fused += 1
                elif lk >= 256:
                    packed += 1
                else:
                    fail(f"optin: attention {key} {lq}x{lk} would fall to plain math")
        return packed, fused

    fuser_steps = int(fuser_beta * steps)

    def expect(iters):
        packed = fused = bwd = 0
        for tapped in (set(per_box_taps), set()):       # per-box pass, overall pass
            for fuser, n_steps in ((True, fuser_steps), (False, steps - fuser_steps)):
                p, f = counts(blocks, tapped, fuser)
                packed += n_steps * p
                fused += n_steps * f
        n_iters = 0
        for step, n in iters:
            p, f = counts(early_blocks, guidance_keys, step < fuser_steps)
            packed += n * p
            fused += n * f
            bwd += n * (p + f)
            n_iters += n
        budgets, max_index = ladder
        ladder_max = _ladder_max(
            budgets, max_index, steps,
            lambda i: sum(counts(early_blocks, guidance_keys, i < fuser_steps)))
        stats = 2 * steps * norms_full + n_iters * 2 * norms_early
        return ({"flash_attention_fwd": 0, "flash_attention_bwd": bwd,
                 "flash_attention_fwd_packed": packed,
                 "flash_attention_fwd_fusedheads": fused, "pair_stats": stats,
                 "sam_attention": 0}, ladder_max,
                f"{norms_full} GroupNorms per full forward, {norms_early} per guidance "
                f"forward and as many in its backward, {n_iters} guidance iterations")

    return expect


def _drive(label, run, cfg, steps, expect, profile=None, segmenter=None, n_passes=2,
           solver="DDIM"):
    """Drives one main path through its entry point and checks it.

    `run()` is called once with every launch count set to 0 just before it;
    the counts are read just after. Meanwhile each sampling pass's guidance
    iterations per step, the decoded latents' finiteness and the segmenter's
    wall time are recorded (and with `profile`, a torch.profiler breakdown
    is written there). Checks the images (uint8, cfg-sized, non-constant,
    from finite latents), that `n_passes` sampling passes ran, and that every
    kernel's launches equal what `expect(iterations)` says the dispatch, the
    schedule and the recorded iterations imply (the backward also within the
    ladders' maximum). Returns the results and the launch counts."""
    import numpy as np
    import torch

    from lmdx_torch.methods import _grounded, backward_guidance, base, boxdiff, gligen, sd
    from lmdx_torch.methods import batch as batch_lib
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.sampling import boxdiff as boxdiff_lib
    from lmdx_torch.sampling import guidance as guidance_lib

    passes, decoded, seg_walls = [], [], []
    # Every method module that runs the sampler, each with its own binding.
    samplers = (batch_lib, _grounded, sd, gligen, backward_guidance, boxdiff)
    orig_sample = batch_lib.sample
    orig_update = guidance_lib.guidance_update_batched
    orig_loss = guidance_lib.ca_loss_batched
    orig_boxdiff = boxdiff_lib.boxdiff_update
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

    def boxdiff_update(*a, **kw):  # one gradient step: one iteration
        passes[-1].append(1)
        return orig_boxdiff(*a, **kw)

    def decode(bundle_, latents):
        decoded.append(bool(torch.isfinite(latents).all().item()))
        return orig_decode(bundle_, latents)

    def segment_batch(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_segment(*a, **kw)  # host numpy: synchronous
        seg_walls.append(time.perf_counter() - t)
        return out

    for module in samplers:
        module.sample = sample
    guidance_lib.guidance_update_batched = update
    guidance_lib.ca_loss_batched = loss
    boxdiff_lib.boxdiff_update = boxdiff_update
    base.decode_latents = decode
    if segmenter is not None:
        segmenter.segment_batch = segment_batch
    try:
        fa.reset_launch_counts()
        sa.reset_launch_counts()
        gn.reset_launch_counts()
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
        launches = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
        if prof is not None:
            prof.__exit__(None, None, None)
            _profile_summary(prof, wall, profile)
    finally:
        for module in samplers:
            module.sample = orig_sample
        guidance_lib.guidance_update_batched = orig_update
        guidance_lib.ca_loss_batched = orig_loss
        boxdiff_lib.boxdiff_update = orig_boxdiff
        base.decode_latents = orig_decode
        if segmenter is not None:
            # Dropping the instance attribute, not assigning the bound method
            # back, leaves no reference cycle that would keep SAM on the card.
            del segmenter.segment_batch

    for r in results:
        img = r.image
        if img.dtype != np.uint8 or img.shape != (cfg.height, cfg.width, 3):
            fail(f"{label}: image {img.dtype} {img.shape}")
        if img.std() == 0:
            fail(f"{label}: constant image")
    if not decoded or not all(decoded):
        fail(f"{label}: non-finite latents reached the VAE: {decoded}")

    if len(passes) != n_passes:
        fail(f"{label}: {len(passes)} sampling passes, expected {n_passes}")
    iters = [(i, n) for pass_iters in passes for i, n in enumerate(pass_iters)]
    expected, ladder_max, note = expect(iters)
    log(f"{label}: guidance iterations per step of each pass {passes}")
    log(f"{label}: launches {launches}; expected {expected} ({note}; backward ladder "
        f"max {ladder_max})")
    for name, want in expected.items():
        if launches[name] != want:
            fail(f"{label}: {name} launches {launches[name]} != {want}")
    bwd = launches["flash_attention_bwd"]
    if not (0 < bwd <= ladder_max or bwd == ladder_max == 0):
        fail(f"{label}: backward launches {bwd} outside (0, ladder max {ladder_max}]")
    seg = f", SAM segment wall {sum(seg_walls):.3f} s" if segmenter is not None else ""
    log(f"{label}: {len(results)} images, {cfg.height}x{cfg.width}, {steps} "
        f"{solver} steps: wall {wall:.2f} s, {len(results) / wall:.4f} images/s{seg}, peak "
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
        bundle.config, steps,
        _default_expect(bundle.config, steps, 0.4,
                        [(p.overall_max_iter, p.overall_max_index_step)], 0),
        profile=profile)
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
        cfg, steps,
        _default_expect(cfg, steps, 0.0, [(p.max_iter, p.max_index_step),
                                          (p.overall_max_iter, p.overall_max_index_step)],
                        expected_sam),
        profile=profile, segmenter=segmenter)
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


def _optin_unet_check(on, off):
    """One UNet forward and one gradient of the guidance taps w.r.t. the
    latents, options on against options off, on the same weights and inputs
    (batch 2, GLIGEN on). Also holds every shape the opt-in wrappers are given
    against the tables phase 2 checked."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.unet import apply_unet
    from lmdx_torch.sampling.guidance import GuidanceSpec, default_guidance_keys

    cfg = on.config
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    lat = randn(2, cfg.latent_height, cfg.latent_width, 4)
    ctx = randn(2, cfg.clip.max_length, cfg.unet.cross_attention_dim)
    objs = randn(2, cfg.unet.gligen_max_objs, cfg.unet.cross_attention_dim)
    spec = GuidanceSpec(keys=default_guidance_keys(cfg.unet)).tap_spec

    seen = {"packed": set(), "fused": set(), "bwd": set(), "stats": set()}
    originals = (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
                 fa.flash_attention_bwd, gn.pair_stats)

    def packed(q, k, v):
        seen["packed"].add((q.shape[2], k.shape[2] - q.shape[2]))
        return originals[0](q, k, v)

    def fused(qf, kf, vf, heads):
        seen["fused"].add((qf.shape[1], kf.shape[1], qf.shape[2]))
        return originals[1](qf, kf, vf, heads)

    def bwd(q, k, v, *rest):
        seen["bwd"].add((q.shape[2], k.shape[2], q.shape[3]))
        return originals[2](q, k, v, *rest)

    def stats(a, b):
        seen["stats"].add((a.shape[1], a.shape[2], a.dtype, a is b))
        return originals[3](a, b)

    def run(bundle):
        with torch.no_grad():
            eps = apply_unet(bundle.unet, lat, 501, ctx, objs=objs)[0]
        x = lat.clone().requires_grad_(True)
        taps = apply_unet(bundle.unet, x, 501, ctx, objs=objs, taps=spec,
                          stop_after_taps=True)[1]
        loss = sum(t.float().square().sum() for t in taps.values())
        return eps, torch.autograd.grad(loss, x)[0]

    (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
     fa.flash_attention_bwd, gn.pair_stats) = packed, fused, bwd, stats
    try:
        eps_on, grad_on = run(on)
    finally:
        (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
         fa.flash_attention_bwd, gn.pair_stats) = originals
    eps_off, grad_off = run(off)
    torch.cuda.synchronize()
    for what, a, b in (("eps", eps_on, eps_off), ("latent gradient", grad_on, grad_off)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"optin: non-finite {what}")
        diff, ok = _err(a, b, TOL_OPTIN)
        ref = b.abs().max().item()
        log(f"optin: UNet {what} options on vs off: max|diff| {diff:.3e} = "
            f"{diff / ref:.3e} of max|off| {ref:.3e} (limit {TOL_OPTIN:g})")
        if not ok:
            fail(f"optin: UNet {what} differs by {diff / ref:.3e} of max|off|")

    f32, bf16 = torch.float32, torch.bfloat16
    checked = {
        "packed": set(PACKED_CASES), "fused": set(FUSED_CASES),
        "bwd": set(BWD_SHORT_KV) | {(L, L + e, d) for L, d in FLASH_LEVELS
                                    for b, e in BWD_CASES if b == 2},
        "stats": ({(c, n, bf16, True) for c, n in STAT_CASES}
                  | {(c, n, f32, False) for c, n in STAT_BWD_CASES})}
    for name, shapes in seen.items():
        if not shapes or not shapes <= checked[name]:
            fail(f"optin: {name} was given shapes phase 2 did not check: "
                 f"{sorted(shapes - checked[name], key=str)} (seen {len(shapes)})")
    log(f"optin: every shape the opt-in wrappers were given was checked in phase 2 "
        f"({ {k: len(v) for k, v in seen.items()} })")


def phase_optin(steps: int, profile: str | None = None):
    import torch

    from lmdx_torch.config import ALL_KERNELS
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.methods.batch import run_lmd_plus_batch
    from lmdx_torch.runtime import models
    from lmdx_torch.sampling.guidance import default_guidance_keys, default_obj_attn_key

    key = "gligen/diffusers-generation-text-box"
    t0 = time.perf_counter()
    bundle = models.load_bundle(key, seed=0, device="cuda", kernels=ALL_KERNELS)
    off = models.load_bundle(key, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"optin: bundles with every option on and off (random weights, seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")
    _optin_unet_check(bundle, off)
    del off
    torch.cuda.empty_cache()

    cfg = bundle.config
    p = GroundedParams(num_inference_steps=steps)
    per_box_taps = (default_obj_attn_key(cfg.unet), *default_guidance_keys(cfg.unet))
    results, launches = _drive(
        "optin",
        lambda: run_lmd_plus_batch(SPECS, bundle, bg_seeds=[1, 2],
                                   num_inference_steps=steps),
        cfg, steps,
        _optin_expect(cfg, steps, 0.4, (p.overall_max_iter, p.overall_max_index_step),
                      per_box_taps),
        profile=profile)
    for r in results:
        if r.aux["frozen_mask"].sum() <= 0:
            fail("optin: empty frozen mask")
    del bundle
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def _recording_shapes():
    """Records the shape of every call to the flash forward and backward and
    to SAM attention while active (the wrappers still launch and count);
    yields the sets of shapes by wrapper."""
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa

    seen = {"fwd": set(), "bwd": set(), "sam": set()}
    originals = fwd, bwd, sam = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                                 sa.sam_attention)

    def rec_fwd(q, k, v):
        seen["fwd"].add((*q.shape[:3], k.shape[2], q.shape[3]))
        return fwd(q, k, v)

    def rec_bwd(q, k, v, *rest):
        seen["bwd"].add((*q.shape[:3], k.shape[2], q.shape[3]))
        return bwd(q, k, v, *rest)

    def rec_sam(q, *rest):
        seen["sam"].add((q.shape[0] * q.shape[1], q.shape[2]))
        return sam(q, *rest)

    fa.flash_attention_fwd, fa.flash_attention_bwd, sa.sam_attention = rec_fwd, rec_bwd, rec_sam
    try:
        yield seen
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd, sa.sam_attention = originals


def _phase2_shapes():
    """Every shape phase 2 holds the flash forward, the default paths'
    backward and SAM attention to, as `_recording_shapes` records them."""
    heads = 8
    return {"fwd": {(b, heads, L, L + e, d) for L, d in FLASH_LEVELS for b, e in FWD_CASES},
            "bwd": {(b, heads, L, L + e, d) for L, d in FLASH_LEVELS for b, e in BWD_CASES},
            "sam": {(bh, g * g) for bh, g in SAM_CASES}}


SINGLE_BUNDLES = (
    ("gligen/diffusers-generation-text-box", ("lmd_plus", "gligen")),
    ("runwayml/stable-diffusion-v1-5", ("lmd", "sd", "backward_guidance")),
)
# backward_guidance's published ladder: 5 iterations a step over 10 steps.
BG_LADDER = ([5], 10)


def _run_single(label, name, spec, bundle, segmenter, steps):
    """`get_method(name).run(spec, bundle)` through `_drive`, with the launches
    its dispatch, schedule and recorded guidance iterations imply; for `lmd`
    and `lmd_plus` also a non-empty frozen mask, and for `lmd` a SAM mask
    per box, not all of them empty (phase 4's check)."""
    from lmdx_torch import methods
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.nn.sam import SamSegmenter

    cfg = bundle.config
    p = GroundedParams(num_inference_steps=steps)
    kw = {"num_inference_steps": steps}
    if name == "lmd":
        kw["segmenter"] = segmenter
    sam = (segmenter.config.encoder_layers * -(-len(spec["gen_boxes"]) // SamSegmenter.CHUNK)
           if name == "lmd" else 0)
    ladders, passes, beta = {
        "lmd_plus": ([(p.overall_max_iter, p.overall_max_index_step)], 2, 0.4),
        "lmd": ([(p.max_iter, p.max_index_step),
                 (p.overall_max_iter, p.overall_max_index_step)], 2, 0.0),
        "gligen": ([], 1, 0.4),
        "sd": ([], 1, 0.0),
        "backward_guidance": ([BG_LADDER], 1, 0.0)}[name]
    method = methods.get_method(name)
    results, launches = _drive(
        label, lambda: [method.run(spec, bundle, **kw)], cfg, steps,
        _default_expect(cfg, steps, beta, ladders, sam, passes),
        segmenter=segmenter if name == "lmd" else None, n_passes=passes)
    if name in ("lmd", "lmd_plus") and results[0].aux["frozen_mask"].sum() <= 0:
        fail(f"{label}: empty frozen mask")
    if name == "lmd":
        areas = [int(m.sum()) for m in results[0].aux["masks"]]
        log(f"{label}: per-box mask areas (of {cfg.latent_height * cfg.latent_width}) {areas}")
        if len(areas) != len(spec["gen_boxes"]) or not any(areas):
            fail(f"{label}: per-box masks {areas}: missing or all empty")
    return results, launches


def phase_single(steps: int):
    """The single-image methods through the registry on SPECS[0]."""
    import torch

    from lmdx_torch.nn.sam import SamSegmenter
    from lmdx_torch.runtime import models

    t_phase = time.perf_counter()
    spec = SPECS[0]
    all_launches = {}
    with _recording_shapes() as seen:
        for key, names in SINGLE_BUNDLES:
            t0 = time.perf_counter()
            bundle = models.load_bundle(key, seed=0, device="cuda")
            segmenter = (SamSegmenter(models.build_sam(seed=0, device="cuda"))
                         if "lmd" in names else None)
            torch.cuda.synchronize()
            log(f"single: {key} bundle{' and SAM ViT-B' if segmenter else ''} (random "
                f"weights, seed 0) built in {time.perf_counter() - t0:.1f} s")
            for name in names:
                _, all_launches[name] = _run_single(f"single {name}", name, spec, bundle,
                                                    segmenter, steps)
            del bundle, segmenter
            torch.cuda.empty_cache()
    _require_checked_shapes("single", seen)
    log(f"single: phase 6 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


def _require_checked_shapes(label, seen):
    """Fails unless each wrapper was given shapes, all of them ones phase 2
    checked."""
    checked = _phase2_shapes()
    for what, shapes in seen.items():
        if not shapes or not shapes <= checked[what]:
            fail(f"{label}: the {what} wrapper was given shapes phase 2 did not check: "
                 f"{sorted(shapes - checked[what])} (seen {sorted(shapes)})")
    log(f"{label}: every shape the flash and SAM wrappers were given was checked in phase 2 "
        f"({ {k: sorted(v) for k, v in seen.items()} })")


def _sum_launches(by_run: dict) -> dict:
    return {k: sum(launches[k] for launches in by_run.values())
            for k in next(iter(by_run.values()))}


BASELINE_BUNDLE = "runwayml/stable-diffusion-v1-5"
BOXDIFF_LADDER = ([1], 25)   # one gradient step a step over the first 25


def phase_baselines(steps: int):
    """Phase 7: BoxDiff, MultiDiffusion, DPM-Solver++(2M) and DDIM inversion
    on one SD1.5 bundle, SPECS[0]."""
    import torch

    from lmdx_torch import methods
    from lmdx_torch.core import schedule as sched
    from lmdx_torch.methods import base
    from lmdx_torch.runtime import models
    from lmdx_torch.sampling import boxdiff as boxdiff_lib
    from lmdx_torch.sampling.loop import invert
    from lmdx_torch.text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT

    t_phase = time.perf_counter()
    spec = SPECS[0]
    t0 = time.perf_counter()
    bundle = models.load_bundle(BASELINE_BUNDLE, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"baselines: {BASELINE_BUNDLE} bundle (random weights, seed 0) built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = bundle.config
    boxdiff_keys = boxdiff_lib.default_boxdiff_keys(cfg.unet)
    # (label, method, keyword arguments, guidance ladders, sampling passes,
    # solver); MultiDiffusion runs its own loop (no `sample` pass) of one
    # batch-6 forward a step: one pass's worth of forwards.
    runs = [
        ("boxdiff", "boxdiff", {}, [BOXDIFF_LADDER], 1, "DDIM"),
        ("multidiffusion", "multidiffusion", {}, [], 0, "DDIM"),
        ("sd (dpmpp_2m)", "sd", {"scheduler": "dpmpp_2m"}, [], 1, "DPM-Solver++(2M)"),
        ("backward_guidance (dpmpp_2m)", "backward_guidance", {"scheduler": "dpmpp_2m"},
         [BG_LADDER], 1, "DPM-Solver++(2M)"),
    ]
    all_launches, kept = {}, {}
    orig_decode = base.decode_latents

    with _recording_shapes() as seen:
        for label, name, kw, ladders, n_passes, solver in runs:
            method = methods.get_method(name)

            def keep_latents(bundle_, latents, label=label):
                kept[label] = latents.detach().clone()
                return orig_decode(bundle_, latents)

            base.decode_latents = keep_latents
            try:
                _, launches = _drive(
                    f"baselines {label}",
                    lambda: [method.run(spec, bundle, num_inference_steps=steps, **kw)],
                    cfg, steps,
                    _default_expect(cfg, steps, 0.0, ladders, 0, max(n_passes, 1),
                                    boxdiff_keys if name == "boxdiff" else None),
                    n_passes=n_passes, solver=solver)
            finally:
                base.decode_latents = orig_decode
            all_launches[label] = launches

        # One DDIM inversion of the DPM `sd` run's final latents at CFG 7.5,
        # decoded for the image checks: 49 CFG forwards at batch 2.
        x0 = kept["sd (dpmpp_2m)"]
        schedule = sched.make_schedule(steps)
        uncond, cond = models.encode_prompts(bundle, [spec["prompt"]],
                                             DEFAULT_OVERALL_NEGATIVE_PROMPT)
        trajectory = []

        def run_invert():
            final, traj = invert(bundle.unet, schedule, x0, torch.cat([uncond, cond], dim=0),
                                 guidance_scale=7.5)
            trajectory.append(traj)
            return [base.GenerationResult(image=base.decode_latents(bundle, final)[0])]

        _, launches = _drive(
            "baselines invert", run_invert, cfg, steps - 1,
            _default_expect(cfg, steps - 1, 0.0, [], 0, 1), n_passes=0, solver="DDIM inversion")
        traj = trajectory[0]
        if traj.shape != (steps, *x0.shape) or not torch.isfinite(traj).all():
            fail(f"baselines invert: trajectory {tuple(traj.shape)}, finite "
                 f"{bool(torch.isfinite(traj).all())}")
        if not torch.equal(traj[0], x0.float()):
            fail("baselines invert: the trajectory does not start at the input latents")
        log(f"baselines invert: trajectory {tuple(traj.shape)}, std {x0.std().item():.4f} -> "
            f"{traj[-1].std().item():.4f}")
        all_launches["invert"] = launches
    del bundle, kept, trajectory, x0
    torch.cuda.empty_cache()

    checked = _phase2_shapes()
    for what in ("fwd", "bwd"):
        if not seen[what] <= checked[what]:
            fail(f"baselines: the {what} wrapper was given shapes phase 2 did not check: "
                 f"{sorted(seen[what] - checked[what])} (seen {sorted(seen[what])})")
    if not seen["fwd"] or seen["sam"]:
        fail(f"baselines: flash forward shapes {sorted(seen['fwd'])}, SAM {sorted(seen['sam'])}")
    log(f"baselines: every shape the flash wrappers were given was checked in phase 2 "
        f"({ {k: sorted(v) for k, v in seen.items()} }); phase 7 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


CKPT_MODELS = (("gligen/diffusers-generation-text-box", "lmd_plus"),
               ("runwayml/stable-diffusion-v1-5", "lmd"))
# The caption of the template's fourth in-context example (2 boxes); its
# response is the stage-1 layout phase 8 renders.
STAGE1_CAPTION = "A watercolor of a sleepy cat and a playful puppy without people"


def _stage_one_spec(root: str) -> dict:
    """One stage-1 layout through the port's host side: the template's
    in-context response for STAGE1_CAPTION, parsed and filtered, written to
    a LayoutCache file under `root`, read back by a second cache, parsed and
    filtered again into the spec a method runs, as the JAX CLI builds it."""
    from lmdx_torch.text import parser, template
    from lmdx_torch.text.cache import LayoutCache, cache_filename

    block = template.TEMPLATE_V0_1.split(f"Caption: {STAGE1_CAPTION}\n", 1)[1]
    response = block.split("\n\n", 1)[0]
    layout = parser.parse_layout_response(response)
    if len(parser.filter_boxes(layout.gen_boxes)) != 2:
        fail(f"stage 1: the template's response gave {layout.gen_boxes}")
    path = cache_filename("demo", "v0.1", "gpt-4", os.path.join(root, "cache"))
    LayoutCache(path).add(STAGE1_CAPTION, response)
    cached = LayoutCache(path, allow_nonexist=False).get(STAGE1_CAPTION)
    if cached != response:
        fail(f"stage 1: the layout cache gave back {cached!r}")
    layout = parser.parse_layout_response(cached)
    spec = {"prompt": STAGE1_CAPTION, "gen_boxes": parser.filter_boxes(layout.gen_boxes),
            "bg_prompt": layout.bg_prompt, "extra_neg_prompt": layout.neg_prompt}
    log(f"checkpoint: stage 1 through the parser and {os.path.basename(path)}: {spec}")
    return spec


def _check_loaded(label, modules: dict, state_dicts: dict, f32_markers) -> int:
    """Every parameter of `modules` equals the file's tensor cast to the
    parameter's dtype, bit for bit, compared on the card; norm (and SAM's
    f32) parameters are f32, the rest bf16. Returns the values compared."""
    import torch

    n = 0
    for part, module in modules.items():
        params = dict(module.named_parameters())
        if sorted(params) != sorted(state_dicts[part]):
            fail(f"{label}: {part} parameters and the file's tensors differ in name")
        for name, p in params.items():
            want_dtype = (torch.float32 if any(m in name for m in f32_markers)
                          else torch.bfloat16)
            if p.dtype != want_dtype or p.device.type != "cuda":
                fail(f"{label}: {part}.{name} is {p.dtype} on {p.device}")
            if not torch.equal(p, state_dicts[part][name].to(p.device).to(p.dtype)):
                fail(f"{label}: {part}.{name} differs from the file's tensor")
            n += p.numel()
    return n


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def phase_checkpoint(steps: int):
    """Phase 8: fabricated checkpoints at production shapes, loaded from disk
    by the port's loader, rendered from a layout that went through stage 1."""
    import tempfile

    import torch

    from lmdx_torch.runtime import convert, fabricate, models

    t_phase = time.perf_counter()
    saved = os.environ.pop("LMDX_ALLOW_WORD_TOKENIZER", None)
    all_launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="lmdx_checkpoints_") as root:
            t0 = time.perf_counter()
            params = {key: fabricate.fabricate_model(key, root, torch.float16)
                      for key, _ in CKPT_MODELS}
            params["sam"] = fabricate.fabricate_sam(root, torch.float16)
            dirs = {key: os.path.join(root, key.replace("/", "--")) for key, _ in CKPT_MODELS}
            dirs["sam"] = os.path.join(root, fabricate.SAM_KEY.replace("/", "--"))
            sizes = {k: _dir_bytes(d) for k, d in dirs.items()}
            log(f"checkpoint: fabricated {sum(params.values()) / 1e9:.3f}B params in fp16 "
                f"({sum(sizes.values()) / 1e9:.3f} GB: " + ", ".join(
                    f"{k} {params[k] / 1e9:.3f}B, {sizes[k] / 1e9:.3f} GB" for k in dirs)
                + f") in {time.perf_counter() - t0:.1f} s")

            for key, _ in CKPT_MODELS:
                report = convert.validate_checkpoint(key, dirs[key])
                if any(v for r in report.values() for v in r.values()):
                    fail(f"checkpoint: {key} does not match its manifests: {report}")
            log("checkpoint: validate_checkpoint clean for " + ", ".join(dirs))

            key = CKPT_MODELS[0][0]
            refusals = []
            for kw, needle in (({}, "WordTokenizer"), ({"dtype": "float32"},
                                                         "float32 instantiations")):
                try:
                    models.load_bundle(key, dirs[key], device="cuda", **kw)
                except ValueError as exc:
                    if needle not in str(exc):
                        fail(f"checkpoint: load_bundle{kw} refused with {exc}")
                    refusals.append(str(exc).split(";")[0][:90])
                else:
                    fail(f"checkpoint: load_bundle{kw} of a checkpoint without a tokenizer "
                         f"was not refused")
            log(f"checkpoint: refused as expected: {refusals}")
            os.environ["LMDX_ALLOW_WORD_TOKENIZER"] = "1"

            spec = _stage_one_spec(root)
            with _recording_shapes() as seen:
                for key, name in CKPT_MODELS:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    bundle = models.load_bundle(key, dirs[key], device="cuda")
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    log(f"checkpoint: {key} loaded from {sizes[key] / 1e9:.3f} GB in "
                        f"{wall:.2f} s ({sizes[key] / 1e9 / wall:.2f} GB/s of file), peak "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                    modules = {"unet": bundle.unet, "text": bundle.text_encoder,
                               "vae": bundle.vae}
                    if bundle.position_net is not None:
                        modules["position_net"] = bundle.position_net
                    n = _check_loaded(f"checkpoint {key}", modules,
                                      convert.load_checkpoint(bundle.config, dirs[key]),
                                      models.F32_PARAM_NAME_MARKERS)
                    segmenter = None
                    if name == "lmd":
                        t0 = time.perf_counter()
                        segmenter = models.load_segmenter(dirs["sam"], device="cuda")
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                        log(f"checkpoint: SAM ViT-B loaded from {sizes['sam'] / 1e9:.3f} GB "
                            f"in {wall:.2f} s ({sizes['sam'] / 1e9 / wall:.2f} GB/s)")
                        n += _check_loaded("checkpoint sam", {"sam": segmenter.model},
                                           {"sam": convert.load_sam_state_dict(dirs["sam"])},
                                           models.SAM_F32_MARKERS)
                    log(f"checkpoint: {n / 1e9:.3f}B loaded values equal the files' tensors "
                        f"bit for bit")
                    _, all_launches[name] = _run_single(f"checkpoint {name}", name, spec,
                                                        bundle, segmenter, steps)
                    del bundle, segmenter, modules
    finally:
        if saved is None:
            os.environ.pop("LMDX_ALLOW_WORD_TOKENIZER", None)
        else:
            os.environ["LMDX_ALLOW_WORD_TOKENIZER"] = saved
    torch.cuda.empty_cache()
    _require_checked_shapes("checkpoint", seen)
    log(f"checkpoint: phase 8 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the main path (depth only; width is full)")
    ap.add_argument("--lmd-steps", type=int, default=50,
                    help="DDIM steps of the LMD path (depth only; width is full)")
    ap.add_argument("--optin-steps", type=int, default=50,
                    help="DDIM steps of the opt-in LMD+ path (depth only; a rehearsal "
                         "flag: the check is the 50 steps of the default)")
    ap.add_argument("--single-steps", type=int, default=50,
                    help="DDIM steps of the single-image methods of phase 6 (depth only; a "
                         "rehearsal flag: the check is the 50 steps of the default)")
    ap.add_argument("--baseline-steps", type=int, default=50,
                    help="steps of phase 7's BoxDiff, MultiDiffusion, DPM-Solver++ and "
                         "inversion runs (depth only; a rehearsal flag: the check is the 50 "
                         "steps of the default)")
    ap.add_argument("--ckpt-steps", type=int, default=50,
                    help="DDIM steps of phase 8's LMD+ and LMD renders on the loaded "
                         "checkpoints (depth only; a rehearsal flag: the check is the 50 "
                         "steps of the default)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the three paths with torch.profiler and write the device "
                         "time by kernel to PATH and to PATH with _lmd and _optin before "
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
    # Phases 3-7 run on random weights; phase 8 names its checkpoints itself.
    if os.environ.pop("LMDX_CHECKPOINT_DIR", None) is not None:
        log("LMDX_CHECKPOINT_DIR unset: phases 3-7 run on random weights")
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
    kernels.update(phase_optin_kernels())
    plus = phase_main_path(args.steps, args.profile)
    lmd_profile = optin_profile = None
    if args.profile:
        root, ext = os.path.splitext(args.profile)
        lmd_profile, optin_profile = f"{root}_lmd{ext}", f"{root}_optin{ext}"
    lmd = phase_lmd(args.lmd_steps, lmd_profile)
    optin = phase_optin(args.optin_steps, optin_profile)
    single = phase_single(args.single_steps)
    baselines = phase_baselines(args.baseline_steps)
    checkpoint = phase_checkpoint(args.ckpt_steps)
    launches = {name: plus[name] + lmd[name] + optin[name] + single[name] + baselines[name]
                + checkpoint[name] for name in kernels}
    log(f"launches: LMD+ path {plus}, LMD path {lmd}, opt-in LMD+ path {optin}, "
        f"single-image methods {single}, baselines and solvers {baselines}, "
        f"checkpoint path {checkpoint}")

    sources = {"flash_attention_fwd": ("lmdx_torch/csrc/flash_fwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:107"),
               "flash_attention_bwd": ("lmdx_torch/csrc/flash_bwd.cu",
                                       "lmdx/nn/pallas/flash_attention.py:384"),
               "sam_attention": ("lmdx_torch/csrc/sam_attention.cu",
                                 "lmdx/nn/pallas/sam_attention.py:101"),
               "flash_attention_fwd_packed": ("lmdx_torch/csrc/flash_fwd_packed.cu",
                                              "lmdx/nn/pallas/flash_attention.py:211"),
               "flash_attention_fwd_fusedheads": (
                   "lmdx_torch/csrc/flash_fwd_fusedheads.cu",
                   "lmdx/nn/pallas/flash_attention.py:622"),
               "pair_stats": ("lmdx_torch/csrc/pair_stats.cu",
                              "lmdx/nn/pallas/group_norm.py:60")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
         "bound_ms": t["bound_ms"],
         "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
         "library_ms": t["library_ms"] if t["library_ok"] else None}
        for name, t in kernels.items()]}
    n_opt = len(OPTIN_BATCHES)
    log(f"kernel times: ms, plain_ms, bound_ms and library_ms are sums of one call "
        f"at each shape above ({3 * len(FWD_CASES)} for the flash forward, "
        f"{3 * len(BWD_CASES)} + {len(BWD_SHORT_KV)} for the backward, {len(SAM_CASES)} "
        f"for SAM, "
        f"{len(PACKED_CASES) * n_opt} for the packed forward, {len(FUSED_CASES) * n_opt} "
        f"for the fused-heads forward, {len(STAT_CASES) * n_opt} + {len(STAT_BWD_CASES)} "
        f"for pair_stats); launches are those of the LMD+, LMD and opt-in LMD+ paths, "
        f"the single-image methods, the baselines and solvers and the checkpoint path "
        f"together")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
