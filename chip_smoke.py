#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmdx_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--lmd-steps N] [--optin-steps N]
                          [--single-steps N] [--baseline-steps N] [--ckpt-steps N]
                          [--cli-f32-steps N] [--cli-steps N] [--optin-f32-steps N]
                          [--profile PATH]

Ten phases; any failure exits nonzero before the final line is printed.
Phases 3-7, 9 and 10 run on random weights (LMDX_CHECKPOINT_DIR is unset for
them); phase 8 loads checkpoints from disk, phase 9 a fabricated SAM, phase
10 a fabricated OWL-ViT.

1. Build: compiles every CUDA source of the port (`lmdx_torch/csrc/*.cu`,
   seven), one nvcc per source, all started together, into build/kernels/,
   and prints each kernel's registers and spilled bytes (`ptxas -v`). Fails
   if an attention kernel (the forward body's four kernels, the backward's
   two, and the float32 body's six) instantiated for a head dim the paths
   use (48, 64, 80, 160) spills.
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
   The float32 forms of kernels 1, 2 and 5 (`csrc/attention_f32.cu`) at
   every shape phase 9 gives them (F32_FWD_CASES, F32_BWD_CASES,
   F32_SAM_CASES), within 1e-4 * max|plain| for O and each gradient and
   1e-4 for the LSE (the plain versions in full float32: TF32 is off; the
   kernels' products in float32 FMA or 3xTF32), each line with its error as
   a share of max|plain|, bound by operations at 3xTF32's rate (495 / 3 = 165
   TFLOP/s, the rate at which the tensor cores give float32 accuracy; the
   line also gives the rate as a share of it and of the 67 TFLOP/s float32
   FMA peak), library = `F.scaled_dot_product_attention` at float32 (SAM
   with the dense bias as its mask) and the memory-efficient attention
   backward op (3xTF32 itself). Each backward line names the dK/dV walk its
   shape takes (wide, or split over warps where the wide grid has fewer than
   132 blocks).
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
   The float32 forms of kernels 3 and 4 (`csrc/attention_f32.cu`) at every
   shape and batch phase 10 gives them (F32_PACKED_LEVELS, F32_FUSED_CASES;
   batch 8/4/2): at float32 the fused-heads size rule refuses the 1024-token
   self and fuser attention, so the packed kernel serves (4096, 40) and
   (1024, 80), KV = L and L + 30, and must equal kernel 1-f32 bit for bit;
   the fused-heads kernel the rest. Kernel 2-f32 at the gradient shapes that
   path adds (F32_OPTIN_BWD, batch 2), `pair_stats` on float32 (x, x) at
   every GroupNorm of the UNet (batch 8/4/2; bound by bytes, operations at
   the FMA rate). Tolerances, bound and library as for the float32 kernels
   above (SDPA at float32 on strided views for the fused-heads forward).
   Then the tensor-core kernels' tiles no path shape reaches, checked and
   timed outside the totals (F32_TILE_FUSED, F32_TILE_BWD): kernel 4-f32's
   64-row q tile at head dim 160, kernel 2-f32's wide dK/dV walk at KV 77 and
   its split walk at batch 1.
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
   (and loads it with LMDX_ALLOW_WORD_TOKENIZER=1, set for this phase only),
   also at dtype float32 with every opt-in kernel (which passes the dtype
   gate: kernels 3 and 4 have float32 forms); takes the template's
   in-context response for STAGE1_CAPTION through the port's parser and a
   LayoutCache file into a spec; then loads each bundle (and, for LMD, SAM
   through `load_segmenter`) on the card, printing the load wall, GB/s of
   file and peak memory, checks every loaded parameter bit for bit against
   the file's tensor cast to its dtype, and renders `lmd_plus` on the
   SD1.4+GLIGEN bundle and `lmd` with SAM on the SD1.5 bundle at 512x512,
   `--ckpt-steps` DDIM steps, with phase 6's checks (images, masks, launches,
   every wrapper shape one phase 2 checked). Each bundle is freed before the
   next.
9. The stage-2 CLI (`lmdx_torch.cli.generate.main(argv)`, in this process)
   on a LayoutCache file of the three demo prompts (hand-written responses
   in the template's format: 3, 1 and 2 boxes). (a) `--run-model lmd
   --use_autocast 0` on SD1.5 (random weights, float32, 512x512,
   `--cli-f32-steps` DDIM steps, default 50) on the first two prompts, with
   `--sam-checkpoint` a SAM ViT-B fabricated in fp16 and loaded in bf16, as
   the JAX CLI loads it: `_drive`'s checks with every UNet attention on the
   float32 kernels (the bf16 flash kernels launch 0 times), the SAM launches
   counted, TF32 off, and each img_0.png equal to the method's image; wall,
   images/s and peak memory. (b) One float32 SamSegmenter on the same SAM
   weights, box-prompted, on one of (a)'s images: 12 launches of kernel 5's
   float32 form. (c) `--run-model lmd_plus --image-batch-size 2` on the three
   prompts, bf16, pipelined (the images of a batch are copied after the next
   batch is launched), `--cli-steps` DDIM steps (default 20; phase 3 runs
   this work at 50): three image directories, the `[batched] 3/3 done` line,
   and a rerun that schedules `[batched] 0 jobs`. Every wrapper shape must
   be one phase 2 checked.
10. Float32 LMD+ with every opt-in kernel, and the stage-2 eval of its
   images. (a) The SD1.4+GLIGEN bundle at float32 with `ALL_KERNELS`
   (random weights, seed 0): one UNet forward and one guidance gradient
   against the float32 bundle with the options off (batch 2, GLIGEN on,
   within 1e-3 * max|off|), then `run_lmd_plus_batch` at 512x512, CFG 7.5,
   frozen ratio 0.5, GLIGEN beta 0.4, guidance, CoarseSegmenter,
   `--optin-f32-steps` DDIM steps (default 50), on hand-written 2-box
   layouts of the first two attribution prompts; phase 3's checks, the
   launches of kernels 3-f32, 4-f32, 2-f32 and `pair_stats` as the float32
   dispatch implies, 0 of every bf16 flash kernel, every wrapper shape one
   phase 2 checked; the images go to `<run>/<i>/img_0.png`. (b) OWL-ViT
   base-patch32 fabricated in fp16, validated, loaded in float32 on the card
   and held bit for bit against its file; `lmdx_torch.cli.owl_vit_eval.main`
   over `<run>` (attribution prompts, 2 images) at --eval-batch-size 2 and 1:
   equal reports of 2 attribution images.

Matmuls and convolutions run in bf16 (phase 9 (a) and phase 10: float32); TF32 is turned
off for both (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so the plain versions' f32 products are full
f32.
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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 outside the tensor cores
PEAK_TF32X3_FLOPS = 495e12 / 3  # float32 products as 3xTF32 on the dense TF32 tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
TOL_REL = 2e-2
TOL_LSE = 1e-3
TOL_F32 = 1e-4            # float32 kernels: O and each gradient, share of max|plain|
TOL_LSE_F32 = 1e-4        # float32 kernels: the LSE, absolute
TOL_SUMS = 1e-3           # pair_stats: f32 sums in another order
TOL_OPTIN = 5e-2          # options-on UNet against options-off, share of max|off|
TOL_OPTIN_F32 = 1e-3      # the same at float32

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
                     "flash_fwd_fusedheads", "attention_f32")


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


def _inputs(b, h, lq, lk, d, seed, dtype=None):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def mk(L):
        return torch.randn((b, h, L, d), generator=g, device="cuda").to(dtype or torch.bfloat16)

    return mk(lq), mk(lk), mk(lk), mk(lq)


def _err(got, want, rel=TOL_REL):
    err = (got.float() - want.float()).abs().max().item()
    ok = err <= rel * max(want.float().abs().max().item(), 1e-6)
    return err, ok


def _share(got, want) -> float:
    """max|got - want| as a share of max|want|: the margin under a gate."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


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
# guidance, fuser KV in LMD+). Phase 9's batched LMD+ adds batch 6 with the
# fuser (a group of 3 boxes: 3 x CFG).
FWD_CASES = [(b, extra) for b in (8, 4, 2, 1) for extra in (0, 30)] + [(6, 0), (6, 30)]
BWD_CASES = [(2, 0), (2, 30), (4, 0), (1, 0), (1, 30)]
FLASH_LEVELS = ((4096, 40), (1024, 80), (256, 160))   # (tokens, head_dim) at 8 heads
# (B * heads, grid side) of SAM ViT-B's attention on a chunk of 4 images
# (the batched LMD path), of 2 (one 2-box layout), of 3 and of 1 (phase 9's
# demo layouts of 3 boxes and 1): global and windowed.
SAM_CASES = [(4 * 12, 64), (4 * 25 * 12, 14), (2 * 12, 64), (2 * 25 * 12, 14),
             (3 * 12, 64), (3 * 25 * 12, 14), (12, 64), (25 * 12, 14)]
# The float32 kernels at every (batch, Lk - L) phase 9 gives them: its
# single-image LMD on a 3-box and a 1-box layout (per-box passes at batch 6
# and 2, per-box guidance at 3 and 1, overall pass at 2, overall guidance at
# 1; SD1.5 has no fuser), and the fuser's L + 30 at the batches a float32
# LMD+ of those layouts would give (guidance at 1). SAM: one float32 image.
F32_FWD_CASES = [(b, extra) for b in (6, 3, 2, 1) for extra in (0, 30)]
F32_BWD_CASES = [(3, 0), (1, 0), (1, 30)]
F32_SAM_CASES = [(12, 64), (25 * 12, 14)]


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


def _fmt(ms, plain, lib, bound, flops, f32=False):
    """One shape's times; at float32 the rate also as shares of the 3xTF32
    rate (the bound's) and of the float32 FMA peak."""
    rate = flops / ms / 1e9
    shares = (f" = {rate * 1e12 / PEAK_TF32X3_FLOPS:.1%} of 3xTF32, "
              f"{rate * 1e12 / PEAK_F32_FLOPS:.1%} of FMA" if f32 else "")
    return (f"{ms:.3f} ms (plain {plain:.3f}, library "
            f"{lib if lib is None else round(lib, 3)}, bound {bound:.4f}, "
            f"{rate:.1f} TFLOP/s{shares})")


def _check_bwd(bwd, b, heads, L, lk, d, reps, dtype=None):
    """Holds the flash backward against its plain version at one shape and
    times it, its plain version and SDPA's backward op (bf16: the flash
    attention op's; float32: the memory-efficient attention op's, the SDPA
    backend that takes float32)."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    f32 = dtype == torch.float32
    if f32:
        sdpa = torch.ops.aten._scaled_dot_product_efficient_attention
        sdpa_bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    else:
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention
        sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    scale = d ** -0.5
    q, k, v, do = _inputs(b, heads, L, lk, d, seed=L + lk + b + 1, dtype=dtype)
    o, lse = fa.flash_attention_fwd(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, lse, o, do)
    want = fa.attention_bwd_plain(q, k, v, lse, o, do)
    torch.cuda.synchronize()
    errs = [_err(g_, w_, TOL_F32 if f32 else TOL_REL) for g_, w_ in zip(got, want)]
    shares = [_share(g_, w_) for g_, w_ in zip(got, want)]
    if not all(ok for _, ok in errs):
        fail(f"backward{' f32' if f32 else ''} disagrees at B={b} L={L} Lk={lk} d={d}: "
             f"{[e for e, _ in errs]}")
    bh = b * heads
    size = 4 if f32 else 2
    flops = 10 * bh * L * lk * d
    nbytes = (size * bh * d * (3 * L + 2 * lk) + 4 * bh * L
              + size * bh * d * (L + 2 * lk))
    bound = _bound(bwd, flops, nbytes, PEAK_TF32X3_FLOPS if f32 else PEAK_BF16_FLOPS)
    ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, lse, o, do), reps)
    plain = cuda_ms(lambda: fa.attention_bwd_plain(q, k, v, lse, o, do), reps)
    lib = None
    try:
        if f32:
            outs = sdpa(q, k, v, None, True, scale=scale)
        else:
            outs = sdpa(q, k, v, 0.0, False, False, scale=scale)
    except (RuntimeError, TypeError) as exc:  # a yardstick only
        bwd["library_ok"] = False
        log(f"  library backward unavailable: {type(exc).__name__}: {exc}")
    else:
        if f32:
            lo, llse, seed_, off_ = outs[:4]
            lib = _library_ms(bwd, "backward", lambda: sdpa_bwd(
                do, q, k, v, None, lo, llse, seed_, off_, 0.0, [True, True, True, False],
                False, scale=scale), reps)
        else:
            lo, llse, cq, ck, mq, mk_, seed_, off_ = outs[:8]
            lib = _library_ms(bwd, "backward", lambda: sdpa_bwd(
                do, q, k, v, lo, llse, cq, ck, mq, mk_, 0.0, False, seed_, off_,
                scale=scale), reps)
    _add(bwd, ms, plain, bound, lib, max(e for e, _ in errs))
    walk = ""
    if f32:
        qs, qw = fa.f32_tc_dkdv_walk(L, lk, d, bh)
        walk = f" [dK/dV {'split' if qw > 1 else 'wide'}: {qw} x {qs} q rows a step]"
    log(f"  bwd{' f32' if f32 else ''} B={b} h={heads} Lq={L} Lk={lk} d={d}{walk}: "
        f"{_fmt(ms, plain, lib, bound, flops, f32)} "
        f"err dq/dk/dv {[f'{e:.2e}' for e, _ in errs]} "
        f"(of max|plain| {[f'{x:.1e}' for x in shares]})")
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


def phase_f32_kernels():
    """The float32 forms of kernels 1, 2 and 5 against their plain versions
    (full float32: TF32 is off) at every shape phase 9 gives them: O and each
    gradient within 1e-4 * max|plain|, the LSE within 1e-4. Bound: operations
    at 3xTF32's rate or bytes, the larger; library:
    `F.scaled_dot_product_attention` at float32 (forward; SAM with the dense
    (B, H, N, N) bias as its mask) and the memory-efficient attention
    backward op."""
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa

    heads, f32 = 8, torch.float32
    fwd, bwd, sam = _totals(), _totals(), _totals()
    log(f"  float32 kernels: bound = operations at 3xTF32's rate "
        f"({PEAK_TF32X3_FLOPS / 1e12:.0f} TFLOP/s; the float32 FMA peak is "
        f"{PEAK_F32_FLOPS / 1e12:.0f}) or bytes at {PEAK_BYTES / 1e12:.2f} TB/s, "
        f"the larger; tolerance {TOL_F32} * max|plain|, LSE {TOL_LSE_F32}")
    for L, d in FLASH_LEVELS:
        reps = 3 if L == 4096 else 20
        for b, extra in F32_FWD_CASES:
            lk = L + extra
            q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b, dtype=f32)
            o, lse = fa.flash_attention_fwd(q, k, v)
            o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
            torch.cuda.synchronize()
            e_o, ok_o = _err(o, o_ref, TOL_F32)
            e_l = (lse - lse_ref).abs().max().item()
            if not (ok_o and e_l <= TOL_LSE_F32):
                fail(f"forward f32 disagrees at B={b} L={L} Lk={lk} d={d}: |dO|={e_o} "
                     f"|dLSE|={e_l}")
            share = _share(o, o_ref)
            del o_ref, lse_ref
            bh = b * heads
            flops = 4 * bh * L * lk * d
            nbytes = 4 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
            bound = _bound(fwd, flops, nbytes, PEAK_TF32X3_FLOPS)
            ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
            plain = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v), reps)
            torch.cuda.empty_cache()
            lib = _library_ms(fwd, "forward f32", lambda: F.scaled_dot_product_attention(
                q, k, v), reps)
            _add(fwd, ms, plain, bound, lib, e_o)
            log(f"  fwd f32 B={b} h={heads} Lq={L} Lk={lk} d={d}: "
                f"{_fmt(ms, plain, lib, bound, flops, True)} err O {e_o:.2e} "
                f"({share:.1e} of max|plain|) LSE {e_l:.2e}")
            del q, k, v, o, lse
            torch.cuda.empty_cache()
        for b, extra in F32_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps, dtype=f32)

    d = 64
    for bh, g in F32_SAM_CASES:
        n, reps = g * g, 5 if g == 64 else 20
        gen = torch.Generator(device="cuda").manual_seed(n + 1)
        q, k, v, bias_h, bias_w = (
            torch.randn((1, bh, n, last), generator=gen, device="cuda")
            for last in (d, d, d, g, g))
        o = sa.sam_attention(q, k, v, bias_h, bias_w)
        o_ref = sa.sam_attention_plain(q, k, v, bias_h, bias_w)
        torch.cuda.synchronize()
        err, ok = _err(o, o_ref, TOL_F32)
        if not ok:
            fail(f"sam_attention f32 disagrees at B*H={bh} N={n}: |dO|={err}")
        del o_ref
        flops = 4 * bh * n * n * d
        nbytes = 4 * bh * n * d * 4 + 4 * bh * n * 2 * g
        bound = _bound(sam, flops, nbytes, PEAK_TF32X3_FLOPS)
        ms = cuda_ms(lambda: sa.sam_attention(q, k, v, bias_h, bias_w), reps)
        plain = cuda_ms(lambda: sa.sam_attention_plain(q, k, v, bias_h, bias_w), reps)
        torch.cuda.empty_cache()
        mask = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(1, bh, n, n)
        lib = _library_ms(sam, "SAM attention f32", lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), reps)
        del mask
        _add(sam, ms, plain, bound, lib, err)
        log(f"  sam f32 B*H={bh} N={n} d={d} grid {g}x{g}: "
            f"{_fmt(ms, plain, lib, bound, flops, True)}, err O {err:.2e}")
        del q, k, v, bias_h, bias_w, o
        torch.cuda.empty_cache()
    return {"flash_attention_fwd_f32": fwd, "flash_attention_bwd_f32": bwd,
            "sam_attention_f32": sam}


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


def _stat_case(stats, b, c, n, dtype, same):
    """pair_stats against its plain version at one shape, with times."""
    import torch

    from lmdx_torch.nn.kernels import group_norm as gn

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
            _stat_case(stats, b, c, n, torch.bfloat16, True)
    for c, n in STAT_BWD_CASES:
        _stat_case(stats, 2, c, n, torch.float32, False)
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_packed": packed, "flash_attention_fwd_fusedheads": fused,
            "pair_stats": stats}


# Float32 opt-in path (phase 10). At float32 the fused-heads size rule counts
# K/V at 4 bytes and refuses the 1024-token self and fuser attention, so the
# head-packed forward serves head dims 40 and 80 and the fused-heads forward
# the rest; the guidance gradient (batch 2) runs the float32 backward after a
# head split at both kernels' shapes.
F32_PACKED_LEVELS = ((4096, 40), (1024, 80))
F32_FUSED_CASES = [c for c in FUSED_CASES if c[0] != 1024 or c[1] == 77]
F32_OPTIN_BWD = [(L, L + e, d) for L, d in FLASH_LEVELS for e in (0, 30)] + BWD_SHORT_KV
# The tensor-core kernels' tiles no path shape reaches, (batch, Lq, Lk,
# heads * d) and (batch, Lq, Lk, d): the 64-row q tile at head dim 160; the
# wide dK/dV walk at KV 77 (batch 17: 3 x 136 wide blocks) and the split one
# at batch 1.
F32_TILE_FUSED = [(2, 257, 286, 1280), (2, 320, 77, 1280)]
F32_TILE_BWD = [(17, 64, 77, 160), (1, 4096, 77, 40), (1, 64, 94, 160)]


def _fused_f32_case(fused, b, heads, L, lk, hd, reps=20):
    """Kernel 4-f32 against its plain version at one shape, with times and
    the library call (SDPA at float32 on strided (B, h, L, d) views)."""
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import flash_attention as fa

    d = hd // heads
    gen = torch.Generator(device="cuda").manual_seed(L + lk + hd + b + 1)
    qf, kf, vf = (torch.randn((b, rows, hd), generator=gen, device="cuda")
                  for rows in (L, lk, lk))
    o, lse = fa.flash_attention_fwd_fusedheads(qf, kf, vf, heads)
    o_ref, lse_ref = fa.attention_fwd_fusedheads_plain(qf, kf, vf, heads)
    torch.cuda.synchronize()
    e_o, ok_o = _err(o, o_ref, TOL_F32)
    e_l = (lse - lse_ref).abs().max().item()
    if not (ok_o and e_l <= TOL_LSE_F32):
        fail(f"fused-heads forward f32 disagrees at B={b} Lq={L} Lk={lk} hd={hd}: "
             f"|dO|={e_o} |dLSE|={e_l}")
    share = _share(o, o_ref)
    del o, lse, o_ref, lse_ref
    flops = 4 * b * heads * L * lk * d
    nbytes = 4 * b * hd * (2 * L + 2 * lk) + 4 * b * heads * L
    bound = _bound(fused, flops, nbytes, PEAK_TF32X3_FLOPS)
    ms = cuda_ms(lambda: fa.flash_attention_fwd_fusedheads(qf, kf, vf, heads), reps)
    plain = cuda_ms(lambda: fa.attention_fwd_fusedheads_plain(qf, kf, vf, heads), reps)
    q4, k4, v4 = (t.view(b, -1, heads, d).transpose(1, 2) for t in (qf, kf, vf))
    lib = _library_ms(fused, "fused-heads forward f32",
                      lambda: F.scaled_dot_product_attention(q4, k4, v4), reps)
    _add(fused, ms, plain, bound, lib, e_o)
    log(f"  fusedheads f32 B={b} h={heads} Lq={L} Lk={lk} hd={hd} [q tile "
        f"{32 if L <= 256 else 64} rows]: {_fmt(ms, plain, lib, bound, flops, True)}, "
        f"err O {e_o:.2e} ({share:.1e} of max|plain|) LSE {e_l:.2e}")
    del qf, kf, vf, q4, k4, v4
    torch.cuda.empty_cache()


def phase_f32_optin_kernels(bwd, stats):
    """The float32 forms of kernels 3 and 4 against their plain versions at
    every shape and batch phase 10 gives them (O within 1e-4 * max|plain|,
    the LSE within 1e-4), the packed one also equal bit for bit to kernel
    1-f32 on the same inputs; the float32 backward at phase 10's gradient
    shapes and `pair_stats` on float32 (x, x) at every GroupNorm of the UNet,
    their totals added to `bwd` and `stats`; then the tensor-core kernels'
    tiles no path shape reaches, outside the totals. Bound: operations at
    3xTF32's rate (attention; the FMA rate for `pair_stats`) or bytes, the
    larger; library: `F.scaled_dot_product_attention` at float32 (on strided
    (B, h, L, d) views for the fused-heads forward)."""
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import flash_attention as fa

    heads, f32 = 8, torch.float32
    packed, fused = _totals(), _totals()
    for L, d in F32_PACKED_LEVELS:
        reps = 3 if L == 4096 else 20
        for extra in (0, 30):
            for b in OPTIN_BATCHES:
                lk = L + extra
                q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b + 3, dtype=f32)
                o, lse = fa.flash_attention_fwd_packed(q, k, v)
                o_ref, lse_ref = fa.attention_fwd_packed_plain(q, k, v)
                torch.cuda.synchronize()
                e_o, ok_o = _err(o, o_ref, TOL_F32)
                e_l = (lse - lse_ref).abs().max().item()
                if not (ok_o and e_l <= TOL_LSE_F32):
                    fail(f"packed forward f32 disagrees at B={b} L={L} Lk={lk} d={d}: "
                         f"|dO|={e_o} |dLSE|={e_l}")
                o_one, lse_one = fa.flash_attention_fwd(q, k, v)
                if not (torch.equal(o, o_one) and torch.equal(lse, lse_one)):
                    fail(f"packed forward f32 differs from kernel 1-f32 at B={b} L={L} "
                         f"Lk={lk} d={d}")
                del o, lse, o_ref, lse_ref, o_one, lse_one
                bh = b * heads
                flops = 4 * bh * L * lk * d
                nbytes = 4 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
                bound = _bound(packed, flops, nbytes, PEAK_TF32X3_FLOPS)
                ms = cuda_ms(lambda: fa.flash_attention_fwd_packed(q, k, v), reps)
                plain = cuda_ms(lambda: fa.attention_fwd_packed_plain(q, k, v), reps)
                torch.cuda.empty_cache()
                lib = _library_ms(packed, "packed forward f32",
                                  lambda: F.scaled_dot_product_attention(q, k, v), reps)
                _add(packed, ms, plain, bound, lib, e_o)
                log(f"  packed f32 B={b} h={heads} Lq={L} Lk={lk} d={d}: "
                    f"{_fmt(ms, plain, lib, bound, flops, True)} (equal to kernel 1-f32 bit for "
                    f"bit) err O {e_o:.2e} LSE {e_l:.2e}")
                del q, k, v
                torch.cuda.empty_cache()

    for L, lk, hd in F32_FUSED_CASES:
        for b in OPTIN_BATCHES:
            _fused_f32_case(fused, b, heads, L, lk, hd)

    before = bwd["ms"]
    for L, lk, d in F32_OPTIN_BWD:
        _check_bwd(bwd, 2, heads, L, lk, d, 3 if L == 4096 else 20, dtype=f32)
    log(f"  bwd f32: {bwd['ms'] - before:.3f} ms over the {len(F32_OPTIN_BWD)} shapes of the "
        f"float32 opt-in path")
    # The tensor-core kernels' other tiles, checked and timed outside the
    # paths' totals: the 64-row q tile at head dim 160 (Lq just above 256)
    # and both dK/dV walks at batch 17 and 1 of the KV-77 and 64-token shapes.
    tiles = _totals()
    for b, L, lk, hd in F32_TILE_FUSED:
        _fused_f32_case(tiles, b, heads, L, lk, hd)
    for b, L, lk, d in F32_TILE_BWD:
        _check_bwd(tiles, b, heads, L, lk, d, 20, dtype=f32)
    for c, n in STAT_CASES:
        for b in OPTIN_BATCHES:
            _stat_case(stats, b, c, n, f32, True)
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_packed_f32": packed,
            "flash_attention_fwd_fusedheads_f32": fused}


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
    flash = sum(ms for k, ms, _ in rows if "flash_" in k or "attn_f32" in k)
    sam = sum(ms for k, ms, _ in rows if k.startswith("sam_"))
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
                 "pair_stats": 0, "sam_attention": expected_sam,
                 "flash_attention_fwd_f32": 0, "flash_attention_bwd_f32": 0,
                 "sam_attention_f32": 0, "flash_attention_fwd_packed_f32": 0,
                 "flash_attention_fwd_fusedheads_f32": 0}, ladder_max,
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


def _optin_expect(cfg, steps, fuser_beta, ladder, per_box_taps, dtype_name="bfloat16"):
    """Expected launch counts of the LMD+ path with every option on, at the
    bundle's compute dtype (bf16 kernels, or their float32 forms and none of
    the bf16 ones). The dispatch: an untapped attention runs the fused-heads
    kernel where `fusedheads_supported` holds at that dtype, else the
    per-head gate and there the packed kernel; tapped cross-attentions stay
    plain math; every GroupNorm launches `pair_stats` once forward and once
    backward. The backward kernel runs once for every kernel forward inside
    a guidance iteration."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.sampling.guidance import default_guidance_keys

    ucfg = cfg.unet
    blocks, norms_full, norms_early, last_up = _unet_layout(cfg)
    early_blocks = [b for b in blocks if not (b[0][0] == "up" and b[0][1] > last_up)]
    guidance_keys = set(default_guidance_keys(ucfg))
    ctx_len, heads = cfg.clip.max_length, ucfg.num_attention_heads[0]
    dtype = getattr(torch, dtype_name)
    suffix = "_f32" if dtype == torch.float32 else ""

    def counts(layers, tapped, fuser):
        """(packed, fused-heads) launches of one forward over `layers`."""
        packed = fused = 0
        for key, n, width in layers:
            calls = [(n, n)] + ([(n, n + ucfg.gligen_max_objs)] if fuser else [])
            if key not in tapped:
                calls.append((n, ctx_len))
            for lq, lk in calls:
                qf = torch.empty((1, lq, width), dtype=dtype, device="meta")
                kf = torch.empty((1, lk, width), dtype=dtype, device="meta")
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
        want = {f"{name}{tail}": 0 for name in (
            "flash_attention_fwd", "flash_attention_bwd", "flash_attention_fwd_packed",
            "flash_attention_fwd_fusedheads", "sam_attention") for tail in ("", "_f32")}
        want.update({f"flash_attention_bwd{suffix}": bwd,
                     f"flash_attention_fwd_packed{suffix}": packed,
                     f"flash_attention_fwd_fusedheads{suffix}": fused, "pair_stats": stats})
        return (want, ladder_max,
                f"{norms_full} GroupNorms per full forward, {norms_early} per guidance "
                f"forward and as many in its backward, {n_iters} guidance iterations")

    return expect


def _drive(label, run, cfg, steps, expect, profile=None, segmenter=None, n_passes=2,
           solver="DDIM", bwd_key="flash_attention_bwd"):
    """Drives one main path through its entry point and checks it.

    `run()` is called once with every launch count set to 0 just before it;
    the counts are read just after. Meanwhile each sampling pass's guidance
    iterations per step, the decoded latents' finiteness and the segmenter's
    wall time are recorded (and with `profile`, a torch.profiler breakdown
    is written there). Checks the images (uint8, cfg-sized, non-constant,
    from finite latents), that `n_passes` sampling passes ran, and that every
    kernel's launches equal what `expect(iterations)` says the dispatch, the
    schedule and the recorded iterations imply (the backward, `bwd_key`, also
    within the ladders' maximum). Returns the results and the launch
    counts."""
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

    def decode(bundle_, latents, **kw):
        decoded.append(bool(torch.isfinite(latents).all().item()))
        return orig_decode(bundle_, latents, **kw)

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
    bwd = launches[bwd_key]
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


@contextlib.contextmanager
def _recording_optin_shapes():
    """Records, while active, the shape and dtype of every call to the
    packed and fused-heads forwards, the flash backward and `pair_stats` (the
    wrappers still launch and count); yields the sets by wrapper."""
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn

    seen = {"packed": set(), "fused": set(), "bwd": set(), "stats": set()}
    originals = (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
                 fa.flash_attention_bwd, gn.pair_stats)

    def packed(q, k, v):
        seen["packed"].add((q.shape[0], q.shape[2], k.shape[2] - q.shape[2], _dtype_name(q)))
        return originals[0](q, k, v)

    def fused(qf, kf, vf, heads):
        seen["fused"].add((qf.shape[0], qf.shape[1], kf.shape[1], qf.shape[2], _dtype_name(qf)))
        return originals[1](qf, kf, vf, heads)

    def bwd(q, k, v, *rest):
        seen["bwd"].add((q.shape[0], q.shape[2], k.shape[2], q.shape[3], _dtype_name(q)))
        return originals[2](q, k, v, *rest)

    def stats(a, b):
        seen["stats"].add((a.shape[0], a.shape[1], a.shape[2], _dtype_name(a), a is b))
        return originals[3](a, b)

    (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
     fa.flash_attention_bwd, gn.pair_stats) = packed, fused, bwd, stats
    try:
        yield seen
    finally:
        (fa.flash_attention_fwd_packed, fa.flash_attention_fwd_fusedheads,
         fa.flash_attention_bwd, gn.pair_stats) = originals


def _optin_checked(dtype_name: str) -> dict:
    """Every (batch, shape..., dtype) phase 2 holds the opt-in path's
    wrappers to at `dtype_name`, as `_recording_optin_shapes` records them."""
    b_all = OPTIN_BATCHES
    if dtype_name == "float32":
        packed = {(b, L, e) for L, _ in F32_PACKED_LEVELS for e in (0, 30) for b in b_all}
        fused = {(b, *c) for c in F32_FUSED_CASES for b in b_all}
        bwd = ({(2, *c) for c in F32_OPTIN_BWD}
               | {(b, L, L + e, d) for L, d in FLASH_LEVELS for b, e in F32_BWD_CASES})
    else:
        packed = {(b, L, e) for L, e in PACKED_CASES for b in b_all}
        fused = {(b, *c) for c in FUSED_CASES for b in b_all}
        bwd = ({(2, *c) for c in BWD_SHORT_KV}
               | {(b, L, L + e, d) for L, d in FLASH_LEVELS for b, e in BWD_CASES})
    tag = (dtype_name,)
    return {"packed": {s + tag for s in packed}, "fused": {s + tag for s in fused},
            "bwd": {s + tag for s in bwd},
            "stats": ({(b, c, n, dtype_name, True) for c, n in STAT_CASES for b in b_all}
                      | {(2, c, n, "float32", False) for c, n in STAT_BWD_CASES})}


def _require_optin_shapes(label, seen, dtype_name):
    checked = _optin_checked(dtype_name)
    for name, shapes in seen.items():
        if not shapes or not shapes <= checked[name]:
            fail(f"{label}: {name} was given shapes phase 2 did not check: "
                 f"{sorted(shapes - checked[name], key=str)} (seen {len(shapes)})")
    log(f"{label}: every shape the opt-in wrappers were given was checked in phase 2 "
        f"({ {k: len(v) for k, v in seen.items()} })")


def _optin_unet_check(on, off, tol, label):
    """One UNet forward and one gradient of the guidance taps w.r.t. the
    latents, options on against options off, on the same weights and inputs
    (batch 2, GLIGEN on): max|on - off| <= tol * max|off| for each. Also
    holds every shape the opt-in wrappers are given against the tables phase
    2 checked at the bundles' dtype."""
    import torch

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

    def run(bundle):
        with torch.no_grad():
            eps = apply_unet(bundle.unet, lat, 501, ctx, objs=objs)[0]
        x = lat.clone().requires_grad_(True)
        taps = apply_unet(bundle.unet, x, 501, ctx, objs=objs, taps=spec,
                          stop_after_taps=True)[1]
        loss = sum(t.float().square().sum() for t in taps.values())
        return eps, torch.autograd.grad(loss, x)[0]

    with _recording_optin_shapes() as seen:
        eps_on, grad_on = run(on)
    eps_off, grad_off = run(off)
    torch.cuda.synchronize()
    for what, a, b in (("eps", eps_on, eps_off), ("latent gradient", grad_on, grad_off)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label}: non-finite {what}")
        diff, ok = _err(a, b, tol)
        ref = b.abs().max().item()
        log(f"{label}: UNet {what} options on vs off: max|diff| {diff:.3e} = "
            f"{diff / ref:.3e} of max|off| {ref:.3e} (limit {tol:g})")
        if not ok:
            fail(f"{label}: UNet {what} differs by {diff / ref:.3e} of max|off|")
    _require_optin_shapes(label, seen, str(cfg.torch_dtype()).rpartition(".")[2])


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
    _optin_unet_check(bundle, off, TOL_OPTIN, "optin")
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
    """Records the shape and dtype of every call to the flash forward and
    backward and to SAM attention while active (the wrappers still launch and
    count); yields the sets of (shape..., dtype name) by wrapper."""
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa

    seen = {"fwd": set(), "bwd": set(), "sam": set()}
    originals = fwd, bwd, sam = (fa.flash_attention_fwd, fa.flash_attention_bwd,
                                 sa.sam_attention)

    def rec_fwd(q, k, v):
        seen["fwd"].add((*q.shape[:3], k.shape[2], q.shape[3], _dtype_name(q)))
        return fwd(q, k, v)

    def rec_bwd(q, k, v, *rest):
        seen["bwd"].add((*q.shape[:3], k.shape[2], q.shape[3], _dtype_name(q)))
        return bwd(q, k, v, *rest)

    def rec_sam(q, *rest):
        seen["sam"].add((q.shape[0] * q.shape[1], q.shape[2], _dtype_name(q)))
        return sam(q, *rest)

    fa.flash_attention_fwd, fa.flash_attention_bwd, sa.sam_attention = rec_fwd, rec_bwd, rec_sam
    try:
        yield seen
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd, sa.sam_attention = originals


def _dtype_name(t) -> str:
    return str(t.dtype).rpartition(".")[2]


def _phase2_shapes():
    """Every shape phase 2 holds the flash forward, the default paths'
    backward and SAM attention to, in bf16 and in float32, as
    `_recording_shapes` records them."""
    heads = 8

    def flash(cases, dtype):
        return {(b, heads, L, L + e, d, dtype) for L, d in FLASH_LEVELS for b, e in cases}

    return {"fwd": flash(FWD_CASES, "bfloat16") | flash(F32_FWD_CASES, "float32"),
            "bwd": flash(BWD_CASES, "bfloat16") | flash(F32_BWD_CASES, "float32"),
            "sam": ({(bh, g * g, "bfloat16") for bh, g in SAM_CASES}
                    | {(bh, g * g, "float32") for bh, g in F32_SAM_CASES})}


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
    import torch

    from lmdx_torch.config import ALL_KERNELS
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
            # Float32 with every opt-in kernel passes the dtype gate (each
            # kernel has a float32 form) and meets the tokenizer refusal too.
            for kw, needle in (({}, "WordTokenizer"),
                               ({"dtype": "float32", "kernels": ALL_KERNELS}, "WordTokenizer")):
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


# Hand-written stage-1 responses, in the template's format, for the three
# demo prompts (eval/prompts.py::PROMPTS_DEMO): 3 boxes, 1 box, 2 boxes.
DEMO_RESPONSES = (
    "Objects: [('a blue cube', [232, 135, 132, 132]), ('a red cube', [232, 280, 132, 132]), "
    "('a vase', [80, 250, 90, 160])]\nBackground prompt: An indoor scene\nNegative prompt: ",
    "Objects: [('a wooden table', [60, 250, 392, 200])]\nBackground prompt: A realistic "
    "photo of an indoor scene\nNegative prompt: bananas",
    "Objects: [('a white deer', [60, 200, 180, 230]), ('a gray bear', [290, 210, 190, 220])]"
    "\nBackground prompt: A realistic image of an empty factory scene\nNegative prompt: ",
)


def _cli(argv) -> str:
    """`lmdx_torch.cli.generate.main(argv)` in this process; returns what it
    printed (also logged) and fails unless it returned 0."""
    import io

    from lmdx_torch.cli import generate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = generate.main(argv)
    for line in out.getvalue().splitlines():
        log(f"  | {line[:200]}")
    if rc != 0:
        fail(f"cli {argv}: returned {rc}")
    return out.getvalue()


def _read_png(path: str):
    import numpy as np
    from PIL import Image

    if not os.path.exists(path):
        fail(f"cli: {path} was not written")
    with Image.open(path) as im:
        return np.asarray(im)


def _check_cli_images(label, run_dir, dirs, cfg, results=None):
    """Each prompt directory's img_0.png is a uint8 (H, W, 3) image, not
    constant, and equal to the method's result when `results` is given."""
    for i, ind in enumerate(dirs):
        img = _read_png(os.path.join(run_dir, str(ind), "img_0.png"))
        if img.dtype.name != "uint8" or img.shape != (cfg.height, cfg.width, 3) or img.std() == 0:
            fail(f"{label}: {run_dir}/{ind}/img_0.png is {img.dtype} {img.shape}, "
                 f"std {img.std()}")
        if results is not None and not (img == results[i].image).all():
            fail(f"{label}: {run_dir}/{ind}/img_0.png differs from the method's image")
    log(f"{label}: {len(dirs)} image directories under {os.path.relpath(run_dir)}: "
        f"{sorted(os.listdir(os.path.join(run_dir, str(dirs[0]))))}")


def phase_cli(f32_steps: int, plus_steps: int, profile: str | None = None):
    """Phase 9: the stage-2 CLI in this process on a layout cache of the demo
    prompts. (a) float32 LMD (`--use_autocast 0`) on SD1.5 with a fabricated
    SAM ViT-B loaded in bf16, sequential; (b) one float32 SamSegmenter call,
    box-prompted, on one of (a)'s images; (c) bf16 LMD+ through the batched,
    pipelined mode, run twice (the second schedules nothing). `profile`
    traces (a) with torch.profiler into that file."""
    import numpy as np
    import torch

    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.methods import _grounded
    from lmdx_torch.methods import lmd as lmd_method
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.nn.sam import SamSegmenter, sam_vit_base
    from lmdx_torch.runtime import convert, fabricate, models
    from lmdx_torch.text import parser
    from lmdx_torch.text.cache import LayoutCache

    t_phase = time.perf_counter()
    all_launches = {}
    with tempfile.TemporaryDirectory(prefix="lmdx_cli_") as root, \
            _recording_shapes() as seen:
        cache_path = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
        cache = LayoutCache(cache_path)
        specs = []
        for prompt, response in zip(PROMPTS_DEMO, DEMO_RESPONSES):
            prompt = prompt.strip().rstrip(".")
            cache.add(prompt, response)
            layout = parser.parse_layout_response(response)
            specs.append({"prompt": prompt, "gen_boxes": parser.filter_boxes(layout.gen_boxes)})
        t0 = time.perf_counter()
        fabricate.fabricate_sam(root, torch.float16)
        sam_dir = os.path.join(root, fabricate.SAM_KEY.replace("/", "--"))
        boxes = [len(s["gen_boxes"]) for s in specs]
        log(f"cli: layout cache of {len(specs)} demo prompts ({boxes} boxes) and a "
            f"fabricated SAM ViT-B in {time.perf_counter() - t0:.1f} s")

        # (a) float32 LMD through the sequential loop, on two prompts.
        cfg = SD_CONFIGS["runwayml/stable-diffusion-v1-5"]()
        p = _grounded.GroundedParams(num_inference_steps=f32_steps)
        n_prompts = 2
        expected_sam = sum(sam_vit_base().encoder_layers
                           * -(-len(s["gen_boxes"]) // SamSegmenter.CHUNK)
                           for s in specs[:n_prompts])
        base_expect = _default_expect(
            cfg, f32_steps, 0.0,
            [(p.max_iter, p.max_index_step), (p.overall_max_iter, p.overall_max_index_step)]
            * n_prompts, expected_sam, passes=2 * n_prompts)

        def f32_expect(iters):
            want, ladder_max, note = base_expect(iters)
            want = {**want, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                    "flash_attention_fwd_f32": want["flash_attention_fwd"],
                    "flash_attention_bwd_f32": want["flash_attention_bwd"]}
            return want, ladder_max, note + "; every UNet attention on the float32 kernels"

        results = []
        orig_run = lmd_method.run

        def run_and_keep(*a, **kw):
            results.append(orig_run(*a, **kw))
            return results[-1]

        f32_dir = os.path.join(root, "f32")
        argv = ["--prompt-type", "demo", "--run-model", "lmd", "--use_autocast", "0",
                "--num_prompts", str(n_prompts), "--cache-path", cache_path,
                "--save-dir", f32_dir, "--sam-checkpoint", sam_dir,
                "--num_inference_steps", str(f32_steps), "--no-continue-on-error"]
        lmd_method.run = run_and_keep
        try:
            _, launches = _drive("cli lmd f32", lambda: (_cli(argv), results)[1], cfg,
                                 f32_steps, f32_expect, profile=profile,
                                 n_passes=2 * n_prompts, bwd_key="flash_attention_bwd_f32")
        finally:
            lmd_method.run = orig_run
        if (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32):
            fail("cli lmd f32: TF32 is on after --use_autocast 0")
        run_dir = os.path.join(f32_dir, "templatev0.1_lmd_demo", "run0")
        _check_cli_images("cli lmd f32", run_dir, list(range(n_prompts)), cfg, results)
        for ind in range(n_prompts):
            for name in ("boxes.png", "masks_0.png"):
                _read_png(os.path.join(run_dir, str(ind), name))
        all_launches["lmd f32"] = launches

        # (b) kernel 5's float32 form: a float32 SAM on the same weights.
        segmenter = SamSegmenter(models.build_sam(
            state_dict=convert.load_sam_state_dict(sam_dir), device="cuda",
            dtype=torch.float32))
        x, y, w, h = specs[0]["gen_boxes"][0][1]
        box = (x / 512, y / 512, (x + w) / 512, (y + h) / 512)
        sa.reset_launch_counts()
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = segmenter.segment_batch([results[0].image], input_boxes=[[box]],
                                      target_hw=(cfg.latent_height, cfg.latent_width))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **sa.LAUNCHES}
        masks, iou = out[0]
        log(f"cli sam f32: box-prompted segment_batch of 1 image in {wall:.3f} s, launches "
            f"{launches}, mask area {int(np.asarray(masks).sum())}, IoU {np.asarray(iou)}")
        want = segmenter.config.encoder_layers
        if launches["sam_attention_f32"] != want or launches["sam_attention"] != 0:
            fail(f"cli sam f32: sam_attention_f32 launches {launches['sam_attention_f32']} "
                 f"(expected {want}), bf16 {launches['sam_attention']} (expected 0)")
        if not np.isfinite(np.asarray(iou)).all():
            fail("cli sam f32: non-finite IoU")
        all_launches["sam f32"] = {k: launches.get(k, 0) for k in all_launches["lmd f32"]}
        del segmenter
        torch.cuda.empty_cache()

        # (c) bf16 LMD+ through the batched, pipelined mode; its rerun
        # finds every image and schedules nothing.
        plus_dir = os.path.join(root, "plus")
        argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--image-batch-size", "2",
                "--cache-path", cache_path, "--save-dir", plus_dir, "--force_run_ind", "0",
                "--num_inference_steps", str(plus_steps), "--no-continue-on-error"]
        fa.reset_launch_counts()
        sa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = _cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **sa.LAUNCHES}
        plus_cfg = SD_CONFIGS["gligen/diffusers-generation-text-box"]()
        for needle in ("[batched] 3 jobs, batch size 2 (pipelined)", "[batched] 3/3 done"):
            if needle not in printed:
                fail(f"cli lmd_plus batched: no {needle!r} line")
        run_dir = os.path.join(plus_dir, "templatev0.1_lmd_plus_demo", "run0")
        _check_cli_images("cli lmd_plus batched", run_dir, [0, 1, 2], plus_cfg)
        if launches["flash_attention_fwd"] <= 0 or launches["flash_attention_bwd"] <= 0 or any(
                launches[k] for k in ("flash_attention_fwd_f32", "flash_attention_bwd_f32",
                                      "sam_attention", "sam_attention_f32")):
            fail(f"cli lmd_plus batched: launches {launches}")
        log(f"cli lmd_plus batched: 3 images, 512x512, {plus_steps} DDIM steps, pipelined: "
            f"wall {wall:.2f} s with the bundle's build, {3 / wall:.4f} images/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}")
        all_launches["lmd_plus batched"] = {k: launches.get(k, 0)
                                            for k in all_launches["lmd f32"]}
        t0 = time.perf_counter()
        if "[batched] 0 jobs" not in _cli(argv):
            fail("cli lmd_plus batched: the rerun scheduled jobs")
        log(f"cli lmd_plus batched: the rerun scheduled 0 jobs in "
            f"{time.perf_counter() - t0:.2f} s (the bundle's build)")
    _require_checked_shapes("cli", seen)
    log(f"cli: phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


# Hand-written stage-1 responses, in the template's format, for the first two
# prompts of the attribution benchmark (eval/prompts.py, "lmd_attribution"):
# 2 boxes each.
ATTRIBUTION_RESPONSES = (
    "Objects: [('a blue dog', [50, 230, 200, 220]), ('a white bowl', [300, 330, 160, 110])]"
    "\nBackground prompt: A realistic photo of a scene\nNegative prompt: ",
    "Objects: [('a yellow book', [60, 300, 190, 130]), ('a green cup', [310, 250, 120, 180])]"
    "\nBackground prompt: A realistic photo of a scene\nNegative prompt: ",
)


def phase_f32_optin(steps: int, run_dir: str):
    """Phase 10 (a): float32 LMD+ with every opt-in kernel. The float32 bundle
    with `ALL_KERNELS` against the float32 bundle with the options off (one
    UNet forward and one guidance gradient, batch 2, GLIGEN on, within 1e-3 *
    max|off|), then `run_lmd_plus_batch` on two attribution prompts with
    hand-written 2-box layouts, `_drive`'s checks, the launches of kernels
    3-f32, 4-f32, 2-f32 and `pair_stats` as the float32 dispatch implies and
    0 of every bf16 flash kernel, every wrapper shape one phase 2 checked;
    each image is written as `<run_dir>/<i>/img_0.png`."""
    import torch
    from PIL import Image

    from lmdx_torch.config import ALL_KERNELS
    from lmdx_torch.eval.prompts import get_prompts
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.methods.batch import run_lmd_plus_batch
    from lmdx_torch.runtime import models
    from lmdx_torch.sampling.guidance import default_guidance_keys, default_obj_attn_key
    from lmdx_torch.text import parser

    t_phase = time.perf_counter()
    key = "gligen/diffusers-generation-text-box"
    t0 = time.perf_counter()
    bundle = models.load_bundle(key, seed=0, dtype="float32", device="cuda",
                                kernels=ALL_KERNELS)
    off = models.load_bundle(key, seed=0, dtype="float32", device="cuda")
    torch.cuda.synchronize()
    log(f"optin f32: float32 bundles with every option on and off (random weights, seed 0) "
        f"built in {time.perf_counter() - t0:.1f} s")
    _optin_unet_check(bundle, off, TOL_OPTIN_F32, "optin f32")
    del off
    torch.cuda.empty_cache()

    specs = []
    for prompt, response in zip(get_prompts("lmd_attribution"), ATTRIBUTION_RESPONSES):
        layout = parser.parse_layout_response(response)
        specs.append({"prompt": prompt.strip().rstrip("."),
                      "gen_boxes": parser.filter_boxes(layout.gen_boxes),
                      "bg_prompt": layout.bg_prompt, "extra_neg_prompt": layout.neg_prompt})
    if [len(s["gen_boxes"]) for s in specs] != [2, 2]:
        fail(f"optin f32: the attribution layouts parsed to {specs}")
    cfg = bundle.config
    p = GroundedParams(num_inference_steps=steps)
    per_box_taps = (default_obj_attn_key(cfg.unet), *default_guidance_keys(cfg.unet))
    with _recording_optin_shapes() as seen:
        results, launches = _drive(
            "optin f32",
            lambda: run_lmd_plus_batch(specs, bundle, bg_seeds=[1, 2],
                                       num_inference_steps=steps),
            cfg, steps,
            _optin_expect(cfg, steps, 0.4, (p.overall_max_iter, p.overall_max_index_step),
                          per_box_taps, "float32"),
            bwd_key="flash_attention_bwd_f32")
    for r in results:
        if r.aux["frozen_mask"].sum() <= 0:
            fail("optin f32: empty frozen mask")
    _require_optin_shapes("optin f32", seen, "float32")
    for i, r in enumerate(results):
        os.makedirs(os.path.join(run_dir, str(i)), exist_ok=True)
        Image.fromarray(r.image).save(os.path.join(run_dir, str(i), "img_0.png"))
    log(f"optin f32: {len(results)} images written under {run_dir}/<i>/img_0.png for "
        f"{[s['prompt'] for s in specs]}")
    del bundle
    torch.cuda.empty_cache()
    log(f"optin f32: phase 10 (a) took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_owlvit(run_dir: str, n_images: int):
    """Phase 10 (b): OWL-ViT base-patch32 fabricated in fp16, validated
    against its manifest and loaded from disk in float32 on the card (every
    parameter equal to its file tensor cast, bit for bit); then the stage-2
    eval CLI (`lmdx_torch.cli.owl_vit_eval.main`, in this process) over
    `run_dir` at --eval-batch-size 2 and 1: equal reports, each of
    `n_images` attribution images."""
    import io
    import torch

    from lmdx_torch.cli import owl_vit_eval
    from lmdx_torch.eval.owl_vit import OwlViTDetector
    from lmdx_torch.runtime import convert, fabricate

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lmdx_owlvit_") as root:
        t0 = time.perf_counter()
        n = fabricate.fabricate_owlvit(root, torch.float16)
        path = os.path.join(root, fabricate.OWLVIT_KEY.replace("/", "--"))
        size = _dir_bytes(path)
        log(f"owlvit: fabricated {n / 1e6:.1f}M params in fp16 ({size / 1e9:.3f} GB) in "
            f"{time.perf_counter() - t0:.1f} s")
        report = convert.validate_component(convert.OWLVIT_MANIFEST, path)
        if any(report.values()):
            fail(f"owlvit: the checkpoint does not match its manifest: {report}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        detector = OwlViTDetector.from_checkpoint(path, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        values = _check_loaded("owlvit", {"owlvit": detector.model},
                               {"owlvit": convert.load_owlvit_state_dict(path)}, ("",))
        log(f"owlvit: loaded from {size / 1e9:.3f} GB in {wall:.2f} s, float32 on the card; "
            f"{values / 1e6:.1f}M values equal the file's tensors bit for bit")
        del detector
        torch.cuda.empty_cache()

        summaries = []
        for batch in (2, 1):
            argv = ["--run_base_path", run_dir, "--prompt-type", "lmd_attribution",
                    "--num_prompts", str(n_images), "--owlvit-checkpoint", path,
                    "--eval-batch-size", str(batch)]
            out = io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = owl_vit_eval.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            summary = out.getvalue().strip()
            if rc != 0:
                fail(f"owlvit: the eval CLI returned {rc} at --eval-batch-size {batch}")
            log(f"owlvit: eval CLI at --eval-batch-size {batch}: wall {wall:.2f} s with the "
                f"detector's load, peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; report "
                f"{summary.splitlines()}")
            first = summary.splitlines()[0]
            if not (first.startswith("Eval type: attribution, success: ")
                    and f"/{n_images}, rate" in first):
                fail(f"owlvit: the report does not record {n_images} attribution images: "
                     f"{summary!r}")
            summaries.append(summary)
        if summaries[0] != summaries[1]:
            fail(f"owlvit: batched and sequential reports differ: {summaries}")
    log(f"owlvit: batched and sequential reports equal; phase 10 (b) took "
        f"{time.perf_counter() - t_phase:.1f} s")


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
    ap.add_argument("--cli-f32-steps", type=int, default=50,
                    help="DDIM steps of phase 9's float32 LMD through the CLI (depth only; a "
                         "rehearsal flag: the check is the 50 steps of the default)")
    ap.add_argument("--cli-steps", type=int, default=20,
                    help="DDIM steps of phase 9's batched bf16 LMD+ through the CLI (depth "
                         "only: phase 3 runs the same work at 50 steps)")
    ap.add_argument("--optin-f32-steps", type=int, default=50,
                    help="DDIM steps of phase 10's float32 LMD+ with every opt-in kernel "
                         "(depth only; a rehearsal flag: the check is the 50 steps of the "
                         "default)")
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the three paths and phase 9's float32 LMD with "
                         "torch.profiler and write the device time by kernel to PATH and to "
                         "PATH with _lmd, _optin and _cli before its extension (the wall "
                         "times then include the tracing cost)")
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
    kernels.update(phase_f32_kernels())
    kernels.update(phase_f32_optin_kernels(kernels["flash_attention_bwd_f32"],
                                           kernels["pair_stats"]))
    plus = phase_main_path(args.steps, args.profile)
    lmd_profile = optin_profile = None
    root, ext = os.path.splitext(args.profile or "")
    if args.profile:
        lmd_profile, optin_profile = f"{root}_lmd{ext}", f"{root}_optin{ext}"
    lmd = phase_lmd(args.lmd_steps, lmd_profile)
    optin = phase_optin(args.optin_steps, optin_profile)
    single = phase_single(args.single_steps)
    baselines = phase_baselines(args.baseline_steps)
    checkpoint = phase_checkpoint(args.ckpt_steps)
    cli = phase_cli(args.cli_f32_steps, args.cli_steps,
                    f"{root}_cli{ext}" if args.profile else None)
    with tempfile.TemporaryDirectory(prefix="lmdx_f32_optin_") as run_dir:
        optin_f32 = phase_f32_optin(args.optin_f32_steps, run_dir)
        phase_owlvit(run_dir, len(ATTRIBUTION_RESPONSES))
    launches = {name: plus[name] + lmd[name] + optin[name] + single[name] + baselines[name]
                + checkpoint[name] + cli[name] + optin_f32[name] for name in kernels}
    log(f"launches: LMD+ path {plus}, LMD path {lmd}, opt-in LMD+ path {optin}, "
        f"single-image methods {single}, baselines and solvers {baselines}, "
        f"checkpoint path {checkpoint}, CLI {cli}, float32 opt-in LMD+ path {optin_f32}")

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
                              "lmdx/nn/pallas/group_norm.py:60"),
               "flash_attention_fwd_f32": ("lmdx_torch/csrc/attention_f32.cu",
                                           "lmdx/nn/pallas/flash_attention.py:107"),
               "flash_attention_bwd_f32": ("lmdx_torch/csrc/attention_f32.cu",
                                           "lmdx/nn/pallas/flash_attention.py:384"),
               "sam_attention_f32": ("lmdx_torch/csrc/attention_f32.cu",
                                     "lmdx/nn/pallas/sam_attention.py:101"),
               "flash_attention_fwd_packed_f32": ("lmdx_torch/csrc/attention_f32.cu",
                                                  "lmdx/nn/pallas/flash_attention.py:211"),
               "flash_attention_fwd_fusedheads_f32": ("lmdx_torch/csrc/attention_f32.cu",
                                                      "lmdx/nn/pallas/flash_attention.py:622")}
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
        f"+ {len(STAT_CASES) * n_opt} float32 (x, x) for pair_stats, "
        f"{3 * len(F32_FWD_CASES)} for the float32 forward, "
        f"{3 * len(F32_BWD_CASES)} + {len(F32_OPTIN_BWD)} for the float32 backward, "
        f"{len(F32_SAM_CASES)} for float32 SAM, {4 * n_opt} for the float32 packed "
        f"forward, {len(F32_FUSED_CASES) * n_opt} for the float32 fused-heads forward); "
        f"launches are those of the LMD+, LMD and opt-in LMD+ paths, the single-image "
        f"methods, the baselines and solvers, the checkpoint path, the CLI and the "
        f"float32 opt-in LMD+ path together")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
