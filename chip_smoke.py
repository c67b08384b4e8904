#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lmdx_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps N] [--lmd-steps N] [--optin-steps N]
                          [--single-steps N] [--baseline-steps N] [--ckpt-steps N]
                          [--cli-f32-steps N] [--cli-steps N] [--optin-f32-steps N]
                          [--webui-steps N] [--dist-steps N] [--dist-tp-steps N]
                          [--profile PATH]

Sixteen phases; any failure exits nonzero before the final line is printed.
Phases 3-7, 9, 10 and 13-15 run on random weights (LMDX_CHECKPOINT_DIR is
unset for them); phase 8 loads checkpoints from disk, phase 9 a fabricated
SAM, phase 10 a fabricated OWL-ViT, phase 11 a fabricated SDXL refiner,
phase 12 a fabricated SD2.1 base, SDXL base and SAM.

1. Build: compiles every CUDA source of the port (`lmdx_torch/csrc/*.cu`,
   seven), one nvcc per source, all started together, into build/kernels/,
   and prints each kernel's registers and spilled bytes (`ptxas -v`). Fails
   if an attention kernel (the bf16 forward body's four kernels, the bf16
   backward's two, and the float32 tensor-core body's four: the forward
   kernel of kernels 1-f32, 3-f32 and 4-f32, SAM's 5-f32, and 2-f32's dQ and
   dK/dV kernels) instantiated for a head dim the paths use (40 for the
   float32 forward, 48, 64, 80, 160) spills.
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
   guidance; KV = L and L + 30), and at the training cell's batch 16
   (TRAIN_BWD_CASES, KV = L and L + 30; head dims 40 and 80 run the
   warpgroup-MMA backward); and the forward at the SDXL refiner's
   head dim 64 (phase 11, REFINER_FWD_CASES: CFG batch 2 at 12 heads x 4096
   tokens, 24 x 1024 and 24 x 256, KV = L), the SDXL base's (phase 12 (d),
   SDXL_BASE_FWD_CASES: CFG batch 2 at 10 heads x 4096 and 20 x 1024) and
   SD2.1's (phase 12 (b), SD21_LEVELS: 5 heads x 4096 tokens, 10 x 1024, 20
   x 256, all at head dim 64; the forward at batch 6, 3, 2 and 1, the
   backward at LMD's guidance batches 3 and 1, KV = L), each group's sums
   printed apart and in the totals. SAM attention: one 4-image chunk and one
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
   F32_SAM_CASES) and at SD2.1's head-dim-64 shapes of phase 12 (c) (the
   same batches as bf16), within 1e-4 * max|plain| for O and each gradient and
   1e-4 for the LSE (the plain versions in full float32: TF32 is off; every
   float32 kernel's products in 3xTF32 on the tensor cores, kernels 1-f32,
   3-f32, 4-f32 and 5-f32 on one forward body of `csrc/attention_f32_tc.cuh`,
   2-f32 on its dQ and dK/dV bodies), each line with its error as
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
   timed outside the totals (F32_TILE_FUSED, F32_TILE_BWD, F32_TILE_FWD):
   kernel 4-f32's 64-row q tile at head dim 160, kernel 2-f32's wide dK/dV
   walk at KV 77 and its split walk at batch 1, kernel 1-f32 at head dim 256
   (and 3-f32 equal to it there).
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
   the first layout (2 boxes), 512x512, `--single-steps` DDIM steps (default
   10: cut from 50 for phase 16's time), random weights from
   seed 0 at full width: `lmd_plus` and `gligen` on the SD1.4+GLIGEN bundle
   (LMD+ with the CoarseSegmenter), then `lmd` (with SAM ViT-B), `sd` and
   `backward_guidance` on the SD1.5 bundle; each bundle is built once for
   its methods and freed after. Checks each image and, for LMD and LMD+, the
   frozen mask as phases 3 and 4 do, the launches of every kernel against
   what the dispatch, the schedule and the recorded guidance iterations
   imply, and that every shape the flash and SAM wrappers were given is one
   that phase 2 checked.
7. Baselines and solvers: on one SD1.5 bundle (random weights, seed 0, full
   width, 512x512, `--baseline-steps` steps, default 10) and the first
   layout, `boxdiff` at its
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
   checked.
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
   `--ckpt-steps` DDIM steps (default 10), with phase 6's checks (images,
   masks, launches, every wrapper shape one phase 2 checked). Each bundle is
   freed before the next.
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
11. The SDXL refiner (stabilityai/stable-diffusion-xl-refiner-1.0 at full
   width: the 2.26B-parameter text_time UNet, head dim 64, and the OpenCLIP
   bigG tower). (a) Its fp16 checkpoint (UNet, bigG in text_encoder_2/, VAE;
   3.04B values, ~6.1 GB) fabricated at the published keys and shapes,
   validated, loaded by `load_bundle` in bf16 and held bit for bit against
   the files (load wall, GB/s of file, peak memory). (b)
   `lmdx_torch.cli.generate.main` with `--run-model lmd_plus --sdxl` on the
   first two demo layouts (3 boxes and 1), `--cli-steps` DDIM steps of LMD+
   on random SD1.4+GLIGEN weights, with LMDX_CHECKPOINT_DIR pointing at (a)'s
   directory and LMDX_ALLOW_WORD_TOKENIZER=1, set for this phase only: each
   image upscaled to 1024x1024 (LANCZOS) and refined by img2img at strength
   0.3 (15 Euler steps of 50, CFG 5, aesthetic-score ids). Checks: each
   img_0.png is 1024x1024x3 uint8, not constant, and not the LANCZOS upscale
   of the method's 512x512 image; each refinement launches kernel 1 exactly
   15 x 44 = 660 times (the 20 + 20 + 4 self-attentions of a UNet call,
   B*H 24 at 4096 tokens and 48 at 1024 and 256, all at head dim 64) and
   nothing else; the d-64 shapes are exactly phase 2's refiner shapes and
   every wrapper shape one phase 2 checked. Prints the refine wall per image
   apart from the LMD+ wall and the refiner's load, and the peak memory.
12. SD2.1 base (`--use-sdv2`) and the SDXL base as the refiner, through
   `lmdx_torch.cli.generate.main` on the first two demo layouts (3 boxes and
   1) with a fabricated SAM ViT-B, `--cli-steps` DDIM steps, LMDX_CHECKPOINT_DIR,
   LMDX_ALLOW_WORD_TOKENIZER and LMDX_REFINER_MODEL set for this phase only.
   (a) stabilityai/stable-diffusion-2-1-base fabricated in fp16 (1.29B
   values, ~2.6 GB: the 866M-parameter UNet, OpenCLIP ViT-H, the VAE),
   validated, loaded in bf16 and held bit for bit (load wall, GB/s of file,
   peak memory). (c) `--use-sdv2 --run-model lmd --use_autocast 0` on it:
   `_drive`'s checks (images, exact launches of kernels 1-f32 and 2-f32 as
   the schedule and the guidance iterations imply, no bf16 flash launch,
   SAM's), each img_0.png the method's image, every flash shape at head dim
   64 with its level's heads (5, 10, 20) and the forward's exactly phase 2's
   SD2.1 set, TF32 off; then the tree is deleted. (d)
   stabilityai/stable-diffusion-xl-base-1.0 fabricated in fp16 (3.47B
   values, ~6.9 GB: the 2.57B-parameter UNet, CLIP ViT-L in text_encoder/
   and bigG in text_encoder_2/), validated, loaded and held bit for bit. (b)
   and (d) in one run: `--use-sdv2 --run-model lmd --sdxl` in bf16 with
   LMDX_REFINER_MODEL naming the SDXL base (SD2.1 on random weights; the
   checkpoint root then holds only the SDXL base): (c)'s checks on kernels 1
   and 2, and each image upscaled to 1024x1024 and refined by img2img at
   strength 0.3 (15 DDIM steps of 50, CFG 5, the base's 6 time ids, the
   2048-wide concat of both towers' states). Each refinement must launch
   kernel 1 exactly 15 x 70 = 1050 times (the 4 + 20 + 30 + 6 + 10
   self-attentions of a UNet call, B*H 20 at 4096 tokens and 40 at 1024)
   and nothing else, at exactly phase 2's SDXL base shapes; each img_0.png
   is 1024x1024x3 uint8 and not the LANCZOS upscale.
13. The CLI's opt-in kernels: `lmdx_torch.cli.generate.main` with
   LMDX_PACKED_ATTENTION, LMDX_FUSED_HEADS and LMDX_PALLAS_GROUPNORM set to
   "1" for this phase only, `--run-model lmd_plus --image-batch-size 2` on
   the first two demo layouts (3 boxes and 1: the per-box pass at UNet
   batch 8, as in phase 5), bf16, `--cli-steps` DDIM steps. The launches of
   kernels 3, 4, 2 and 6 must be what phase 5's per-step counts give at
   this depth and the recorded guidance iterations (`_optin_expect`), the
   per-head forward's 0; every opt-in wrapper shape one phase 2 checked.
14. The webui (`lmdx_torch.webui.server`) serving the default bundle
   (SD1.4+GLIGEN, random weights) on an ephemeral port in a thread, from a
   layout cache of the demo prompts in a temporary directory: GET / lists
   the registry; POSTs of `lmd_plus` (3 boxes) and `lmd` (2 boxes) at
   `--webui-steps` DDIM steps (default 10), each with `_drive`'s checks and
   the launches
   phase 6's plan implies, and each page's image equal bit for bit to
   `get_method(m).run` on the same spec and seed. Then SAM ViT-B (random
   weights) on host images: a grayscale and an RGBA image (one chunk of 2)
   and four sizes in one batch (resized to 1024x1024 with PIL's bilinear
   filter), box-prompted: the masks and IoU of the same pixels converted by
   hand and handed in as CUDA tensors, 12 launches of kernel 5 a chunk.
15. Training: the GLIGEN adapter step (`lmdx_torch.training`) on the
   full-width SD1.4+GLIGEN UNet (random weights, seed 0, the fusers' gates
   opened to 0.7 / -0.4), float32 parameters and AdamW state (lr 1e-4, the
   adapter mask), batch 2 at 512x512: SPECS' prompts through CLIP, their
   boxes' grounding tokens through PositionNet, seeded latents and noise.
   (a) 3 float32 steps (kernels 1-f32, 2-f32; TF32, turned on just before,
   is off once the step is built); (b) 5 bf16 steps from the same weights
   (kernels 1, 2). Every loss finite; the first bf16 loss within 2e-2 of the
   first float32 one, and each adapter tensor's first bf16 gradient (the 32
   scalar gates as one vector) within 0.1 of its float32 one (||g16 - g32|| /
   ||g32||); frozen
   parameters bit for bit unchanged,
   every adapter parameter changed; each step 30 forward launches (15
   self-attentions and 15 fusers at >= 256 tokens) and 29 backward ones
   (all but the first self-attention, before the first trained parameter);
   every shape one phase 2 checked. (c) `checkpoint.save`, a step,
   `restore`: bit for bit. (d) one step under `utils.trace.trace` with
   `annotate("train_step")`: the Chrome trace holds the span and both
   kernels' events. Each mode's step wall and peak memory are printed.
16. The dist slice (`lmdx_torch/dist/`; `phase_dist`). (a) In this process,
   one rank over NCCL: the CLI's batched LMD+ on the first two demo prompts
   at `--cli-steps`, with `--mesh auto` (a 1x1 mesh on one card) and without:
   the PNGs equal bit for bit, the `mesh:` line printed. (b) Two child
   processes on the one card over an explicitly named gloo group (NCCL
   refuses two ranks on one device; torch's gloo takes the CUDA tensors and
   copies them through the host), each with SD1.4+GLIGEN (random weights, seed 0): dp 2 LMD+ on
   SPECS at `--dist-steps` (each rank its layout; `_drive`'s checks; each
   rank's image equal bit for bit to a one-process run of its layout, the
   gap to the batch-2 run printed); tp 2 (4 of the 8 heads a rank): one UNet
   forward and latent gradient within 5e-2 of max|whole| (float32: 1e-3),
   then LMD+ on SPECS at `--dist-tp-steps` with `_drive`'s checks (the gap to
   tp 1 printed); dp-2 bf16 training, 3 steps at batch 1 a rank (30 forward
   and 29 backward launches a step), the first loss within 2e-2 of the
   one-process step at batch 2, and the checkpoint round trip bit for bit.
   The ranks report their launches and wrapper shapes: kernels 1 and 2 (and
   1-f32, 2-f32) must have run at the split head count, and every shape
   must be one phase 2 checked (phase 2 holds SD1.x's levels at 4 heads for
   it).

Matmuls and convolutions run in bf16 (phase 9 (a), phase 10 and phase 15 (a):
float32); TF32 is turned off for both (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32), so the plain versions' f32 products are full
f32.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
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


# Head dims the attention kernels are instantiated for and the paths use
# (40 -> 48 for the bf16 kernels and the float32 backward, 40 for the float32
# forward; 64, 80, 160): none of their kernels may spill.
PATH_HEAD_DIMS = ("40", "48", "64", "80", "160")
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
# The training cell's backward (benchmark `train.sd14_gligen_bf16.b16`):
# batch 16, KV = L and the fuser's L + 30, at each level.
TRAIN_BWD_CASES = [(16, 0), (16, 30)]
# (heads, tokens, head_dim) of SD1.x's attention levels at 512x512.
FLASH_LEVELS = ((8, 4096, 40), (8, 1024, 80), (8, 256, 160))
# SD2.1 base's levels at 512x512 (phase 12): head dim 64 at 5, 10 and 20 heads.
SD21_LEVELS = ((5, 4096, 64), (10, 1024, 64), (20, 256, 64))
# (batch, Lk - L) of phase 12's LMD on SD2.1 (bf16 and float32 alike): the
# single-image LMD of a 3-box and a 1-box layout gives the forward its
# per-box passes (batch 6 and 2), per-box guidance (3 and 1), overall pass
# (2) and overall guidance (1), and the backward the guidance batches; no
# fuser.
SD21_FWD_CASES = [(6, 0), (3, 0), (2, 0), (1, 0)]
SD21_BWD_CASES = [(3, 0), (1, 0)]
# (batch, heads, tokens) of the SDXL refiner's self-attention at head dim 64
# (phase 11): CFG batch 2; 12 heads at the 4096-token level, 24 at the
# 1024-token level and the 256-token mid block. KV = L (no fuser).
REFINER_FWD_CASES = ((2, 12, 4096), (2, 24, 1024), (2, 24, 256))
REFINER_HEAD_DIM = 64
# The SDXL base's self-attention as the --sdxl refiner (phase 12 (d)): CFG
# batch 2; 10 heads at 4096 tokens, 20 at 1024 (the mid block's too). KV = L.
SDXL_BASE_FWD_CASES = ((2, 10, 4096), (2, 20, 1024))
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


# Phase 16's tensor split at tp 2: SD1.x's levels at 4 of their 8 heads (B*H
# halved). (batch, Lk - L): the tp LMD+ run on SPECS (per-box pass 8, overall
# pass 4, guidance 2) and the UNet check (forward 2, gradient 1); the float32
# check's forward at 2 and gradient at 1.
SPLIT_LEVELS = tuple((h // 2, L, d) for h, L, d in FLASH_LEVELS)
SPLIT_FWD_CASES = [(b, extra) for b in (8, 4, 2, 1) for extra in (0, 30)]
SPLIT_BWD_CASES = [(2, 0), (2, 30), (1, 0), (1, 30)]
SPLIT_F32_FWD_CASES = [(2, 0), (2, 30), (1, 0), (1, 30)]
SPLIT_F32_BWD_CASES = [(1, 0), (1, 30)]

# The opt-in path runs on SD1.x's UNets: 8 heads at every level.
OPTIN_HEADS = 8
# (Lq, Lk, head_dim) of the backward calls only the opt-in path makes, at
# OPTIN_HEADS.
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


def _check_fwd(fwd, b, heads, L, lk, d, reps):
    """Holds the bf16 flash forward against its plain version at one shape
    and times it, its plain version and SDPA's flash forward op; returns
    (ms, plain ms, bound ms, library ms)."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa

    sdpa = torch.ops.aten._scaled_dot_product_flash_attention
    q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    e_o, ok_o = _err(o, o_ref)
    e_l = (lse - lse_ref).abs().max().item()
    if not (ok_o and e_l <= TOL_LSE):
        fail(f"forward disagrees at B={b} h={heads} L={L} Lk={lk} d={d}: |dO|={e_o} "
             f"|dLSE|={e_l}")
    bh = b * heads
    flops = 4 * bh * L * lk * d
    nbytes = 2 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
    bound = _bound(fwd, flops, nbytes)
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
    plain = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v), reps)
    lib = _library_ms(fwd, "forward", lambda: sdpa(
        q, k, v, 0.0, False, False, scale=d ** -0.5), reps)
    _add(fwd, ms, plain, bound, lib, e_o)
    log(f"  fwd B={b} h={heads} Lq={L} Lk={lk} d={d}: "
        f"{_fmt(ms, plain, lib, bound, flops)} err O {e_o:.2e} LSE {e_l:.2e} "
        f"(of max|plain| {_share(o, o_ref):.1e})")
    del q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return ms, plain, bound, lib


def _log_sums(what: str, before: dict, after: dict) -> None:
    """The times a group of shapes added to a kernel's totals."""
    d = {k: after[k] - before[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    log(f"  {what}: {d['ms']:.4f} ms (plain {d['plain_ms']:.3f}, bound {d['bound_ms']:.4f}, "
        f"library {d['library_ms']:.4f})")


def phase_kernels():
    fwd, bwd = _totals(), _totals()
    for heads, L, d in FLASH_LEVELS:
        reps = 5 if L == 4096 else 20
        for b, extra in FWD_CASES:
            _check_fwd(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps)
    # Head dim 64, which no SD1.x UNet has: the SDXL refiner's self-attention
    # (phase 11), the SDXL base's (phase 12 (d)) and SD2.1's LMD (phase 12
    # (b)); each group's sums are printed apart and count in the totals.
    before = dict(fwd)
    for b, h, L in REFINER_FWD_CASES:
        _check_fwd(fwd, b, h, L, L, REFINER_HEAD_DIM, 10 if L == 4096 else 20)
    _log_sums(f"fwd at d {REFINER_HEAD_DIM} (the refiner's {len(REFINER_FWD_CASES)} shapes)",
              before, fwd)
    before = dict(fwd)
    for b, h, L in SDXL_BASE_FWD_CASES:
        _check_fwd(fwd, b, h, L, L, REFINER_HEAD_DIM, 10 if L == 4096 else 20)
    _log_sums(f"fwd at d {REFINER_HEAD_DIM} (the SDXL base's {len(SDXL_BASE_FWD_CASES)} "
              f"shapes)", before, fwd)
    before_f, before_b = dict(fwd), dict(bwd)
    for heads, L, d in SD21_LEVELS:
        reps = 5 if L == 4096 else 20
        for b, extra in SD21_FWD_CASES:
            _check_fwd(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in SD21_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps)
    n = len(SD21_LEVELS)
    _log_sums(f"fwd at d 64 (SD2.1's {n * len(SD21_FWD_CASES)} shapes)", before_f, fwd)
    _log_sums(f"bwd at d 64 (SD2.1's {n * len(SD21_BWD_CASES)} shapes)", before_b, bwd)
    # Phase 16's tp 2: SD1.x's levels at half the heads.
    before_f, before_b = dict(fwd), dict(bwd)
    for heads, L, d in SPLIT_LEVELS:
        reps = 5 if L == 4096 else 20
        for b, extra in SPLIT_FWD_CASES:
            _check_fwd(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in SPLIT_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps)
    n = len(SPLIT_LEVELS)
    _log_sums(f"fwd at tp 2 ({n * len(SPLIT_FWD_CASES)} shapes at half the heads)",
              before_f, fwd)
    _log_sums(f"bwd at tp 2 ({n * len(SPLIT_BWD_CASES)} shapes at half the heads)",
              before_b, bwd)
    # The training cell's batch 16 (phase 15 runs batch 2); its sums apart
    # and in the totals.
    before_b = dict(bwd)
    for heads, L, d in FLASH_LEVELS:
        for b, extra in TRAIN_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, 3 if L == 4096 else 10)
    _log_sums(f"bwd at the training batch ({len(FLASH_LEVELS) * len(TRAIN_BWD_CASES)} "
              f"shapes)", before_b, bwd)
    default_ms = bwd["ms"]
    # The fused-heads gradient (phase 5) splits heads and calls the backward at
    # the KV lengths the default dispatch keeps on plain math: the 77-token
    # cross-attention of every level and the 64-token mid block (KV 64, and 94
    # with the fuser), at the guidance batch.
    for L, lk, d in BWD_SHORT_KV:
        _check_bwd(bwd, 2, OPTIN_HEADS, L, lk, d, 20)
    log(f"  bwd: {default_ms:.3f} ms over the {3 * len(BWD_CASES)} + "
        f"{len(SD21_LEVELS) * len(SD21_BWD_CASES)} + "
        f"{len(SPLIT_LEVELS) * len(SPLIT_BWD_CASES)} + "
        f"{len(FLASH_LEVELS) * len(TRAIN_BWD_CASES)} shapes of the default paths, "
        f"{bwd['ms'] - default_ms:.3f} ms over the {len(BWD_SHORT_KV)} short-KV "
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


def _f32_fwd_case(fwd, b, heads, L, lk, d, reps):
    """Kernel 1-f32 against its plain version at one shape (O within 1e-4 *
    max|plain|, the LSE within 1e-4), with times and the library call (SDPA
    at float32), its totals added to `fwd`."""
    import torch
    import torch.nn.functional as F

    from lmdx_torch.nn.kernels import flash_attention as fa

    q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.attention_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    e_o, ok_o = _err(o, o_ref, TOL_F32)
    e_l = (lse - lse_ref).abs().max().item()
    if not (ok_o and e_l <= TOL_LSE_F32):
        fail(f"forward f32 disagrees at B={b} L={L} Lk={lk} d={d}: |dO|={e_o} |dLSE|={e_l}")
    share = _share(o, o_ref)
    del o_ref, lse_ref
    bh = b * heads
    flops = 4 * bh * L * lk * d
    nbytes = 4 * bh * d * (2 * L + 2 * lk) + 4 * bh * L
    bound = _bound(fwd, flops, nbytes, PEAK_TF32X3_FLOPS)
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), reps)
    plain = cuda_ms(lambda: fa.attention_fwd_plain(q, k, v), reps)
    torch.cuda.empty_cache()
    lib = _library_ms(fwd, "forward f32", lambda: F.scaled_dot_product_attention(q, k, v), reps)
    _add(fwd, ms, plain, bound, lib, e_o)
    groups = fa.f32_tc_fwd_kv_groups(1, bh, L, lk, d)
    log(f"  fwd f32 B={b} h={heads} Lq={L} Lk={lk} d={d} [q tile {32 if L <= 256 else 64} "
        f"rows, {groups} KV group{'s' if groups > 1 else ''}]: "
        f"{_fmt(ms, plain, lib, bound, flops, True)} err O {e_o:.2e} "
        f"({share:.1e} of max|plain|) LSE {e_l:.2e}")
    del q, k, v, o, lse
    torch.cuda.empty_cache()


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

    f32 = torch.float32
    fwd, bwd, sam = _totals(), _totals(), _totals()
    log(f"  float32 kernels: bound = operations at 3xTF32's rate "
        f"({PEAK_TF32X3_FLOPS / 1e12:.0f} TFLOP/s; the float32 FMA peak is "
        f"{PEAK_F32_FLOPS / 1e12:.0f}) or bytes at {PEAK_BYTES / 1e12:.2f} TB/s, "
        f"the larger; tolerance {TOL_F32} * max|plain|, LSE {TOL_LSE_F32}")
    for heads, L, d in FLASH_LEVELS:
        reps = 3 if L == 4096 else 20
        for b, extra in F32_FWD_CASES:
            _f32_fwd_case(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in F32_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps, dtype=f32)
    # SD2.1's float32 LMD (phase 12 (c)) at head dim 64.
    before_f, before_b = dict(fwd), dict(bwd)
    for heads, L, d in SD21_LEVELS:
        reps = 3 if L == 4096 else 20
        for b, extra in SD21_FWD_CASES:
            _f32_fwd_case(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in SD21_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps, dtype=f32)
    n = len(SD21_LEVELS)
    _log_sums(f"fwd f32 at d 64 (SD2.1's {n * len(SD21_FWD_CASES)} shapes)", before_f, fwd)
    _log_sums(f"bwd f32 at d 64 (SD2.1's {n * len(SD21_BWD_CASES)} shapes)", before_b, bwd)
    # Phase 16's float32 UNet check at tp 2.
    before_f, before_b = dict(fwd), dict(bwd)
    for heads, L, d in SPLIT_LEVELS:
        reps = 3 if L == 4096 else 20
        for b, extra in SPLIT_F32_FWD_CASES:
            _f32_fwd_case(fwd, b, heads, L, L + extra, d, reps)
        for b, extra in SPLIT_F32_BWD_CASES:
            _check_bwd(bwd, b, heads, L, L + extra, d, reps, dtype=f32)
    n = len(SPLIT_LEVELS)
    _log_sums(f"fwd f32 at tp 2 ({n * len(SPLIT_F32_FWD_CASES)} shapes)", before_f, fwd)
    _log_sums(f"bwd f32 at tp 2 ({n * len(SPLIT_F32_BWD_CASES)} shapes)", before_b, bwd)

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

    heads = OPTIN_HEADS
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
F32_OPTIN_BWD = [(L, L + e, d) for _, L, d in FLASH_LEVELS for e in (0, 30)] + BWD_SHORT_KV
# The tensor-core kernels' tiles no path shape reaches, (batch, Lq, Lk,
# heads * d) and (batch, Lq, Lk, d): the 64-row q tile at head dim 160; the
# wide dK/dV walk at KV 77 (batch 17: 3 x 136 wide blocks) and the split one
# at batch 1.
F32_TILE_FUSED = [(2, 257, 286, 1280), (2, 320, 77, 1280)]
F32_TILE_BWD = [(17, 64, 77, 160), (1, 4096, 77, 40), (1, 64, 94, 160)]
# Kernel 1-f32 (and 3-f32, which must equal it) at head dim 256, which
# lmdx_flash_fwd_f32 accepts and no path gives: (batch, Lq, Lk, d).
F32_TILE_FWD = [(1, 256, 286, 256)]


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

    heads, f32 = OPTIN_HEADS, torch.float32
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
    for b, L, lk, d in F32_TILE_FWD:
        _f32_fwd_case(tiles, b, heads, L, lk, d, 20)
        q, k, v, _ = _inputs(b, heads, L, lk, d, seed=L + lk + b + 3, dtype=f32)
        if not all(torch.equal(x, y) for x, y in zip(fa.flash_attention_fwd_packed(q, k, v),
                                                     fa.flash_attention_fwd(q, k, v))):
            fail(f"packed forward f32 differs from kernel 1-f32 at B={b} L={L} Lk={lk} d={d}")
        log(f"  packed f32 B={b} h={heads} Lq={L} Lk={lk} d={d}: equal to kernel 1-f32 bit for "
            f"bit")
        del q, k, v
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
        seen["packed"].add((q.shape[0], q.shape[1], q.shape[2], k.shape[2] - q.shape[2],
                            _dtype_name(q)))
        return originals[0](q, k, v)

    def fused(qf, kf, vf, heads):
        seen["fused"].add((qf.shape[0], heads, qf.shape[1], kf.shape[1], qf.shape[2],
                           _dtype_name(qf)))
        return originals[1](qf, kf, vf, heads)

    def bwd(q, k, v, *rest):
        seen["bwd"].add((q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3],
                         _dtype_name(q)))
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
    wrappers to at `dtype_name`, as `_recording_optin_shapes` records them:
    (batch, heads, shape..., dtype)."""
    b_all, h = OPTIN_BATCHES, OPTIN_HEADS
    if dtype_name == "float32":
        packed = {(b, h, L, e) for L, _ in F32_PACKED_LEVELS for e in (0, 30) for b in b_all}
        fused = {(b, h, *c) for c in F32_FUSED_CASES for b in b_all}
        bwd = ({(2, h, *c) for c in F32_OPTIN_BWD}
               | {(b, lh, L, L + e, d) for lh, L, d in FLASH_LEVELS for b, e in F32_BWD_CASES})
    else:
        packed = {(b, h, L, e) for L, e in PACKED_CASES for b in b_all}
        fused = {(b, h, *c) for c in FUSED_CASES for b in b_all}
        bwd = ({(2, h, *c) for c in BWD_SHORT_KV}
               | {(b, lh, L, L + e, d) for lh, L, d in FLASH_LEVELS for b, e in BWD_CASES})
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


def _unet_probe(bundle, grad_batch: int = 1):
    """One UNet forward (batch 2, GLIGEN on) and the gradient of the guidance
    taps' sum of squares w.r.t. the latents (the first `grad_batch` rows),
    on seeded inputs: (eps, gradient)."""
    import torch

    from lmdx_torch.nn.unet import apply_unet
    from lmdx_torch.sampling.guidance import GuidanceSpec, default_guidance_keys

    cfg = bundle.config
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    lat = randn(2, cfg.latent_height, cfg.latent_width, 4)
    ctx = randn(2, cfg.clip.max_length, cfg.unet.cross_attention_dim)
    objs = randn(2, cfg.unet.gligen_max_objs, cfg.unet.cross_attention_dim)
    spec = GuidanceSpec(keys=default_guidance_keys(cfg.unet)).tap_spec
    with torch.no_grad():
        eps = apply_unet(bundle.unet, lat, 501, ctx, objs=objs)[0]
    x = lat[:grad_batch].clone().requires_grad_(True)
    taps = apply_unet(bundle.unet, x, 501, ctx[:grad_batch], objs=objs[:grad_batch],
                      taps=spec, stop_after_taps=True)[1]
    loss = sum(t.float().square().sum() for t in taps.values())
    return eps, torch.autograd.grad(loss, x)[0]


def _hold(label, what, got, want, tol):
    """max|got - want| <= tol * max|want|, both finite; returns the share."""
    import torch

    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{label}: non-finite {what}")
    diff, ok = _err(got, want, tol)
    ref = want.abs().max().item()
    log(f"{label}: {what}: max|diff| {diff:.3e} = {diff / ref:.3e} of max|reference| "
        f"{ref:.3e} (limit {tol:g})")
    if not ok:
        fail(f"{label}: {what} differs by {diff / ref:.3e} of max|reference|")
    return diff / ref


def _optin_unet_check(on, off, tol, label):
    """One UNet forward and one gradient of the guidance taps w.r.t. the
    latents, options on against options off, on the same weights and inputs
    (batch 2, GLIGEN on): max|on - off| <= tol * max|off| for each. Also
    holds every shape the opt-in wrappers are given against the tables phase
    2 checked at the bundles' dtype."""
    import torch

    cfg = on.config
    with _recording_optin_shapes() as seen:
        eps_on, grad_on = _unet_probe(on, 2)
    eps_off, grad_off = _unet_probe(off, 2)
    torch.cuda.synchronize()
    _hold(label, "UNet eps, options on against off", eps_on, eps_off, tol)
    _hold(label, "UNet latent gradient, options on against off", grad_on, grad_off, tol)
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
    `_recording_shapes` records them: SD1.x's levels at 8 heads (and at 4,
    phase 16's tp 2), SD2.1's at 5, 10 and 20, the SDXL refiner's and the
    SDXL base's self-attention;
    the float32 backward also at batch 2, KV L and L + 30 (F32_OPTIN_BWD,
    which phase 2 checks for phase 10 and phase 15's training step gives)."""

    def flash(levels, cases, dtype):
        return {(b, h, L, L + e, d, dtype) for h, L, d in levels for b, e in cases}

    sdxl = {(b, h, L, L, REFINER_HEAD_DIM, "bfloat16")
            for b, h, L in REFINER_FWD_CASES + SDXL_BASE_FWD_CASES}
    sd21 = {dtype: (flash(SD21_LEVELS, SD21_FWD_CASES, dtype),
                    flash(SD21_LEVELS, SD21_BWD_CASES, dtype))
            for dtype in ("bfloat16", "float32")}
    split = (flash(SPLIT_LEVELS, SPLIT_FWD_CASES, "bfloat16")
             | flash(SPLIT_LEVELS, SPLIT_F32_FWD_CASES, "float32"),
             flash(SPLIT_LEVELS, SPLIT_BWD_CASES, "bfloat16")
             | flash(SPLIT_LEVELS, SPLIT_F32_BWD_CASES, "float32"))
    return {"fwd": (flash(FLASH_LEVELS, FWD_CASES, "bfloat16")
                    | flash(FLASH_LEVELS, F32_FWD_CASES, "float32") | sdxl
                    | sd21["bfloat16"][0] | sd21["float32"][0] | split[0]),
            "bwd": (flash(FLASH_LEVELS, BWD_CASES, "bfloat16")
                    | flash(FLASH_LEVELS, F32_BWD_CASES, "float32")
                    | {(2, OPTIN_HEADS, L, lk, d, "float32") for L, lk, d in F32_OPTIN_BWD}
                    | sd21["bfloat16"][1] | sd21["float32"][1] | split[1]),
            "sam": ({(bh, g * g, "bfloat16") for bh, g in SAM_CASES}
                    | {(bh, g * g, "float32") for bh, g in F32_SAM_CASES})}


SINGLE_BUNDLES = (
    ("gligen/diffusers-generation-text-box", ("lmd_plus", "gligen")),
    ("runwayml/stable-diffusion-v1-5", ("lmd", "sd", "backward_guidance")),
)
# backward_guidance's published ladder: 5 iterations a step over 10 steps.
BG_LADDER = ([5], 10)


def _single_plan(name, p):
    """(guidance ladders, sampling passes, GLIGEN beta) of the single-image
    method `name` at GroundedParams `p`."""
    return {
        "lmd_plus": ([(p.overall_max_iter, p.overall_max_index_step)], 2, 0.4),
        "lmd": ([(p.max_iter, p.max_index_step),
                 (p.overall_max_iter, p.overall_max_index_step)], 2, 0.0),
        "gligen": ([], 1, 0.4),
        "sd": ([], 1, 0.0),
        "backward_guidance": ([BG_LADDER], 1, 0.0)}[name]


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
    ladders, passes, beta = _single_plan(name, p)
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


def _require_checked_shapes(label, seen, required=("fwd", "bwd", "sam")):
    """Fails unless each `required` wrapper was given shapes, and every shape
    any wrapper was given is one phase 2 checked."""
    checked = _phase2_shapes()
    for what, shapes in seen.items():
        if (what in required and not shapes) or not shapes <= checked[what]:
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


SDXL_REFINER = "stabilityai/stable-diffusion-xl-refiner-1.0"
# Euler steps a refined image takes: the JAX side's img2img rule at strength
# 0.3 of 50 steps starts at step 35 of the grid.
REFINER_STEPS = 15


def _refiner_launches_per_call(cfg) -> int:
    """Kernel-1 launches of one refiner UNet call: every self-attention of the
    attention levels and the mid block (their KV >= 256 tokens); the 77-token
    cross-attentions stay plain math."""
    u = cfg.unet
    levels = len(u.block_out_channels)
    down = sum(u.layers_per_block * u.transformer_depth(i)
               for i, t in enumerate(u.down_block_types) if t.startswith("CrossAttn"))
    up = sum((u.layers_per_block + 1) * u.transformer_depth(levels - 1 - i)
             for i, t in enumerate(u.up_block_types) if t.startswith("CrossAttn"))
    return down + up + u.transformer_depth(levels - 1)


def _load_fabricated(label: str, key: str, root: str) -> str:
    """Fabricates `key` in fp16 under `root` at the published keys and
    shapes, validates it, loads it by `load_bundle` in bf16 on the card and
    holds every parameter bit for bit against the files; returns the
    checkpoint directory."""
    import torch

    from lmdx_torch.runtime import convert, fabricate, models

    t0 = time.perf_counter()
    n_params = fabricate.fabricate_model(key, root, torch.float16)
    ckpt = os.path.join(root, key.replace("/", "--"))
    size = _dir_bytes(ckpt)
    log(f"{label}: fabricated {key}: {n_params / 1e9:.3f}B params in fp16 "
        f"({size / 1e9:.3f} GB: {sorted(os.listdir(ckpt))}) in {time.perf_counter() - t0:.1f} s")
    report = convert.validate_checkpoint(key, ckpt)
    if any(v for r in report.values() for v in r.values()):
        fail(f"{label}: {key} does not match its manifests: {report}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = models.load_bundle(key, ckpt, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"{label}: {key} loaded from {size / 1e9:.3f} GB in {wall:.2f} s "
        f"({size / 1e9 / wall:.2f} GB/s of file), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    modules = {"unet": bundle.unet, "text": bundle.text_encoder, "vae": bundle.vae}
    if bundle.text_encoder_2 is not None:
        modules["text2"] = bundle.text_encoder_2
    n = _check_loaded(label, modules, convert.load_checkpoint(bundle.config, ckpt),
                      models.F32_PARAM_NAME_MARKERS)
    log(f"{label}: {n / 1e9:.3f}B loaded values ({', '.join(modules)}) equal the files' "
        f"tensors bit for bit")
    del bundle, modules
    torch.cuda.empty_cache()
    return ckpt


def _counting_refine(orig_refine, refined: list):
    """A stand-in for `sdxl_refine.refine` that appends, for each call, its
    wall (s), its launches by kernel and the shapes it gave the flash and
    SAM wrappers to `refined`."""
    import torch

    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa

    def refine(image, spec, **kw):
        before = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _recording_shapes() as shapes:
            out = orig_refine(image, spec, **kw)  # host numpy: synchronous
        wall = time.perf_counter() - t
        after = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
        refined.append((wall, {k: after[k] - before[k] for k in after}, shapes))
        return out

    return refine


def _check_refined(label, run_dir, small_images, refined, cfg, fwd_cases) -> int:
    """Each prompt directory's img_0.png is the refiner's (H, W, 3) uint8
    image, not constant and not the LANCZOS upscale of the stage-2 image;
    each refinement launched kernel 1 exactly REFINER_STEPS x the flash
    layers of the refiner's UNet call times, at exactly `fwd_cases` (batch,
    heads, tokens; head dim 64, KV = L), and nothing else. Returns the
    launches per refinement."""
    import numpy as np
    from PIL import Image

    if len(refined) != len(small_images):
        fail(f"{label}: {len(small_images)} stage-2 images, {len(refined)} refined")
    size = (cfg.height, cfg.width)
    for ind, small in enumerate(small_images):
        img = _read_png(os.path.join(run_dir, str(ind), "img_0.png"))
        if img.dtype.name != "uint8" or img.shape != (*size, 3) or img.std() == 0:
            fail(f"{label}: {run_dir}/{ind}/img_0.png is {img.dtype} {img.shape}, "
                 f"std {img.std()}")
        up = np.asarray(Image.fromarray(small).resize((cfg.width, cfg.height), Image.LANCZOS))
        diff = np.abs(img.astype(np.int16) - up.astype(np.int16))
        if diff.max() == 0:
            fail(f"{label}: image {ind} is the LANCZOS upscale, not refined")
        log(f"{label}: image {ind}: {img.shape} uint8, std {img.std():.1f}; against the "
            f"LANCZOS upscale of the {small.shape[0]}x{small.shape[1]} image: mean |diff| "
            f"{diff.mean():.1f}, max {diff.max()}")
    per_call = _refiner_launches_per_call(cfg)
    want = REFINER_STEPS * per_call
    shapes = {(b, h, L, L, REFINER_HEAD_DIM, "bfloat16") for b, h, L in fwd_cases}
    for i, (t, launches, seen) in enumerate(refined):
        others = {k: v for k, v in launches.items() if k != "flash_attention_fwd" and v}
        if launches["flash_attention_fwd"] != want or others:
            fail(f"{label}: refine {i} launched {launches} (want flash_attention_fwd {want} "
                 f"= {REFINER_STEPS} steps x {per_call}, nothing else)")
        if seen["fwd"] != shapes or seen["bwd"] or seen["sam"]:
            fail(f"{label}: refine {i} gave the wrappers {seen}; phase 2 checks "
                 f"{sorted(shapes)}")
        log(f"{label}: refine {i}: {t:.3f} s at {size[0]}x{size[1]}, kernel 1 {want} = "
            f"{REFINER_STEPS} steps x {per_call} launches at d {REFINER_HEAD_DIM}, shapes "
            f"{sorted(seen['fwd'])}")
    return want


def phase_sdxl(plus_steps: int):
    """Phase 11: the SDXL refiner. (a) Its fp16 checkpoint fabricated at the
    published keys and shapes, validated, loaded by `load_bundle` and held bit
    for bit against the files. (b) The stage-2 CLI with `--sdxl` on that
    checkpoint (LMDX_CHECKPOINT_DIR and LMDX_ALLOW_WORD_TOKENIZER set for this
    phase only): LMD+ on two demo layouts at `plus_steps` DDIM steps, each
    image refined at 1024x1024 by 15 Euler steps, CFG 5."""
    import torch

    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.methods import lmd_plus, sdxl_refine
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.text.cache import LayoutCache

    t_phase = time.perf_counter()
    cfg = SD_CONFIGS[SDXL_REFINER]()
    saved = {k: os.environ.pop(k, None)
             for k in ("LMDX_CHECKPOINT_DIR", "LMDX_ALLOW_WORD_TOKENIZER", "LMDX_REFINER_MODEL")}
    try:
        with tempfile.TemporaryDirectory(prefix="lmdx_sdxl_") as root:
            # (a) the checkpoint.
            os.environ["LMDX_ALLOW_WORD_TOKENIZER"] = "1"
            _load_fabricated("sdxl", SDXL_REFINER, root)

            # (b) the CLI with --sdxl on two demo layouts.
            cache_path = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
            cache = LayoutCache(cache_path)
            for prompt, response in zip(PROMPTS_DEMO, DEMO_RESPONSES):
                cache.add(prompt.strip().rstrip("."), response)
            os.environ["LMDX_CHECKPOINT_DIR"] = root
            plus_images, refined, loads = [], [], []
            orig_run, orig_refine = lmd_plus.run, sdxl_refine.refine
            orig_load = sdxl_refine.load_refiner_bundle

            def run_and_keep(*a, **kw):
                result = orig_run(*a, **kw)
                plus_images.append(result.image)
                return result

            def load_timed(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig_load(*a, **kw)
                torch.cuda.synchronize()
                loads.append(time.perf_counter() - t)
                return out

            save_dir = os.path.join(root, "out")
            argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--sdxl",
                    "--num_prompts", "2", "--cache-path", cache_path, "--save-dir", save_dir,
                    "--num_inference_steps", str(plus_steps), "--no-continue-on-error"]
            lmd_plus.run = run_and_keep
            sdxl_refine.refine = _counting_refine(orig_refine, refined)
            sdxl_refine.load_refiner_bundle = load_timed
            try:
                with _recording_shapes() as seen:
                    fa.reset_launch_counts()
                    sa.reset_launch_counts()
                    gn.reset_launch_counts()
                    torch.cuda.reset_peak_memory_stats()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _cli(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    launches = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
            finally:
                lmd_plus.run, sdxl_refine.refine = orig_run, orig_refine
                sdxl_refine.load_refiner_bundle = orig_load
                sdxl_refine._REFINER_CACHE.clear()
            peak = torch.cuda.max_memory_allocated() / 2**30

            run_dir = os.path.join(save_dir, "templatev0.1_lmd_plus_demo", "run0")
            if len(plus_images) != 2:
                fail(f"sdxl: {len(plus_images)} LMD+ images (want 2)")
            want = _check_refined("sdxl", run_dir, plus_images, refined, cfg, REFINER_FWD_CASES)
            walls = [t for t, _, _ in refined]
            log(f"sdxl: CLI --sdxl, 2 LMD+ images at {plus_steps} DDIM steps, each refined at "
                f"{cfg.height}x{cfg.width} by {REFINER_STEPS} Euler steps: wall {wall:.2f} s "
                f"(refiner load {sum(loads):.2f} s, refine per image "
                f"{', '.join(f'{t:.3f}' for t in walls)} s, LMD+ and the rest "
                f"{wall - sum(loads) - sum(walls):.2f} s), peak memory {peak:.2f} GiB")
            log(f"sdxl: launches of the phase {launches}; kernel 1 per refined image {want}")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    _require_checked_shapes("sdxl", seen, required=("fwd", "bwd"))
    log(f"sdxl: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


SD21 = "stabilityai/stable-diffusion-2-1-base"
SDXL_BASE = "stabilityai/stable-diffusion-xl-base-1.0"
# Kernel-1 launches of one SDXL base UNet call at 1024x1024: the self-
# attentions of 2 x 2 blocks (4096 tokens) and 2 x 10 (1024) going down, 3 x
# 10 and 3 x 2 coming up, and the mid block's 10; its level without
# attention and the 77-token cross-attentions launch nothing.
SDXL_BASE_LAUNCHES_PER_CALL = 70


def _require_sd21_shapes(label, seen, dtype_name, refiner_fwd=()):
    """Every flash shape of an SD2.1 run is at head dim 64 with its level's
    heads, in `dtype_name`: the forward's exactly phase 2's SD2.1 set (and
    the refiner's `refiner_fwd` cases, bf16), the backward's within it; SAM
    in bf16, as the CLI loads it."""
    fwd = ({(b, h, L, L + e, d, dtype_name) for h, L, d in SD21_LEVELS for b, e in SD21_FWD_CASES}
           | {(b, h, L, L, REFINER_HEAD_DIM, "bfloat16") for b, h, L in refiner_fwd})
    bwd = {(b, h, L, L + e, d, dtype_name) for h, L, d in SD21_LEVELS for b, e in SD21_BWD_CASES}
    if seen["fwd"] != fwd or not seen["bwd"] or not seen["bwd"] <= bwd:
        fail(f"{label}: flash shapes fwd {sorted(seen['fwd'])} bwd {sorted(seen['bwd'])}; "
             f"want fwd {sorted(fwd)} and bwd within {sorted(bwd)}")
    if not seen["sam"] or any(s[-1] != "bfloat16" for s in seen["sam"]):
        fail(f"{label}: SAM shapes {sorted(seen['sam'])}")
    _require_checked_shapes(label, seen)


def phase_sd21(steps: int):
    """Phase 12: SD2.1 base behind `--use-sdv2` and the SDXL base as the
    `--sdxl` refiner, through the stage-2 CLI in this process, with
    LMDX_CHECKPOINT_DIR, LMDX_ALLOW_WORD_TOKENIZER and LMDX_REFINER_MODEL set
    for this phase only, on two demo layouts (3 boxes and 1) with a
    fabricated SAM ViT-B at `steps` DDIM steps. (a) SD2.1 fabricated,
    loaded, held bit for bit; (c) `--use-sdv2 --run-model lmd
    --use_autocast 0` on it; (d) the SDXL base fabricated, loaded, held bit
    for bit; (b) and (d) in one run: `--use-sdv2 --run-model lmd --sdxl` in
    bf16 with LMDX_REFINER_MODEL naming the SDXL base (SD2.1 on random
    weights: the checkpoint root then holds only the SDXL base). Each
    fabricated tree is deleted when its step ends."""
    import torch

    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.methods import _grounded, sdxl_refine
    from lmdx_torch.methods import lmd as lmd_method
    from lmdx_torch.nn.sam import SamSegmenter, sam_vit_base
    from lmdx_torch.runtime import fabricate
    from lmdx_torch.text import parser
    from lmdx_torch.text.cache import LayoutCache

    t_phase = time.perf_counter()
    cfg, base_cfg = SD_CONFIGS[SD21](), SD_CONFIGS[SDXL_BASE]()
    per_call = _refiner_launches_per_call(base_cfg)
    if per_call != SDXL_BASE_LAUNCHES_PER_CALL:
        fail(f"sd21: the SDXL base's UNet has {per_call} flash layers, expected "
             f"{SDXL_BASE_LAUNCHES_PER_CALL}")
    saved = {k: os.environ.pop(k, None)
             for k in ("LMDX_CHECKPOINT_DIR", "LMDX_ALLOW_WORD_TOKENIZER", "LMDX_REFINER_MODEL")}
    n_prompts = 2
    all_launches = {}
    try:
        with tempfile.TemporaryDirectory(prefix="lmdx_sd21_") as work:
            cache_path = os.path.join(work, "cache_demo_v0.1_gpt-4.json")
            cache = LayoutCache(cache_path)
            boxes = []
            for prompt, response in zip(PROMPTS_DEMO, DEMO_RESPONSES):
                cache.add(prompt.strip().rstrip("."), response)
                boxes.append(len(parser.filter_boxes(
                    parser.parse_layout_response(response).gen_boxes)))
            fabricate.fabricate_sam(work, torch.float16)
            sam_dir = os.path.join(work, fabricate.SAM_KEY.replace("/", "--"))
            expected_sam = sum(sam_vit_base().encoder_layers * -(-n // SamSegmenter.CHUNK)
                               for n in boxes[:n_prompts])
            os.environ["LMDX_ALLOW_WORD_TOKENIZER"] = "1"
            p = _grounded.GroundedParams(num_inference_steps=steps)
            base_expect = _default_expect(
                cfg, steps, 0.0,
                [(p.max_iter, p.max_index_step),
                 (p.overall_max_iter, p.overall_max_index_step)] * n_prompts,
                expected_sam, passes=2 * n_prompts)
            results, refined = [], []
            orig_run, orig_refine = lmd_method.run, sdxl_refine.refine

            def run_and_keep(*a, **kw):
                results.append(orig_run(*a, **kw))
                return results[-1]

            def cli_lmd(label, f32, sdxl=False):
                """`--use-sdv2 --run-model lmd` through `_drive`: the launches
                as the schedule and the guidance iterations imply (every UNet
                attention on the float32 kernels under `f32`; with `sdxl`,
                kernel 1 also 15 x 70 times per refined image)."""
                results.clear()
                refined.clear()
                save_dir = os.path.join(work, label.replace(" ", "_"))
                argv = ["--prompt-type", "demo", "--run-model", "lmd", "--use-sdv2",
                        "--num_prompts", str(n_prompts), "--cache-path", cache_path,
                        "--save-dir", save_dir, "--sam-checkpoint", sam_dir,
                        "--num_inference_steps", str(steps), "--no-continue-on-error"]
                argv += (["--use_autocast", "0"] if f32 else []) + (["--sdxl"] if sdxl else [])

                def expect(iters):
                    want, ladder_max, note = base_expect(iters)
                    if f32:
                        want = {**want, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                                "flash_attention_fwd_f32": want["flash_attention_fwd"],
                                "flash_attention_bwd_f32": want["flash_attention_bwd"]}
                        note += "; every UNet attention on the float32 kernels"
                    if sdxl:
                        want["flash_attention_fwd"] += n_prompts * REFINER_STEPS * per_call
                        note += (f"; {n_prompts} refinements x {REFINER_STEPS} steps x "
                                 f"{per_call}")
                    return want, ladder_max, note

                lmd_method.run = run_and_keep
                sdxl_refine.refine = _counting_refine(orig_refine, refined)
                try:
                    with _recording_shapes() as seen:
                        _, launches = _drive(
                            label, lambda: (_cli(argv), list(results))[1], cfg, steps, expect,
                            n_passes=2 * n_prompts,
                            bwd_key="flash_attention_bwd_f32" if f32 else "flash_attention_bwd")
                finally:
                    lmd_method.run, sdxl_refine.refine = orig_run, orig_refine
                return launches, seen, os.path.join(save_dir, "templatev0.1_lmd_demo", "run0")

            # (a) and (c): float32 LMD on SD2.1's fabricated checkpoint.
            with tempfile.TemporaryDirectory(prefix="lmdx_sd21_ckpt_") as root:
                _load_fabricated("sd21", SD21, root)
                os.environ["LMDX_CHECKPOINT_DIR"] = root
                label = "sd21 lmd f32"
                launches, seen, run_dir = cli_lmd(label, True)
                _check_cli_images(label, run_dir, list(range(n_prompts)), cfg, results)
                _require_sd21_shapes(label, seen, "float32")
                if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
                    fail(f"{label}: TF32 is on after --use_autocast 0")
                all_launches[label] = launches
                os.environ.pop("LMDX_CHECKPOINT_DIR")
            log("sd21: the fabricated SD2.1 tree is deleted")

            # (d) the SDXL base, and (b) bf16 LMD with each image refined by it.
            with tempfile.TemporaryDirectory(prefix="lmdx_sdxl_base_") as root:
                _load_fabricated("sdxl base", SDXL_BASE, root)
                os.environ["LMDX_CHECKPOINT_DIR"] = root
                os.environ["LMDX_REFINER_MODEL"] = SDXL_BASE
                label = "sd21 lmd bf16 + sdxl base"
                try:
                    launches, seen, run_dir = cli_lmd(label, False, sdxl=True)
                finally:
                    for k in [k for k in sdxl_refine._REFINER_CACHE if k[0] == SDXL_BASE]:
                        del sdxl_refine._REFINER_CACHE[k]
                    os.environ.pop("LMDX_REFINER_MODEL")
                    os.environ.pop("LMDX_CHECKPOINT_DIR")
                if len(results) != n_prompts:
                    fail(f"{label}: {len(results)} LMD images (want {n_prompts})")
                _check_refined(label, run_dir, [r.image for r in results], refined, base_cfg,
                               SDXL_BASE_FWD_CASES)
                _require_sd21_shapes(label, seen, "bfloat16", SDXL_BASE_FWD_CASES)
                all_launches[label] = launches
            log("sd21: the fabricated SDXL base tree is deleted")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    torch.cuda.empty_cache()
    log(f"sd21: phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


# ---- phases 13-15: the CLI's opt-in kernels, the webui, training ------------

OPTIN_ENV = ("LMDX_PACKED_ATTENTION", "LMDX_FUSED_HEADS", "LMDX_PALLAS_GROUPNORM")


def phase_cli_optin(steps: int):
    """Phase 13: the stage-2 CLI with the JAX package's three opt-in variables
    set to "1" (for this phase only): bf16 LMD+ through the batched mode on
    the first two demo layouts (3 boxes and 1: the per-box pass at UNet batch
    8, as phase 5's two 2-box layouts), `steps` DDIM steps. Its launches of
    kernels 3, 4, 2 and 6 must be what phase 5's per-step counts give at this
    depth (`_optin_expect`), the per-head forward's 0, and every opt-in
    wrapper shape one phase 2 checked."""
    import types

    import torch

    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.sampling.guidance import default_guidance_keys, default_obj_attn_key
    from lmdx_torch.text.cache import LayoutCache

    t_phase = time.perf_counter()
    key = "gligen/diffusers-generation-text-box"
    cfg = SD_CONFIGS[key]()
    p = GroundedParams(num_inference_steps=steps)
    per_box_taps = (default_obj_attn_key(cfg.unet), *default_guidance_keys(cfg.unet))
    saved = {k: os.environ.get(k) for k in OPTIN_ENV}
    with tempfile.TemporaryDirectory(prefix="lmdx_cli_optin_") as root, \
            _recording_optin_shapes() as seen:
        cache_path = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
        cache = LayoutCache(cache_path)
        for prompt, response in zip(PROMPTS_DEMO, DEMO_RESPONSES):
            cache.add(prompt.strip().rstrip("."), response)
        argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--image-batch-size", "2",
                "--num_prompts", "2", "--cache-path", cache_path, "--save-dir", root,
                "--force_run_ind", "0", "--num_inference_steps", str(steps),
                "--no-continue-on-error"]
        run_dir = os.path.join(root, "templatev0.1_lmd_plus_demo", "run0")

        def run():
            _cli(argv)
            return [types.SimpleNamespace(image=_read_png(os.path.join(run_dir, str(i),
                                                                       "img_0.png")))
                    for i in range(2)]

        os.environ.update({k: "1" for k in OPTIN_ENV})
        try:
            _, launches = _drive(
                "cli optin", run, cfg, steps,
                _optin_expect(cfg, steps, 0.4, (p.overall_max_iter, p.overall_max_index_step),
                              per_box_taps))
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        _check_cli_images("cli optin", run_dir, [0, 1], cfg)
        _require_optin_shapes("cli optin", seen, "bfloat16")
    torch.cuda.empty_cache()
    log(f"cli optin: phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _page_image(body: str, heading: str = "Image"):
    """The PNG under `<h3>heading</h3>` of a webui page, decoded."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    marker = f'<h3>{heading}</h3><img src="data:image/png;base64,'
    if marker not in body:
        fail(f"webui: no {heading} image in the page: {body[-1500:]}")
    start = body.index(marker) + len(marker)
    with Image.open(io.BytesIO(base64.b64decode(body[start:body.index('"', start)]))) as im:
        return np.asarray(im)


WEBUI_METHODS = (("lmd_plus", 0), ("lmd", 2))  # (method, demo prompt): 3 boxes, 2 boxes


def phase_webui(steps: int):
    """Phase 14: the webui (`lmdx_torch.webui.server`) on the default bundle
    (SD1.4+GLIGEN, random weights, 512x512) on an ephemeral port in a
    thread, from a layout cache of the demo prompts in a temporary
    directory: GET / lists the registry, then two POSTs (`lmd_plus` on a
    3-box layout, `lmd` on a 2-box one, `steps` DDIM steps) each through
    `_drive` (images, launches as `_run_single`'s plan implies); each page's
    image must equal `get_method(m).run` on the same spec and seed, bit for
    bit. Then SAM's host inputs through a SamSegmenter (ViT-B, random weights,
    seed 0): a grayscale and an RGBA image (one chunk of 2) and a batch of 4
    sizes (one chunk of 4, resized to 1024x1024 with PIL's bilinear filter),
    box-prompted; each must give the masks and IoU of the same pixels
    converted by hand and handed in as CUDA tensors, and kernel 5 must launch
    12 times a chunk."""
    import argparse
    import threading
    import types
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from PIL import Image

    from lmdx_torch import methods
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.nn.sam import SamSegmenter
    from lmdx_torch.runtime import models
    from lmdx_torch.webui import server

    t_phase = time.perf_counter()
    prompts = [p.strip().rstrip(".") for p in PROMPTS_DEMO]  # typed without the period
    all_launches = {}
    with tempfile.TemporaryDirectory(prefix="lmdx_webui_") as root, \
            _recording_shapes() as seen:
        cache_path = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
        with open(cache_path, "w") as f:
            json.dump({p: [r] for p, r in zip(prompts, DEMO_RESPONSES)}, f)
        args = argparse.Namespace(host="127.0.0.1", port=0,
                                  sd_model="gligen/diffusers-generation-text-box",
                                  llm_model="gpt-4", cache_path=cache_path, steps=50, cpu=False)
        app = server.App(args)
        server.Handler.app = app
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.Handler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/", timeout=60) as r:
                page = r.read().decode()
            missing = [m for m in methods.METHODS if f'value="{m}"' not in page]
            if missing:
                fail(f"webui: the index page lacks {missing}")
            t0 = time.perf_counter()
            bundle = app.bundle()
            torch.cuda.synchronize()
            log(f"webui: serving {url}; bundle {args.sd_model} (random weights, seed 0) built "
                f"in {time.perf_counter() - t0:.1f} s")
            cfg = bundle.config
            p = GroundedParams(num_inference_steps=steps)
            for name, ind in WEBUI_METHODS:
                seed = 7 + ind
                form = urllib.parse.urlencode({"prompt": prompts[ind], "method": name,
                                               "seed": str(seed), "steps": str(steps)}).encode()

                def post(form=form):
                    with urllib.request.urlopen(url + "/generate", data=form, timeout=600) as r:
                        body = r.read().decode()
                    if "Error:" in body:
                        fail(f"webui {name}: the page reports an error: {body[-3000:]}")
                    return body

                pages = []

                def run(post=post, pages=pages):
                    pages.append(post())
                    return [types.SimpleNamespace(image=_page_image(pages[-1]))]

                ladders, passes, beta = _single_plan(name, p)
                _, launches = _drive(f"webui {name}", run, cfg, steps,
                                     _default_expect(cfg, steps, beta, ladders, 0, passes),
                                     n_passes=passes)
                all_launches[name] = launches
                got = _page_image(pages[0])
                gen_boxes, bg_prompt, neg_prompt = server.App(args).layout(prompts[ind])
                spec = {"prompt": prompts[ind], "gen_boxes": gen_boxes, "bg_prompt": bg_prompt,
                        "extra_neg_prompt": neg_prompt}
                want = methods.get_method(name).run(spec, bundle, bg_seed=seed,
                                                    num_inference_steps=steps).image
                if got.shape != want.shape or not (got == want).all():
                    diff = (np.abs(got.astype(np.int16) - want.astype(np.int16))
                            if got.shape == want.shape else None)
                    fail(f"webui {name}: the page's image differs from get_method({name!r}).run "
                         f"on the same spec and seed ({got.shape} vs {want.shape}; max "
                         f"|diff| {None if diff is None else diff.max()}, pixels "
                         f"{None if diff is None else int((diff > 0).sum())})")
                log(f"webui {name}: the page's {got.shape} image equals get_method({name!r}).run "
                    f"on the same spec and seed, bit for bit; {len(gen_boxes)} boxes")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        if thread.is_alive():
            fail("webui: the server thread did not stop")
        del bundle, app
        server.Handler.app = None
        torch.cuda.empty_cache()

        # SAM's host inputs, against the same pixels as CUDA tensors.
        segmenter = SamSegmenter(models.build_sam(seed=0, device="cuda"))
        size = segmenter.config.image_size
        rng = np.random.default_rng(14)
        base = [rng.integers(0, 255, (512, 512, 3), np.uint8) for _ in range(2)]
        gray = np.asarray(Image.fromarray(base[0]).convert("L"))
        rgba = np.concatenate([base[1], rng.integers(0, 255, (512, 512, 1), np.uint8)], -1)
        mixed = [base[0], np.asarray(Image.fromarray(base[1]).resize((640, 384))),
                 np.ascontiguousarray(base[1][:480, :320]),
                 np.asarray(Image.fromarray(base[0]).resize((256, 256)))]
        cases = (("grayscale + RGBA", [gray, rgba], False), ("mixed sizes", mixed, True))
        boxes = [[(0.1, 0.1, 0.6, 0.7)], [(0.3, 0.2, 0.9, 0.8)], [(0.0, 0.4, 0.5, 1.0)],
                 [(0.2, 0.0, 0.7, 0.5)]]
        sam_launches = {}
        for label, images, resize in cases:
            kw = {"input_boxes": boxes[:len(images)], "target_hw": (64, 64)}
            fa.reset_launch_counts()
            sa.reset_launch_counts()
            gn.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = segmenter.segment_batch(images, **kw)
            wall = time.perf_counter() - t0
            launches = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
            chunks = -(-len(images) // SamSegmenter.CHUNK)
            want_n = segmenter.config.encoder_layers * chunks
            if launches["sam_attention"] != want_n or any(
                    v for k, v in launches.items() if k != "sam_attention"):
                fail(f"webui sam {label}: launches {launches}, expected {want_n} of "
                     f"sam_attention and nothing else")
            sam_launches[label] = launches
            ref = []
            for im in images:
                pil = Image.fromarray(im).convert("RGB")
                if resize:
                    pil = pil.resize((size, size), Image.BILINEAR)
                ref.append(torch.from_numpy(np.array(pil, np.uint8)).cuda())
            want = segmenter.segment_batch(ref, **kw)
            for i, ((gm, gi), (wm, wi)) in enumerate(zip(got, want)):
                if gm.shape != (3, 64, 64) or not (gm == wm).all() or not (gi == wi).all():
                    fail(f"webui sam {label}: image {i}'s masks or IoU differ from the same "
                         f"pixels handed in as CUDA tensors (IoU {gi} vs {wi})")
            log(f"webui sam {label}: {[im.shape for im in images]} -> {len(got)} masks equal "
                f"to the hand-converted tensors' in {wall:.3f} s; launches {launches}; mask "
                f"areas {[int(m.sum()) for m, _ in got]}")
        all_launches["sam"] = {k: sum(v[k] for v in sam_launches.values())
                               for k in all_launches["lmd"]}
        del segmenter
        torch.cuda.empty_cache()
    _require_checked_shapes("webui", seen)
    log(f"webui: phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


TRAIN_BF16_STEPS = 5
TRAIN_F32_STEPS = 3
TOL_TRAIN_LOSS = 2e-2  # bf16 first-step loss against float32's, relative
TOL_TRAIN_GRAD = 0.1  # bf16 first-step gradient against float32's, each tensor's norm
TRAIN_GATES = (0.7, -0.4)  # tanh gates of the fusers (alpha_attn, alpha_dense)


def _train_batch(key: str, bundle=None):
    """Phase 15's batch on the full-width bundle's towers (random weights,
    seed 0; `bundle`, when given, is that bundle): SPECS' two prompts
    through CLIP, their boxes' grounding tokens through PositionNet (the
    conditional half of `make_gligen_inputs`), seeded 64x64x4 latents and
    noise, timesteps 100 and 700."""
    import torch

    from lmdx_torch.methods import base
    from lmdx_torch.runtime import models

    bundle = bundle or models.load_bundle(key, seed=0, device="cuda")
    text = models.encode_text(bundle, [s["prompt"] for s in SPECS])[0]
    objs = []
    for spec in SPECS:
        boxes = [(x / 512, y / 512, (x + w) / 512, (y + h) / 512)
                 for _, (x, y, w, h) in spec["gen_boxes"]]
        full, _ = base.make_gligen_inputs(bundle, boxes, [n for n, _ in spec["gen_boxes"]])
        objs.append(full[1:])
    h = bundle.config.latent_height
    del bundle
    gen = torch.Generator(device="cuda").manual_seed(15)
    batch = {"x0": torch.randn((len(SPECS), h, h, 4), generator=gen, device="cuda"),
             "noise": torch.randn((len(SPECS), h, h, 4), generator=gen, device="cuda"),
             "t": torch.tensor([100, 700], device="cuda"),
             "text_embeddings": text, "objs": torch.cat(objs).float()}
    if not all(bool(torch.isfinite(v.float()).all()) for v in batch.values()):
        fail("train: non-finite batch")
    log(f"train: batch {({k: tuple(v.shape) for k, v in batch.items()})}, objs |max| "
        f"{float(batch['objs'].abs().max()):.3f}")
    return batch


def _gated_train_unet(cfg, dtype_name):
    """Phase 15's trained UNet (float32 masters, random weights, seed 0,
    built for `dtype_name`, every fuser's gates opened to TRAIN_GATES) and
    its optimizer (AdamW at lr 1e-4 over the adapter mask)."""
    import dataclasses

    import torch

    from lmdx_torch.nn.attention import GatedSelfAttention
    from lmdx_torch.runtime import models
    from lmdx_torch.training import train

    unet = models.build_train_unet(dataclasses.replace(cfg, dtype=dtype_name), seed=0,
                                   device="cuda")
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, GatedSelfAttention):
                m.alpha_attn.fill_(TRAIN_GATES[0])
                m.alpha_dense.fill_(TRAIN_GATES[1])
    return unet, train.make_optimizer(1e-4, trainable_mask=train.gligen_adapter_mask(unet))


def phase_train():
    """Phase 15: the GLIGEN adapter training step (`lmdx_torch.training`) on the
    full-width SD1.4+GLIGEN UNet (random weights, seed 0, every fuser's gates
    opened to TRAIN_GATES), 512x512 latents at batch 2 (`_train_batch`), the
    adapter mask (the fusers train, the backbone is frozen), AdamW at lr
    1e-4. (a) TRAIN_F32_STEPS float32 steps on a UNet built for float32
    (kernels 1-f32 and 2-f32; TF32 is turned on before the step is built,
    which must turn it off); (b) TRAIN_BF16_STEPS bf16 steps on one built
    for bf16 from the same seed (float32 masters cast at each use; kernels 1
    and 2). Checks: every loss finite; the first bf16 loss within
    TOL_TRAIN_LOSS of the first float32 loss (same state and batch), each
    adapter tensor's first bf16 gradient (the scalar gates as one vector)
    within TOL_TRAIN_GRAD of the float32 one, relative to its norm; the
    frozen parameters bit for bit unchanged and every adapter parameter
    changed; the launches of each step exactly the dispatch's: a forward for
    each flash layer (the 15 self-attentions and 15 fusers at >= 256 tokens)
    and a backward for each but the first block's self-attention (its inputs
    need no gradient: the first trained parameter follows it); every shape
    one phase 2 checked. (c) `checkpoint.save` of the bf16 state, one more
    step, `restore`: parameters, moments and step bit for bit the saved ones.
    (d) One step under `utils.trace.trace` with `annotate("train_step")`: the
    trace file holds the span and both kernels' events. Prints each mode's
    step wall and peak memory."""
    import torch

    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.core.schedule import make_alphas_cumprod
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa
    from lmdx_torch.training import checkpoint, train
    from lmdx_torch.utils import trace as tracelib

    t_phase = time.perf_counter()
    key = "gligen/diffusers-generation-text-box"
    cfg = SD_CONFIGS[key]()
    alphas = make_alphas_cumprod()
    fwd_per_step = _expected_launches(cfg, 1, 1.0, [], passes=1)[0]
    bwd_per_step = fwd_per_step - 1
    all_launches, losses, walls, g32, g16 = {}, {}, {}, {}, {}
    with _recording_shapes() as seen:
        batch = _train_batch(key)

        def build(dtype_name):
            unet, opt = _gated_train_unet(cfg, dtype_name)
            if dtype_name == "float32":
                # The process runs with TF32 off; the float32 step must turn it
                # off itself.
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            step = train.make_train_step(unet, opt, alphas, objs_fn=lambda _, b: b["objs"])
            tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            if tf32 != (False, False):
                fail(f"train {dtype_name}: TF32 is on after make_train_step {tf32}")
            return unet, opt, step

        def run_steps(label, step, state, n, suffix, first_grads=None):
            fa.reset_launch_counts()
            sa.reset_launch_counts()
            gn.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            out, t_steps = [], []
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                torch.cuda.synchronize()
                t_steps.append(time.perf_counter() - t0)
                out.append(float(loss))
                if i == 0 and first_grads is not None:
                    # The first step's gradients, on the host, so that the
                    # steps' peak memory is the training's own.
                    first_grads.update({
                        name: p.grad.detach().float().cpu()
                        for name, p in state.params.named_parameters() if p.grad is not None})
            launches = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
            want = {k: 0 for k in launches}
            want[f"flash_attention_fwd{suffix}"] = n * fwd_per_step
            want[f"flash_attention_bwd{suffix}"] = n * bwd_per_step
            if not suffix:
                # The 4096- and 1024-token levels (head dims 40 and 80) take the
                # warpgroup-MMA backward; the 256-token level's third of the
                # layers (head dim 160) does not.
                want["flash_attention_bwd_sm90"] = n * (bwd_per_step - fwd_per_step // 3)
            if launches != want:
                fail(f"{label}: launches {launches}, expected {want} ({fwd_per_step} forwards "
                     f"and {bwd_per_step} backwards a step)")
            if not all(math.isfinite(x) for x in out):
                fail(f"{label}: non-finite loss {out}")
            log(f"{label}: {n} steps, losses {out}; step walls {[f'{t:.3f}' for t in t_steps]} "
                f"s (the first with the step's set-up), peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {want}")
            return state, out, t_steps, launches

        # (a) float32.
        t0 = time.perf_counter()
        unet, opt, step = build("float32")
        log(f"train f32: UNet built (float32 parameters, seed 0) in "
            f"{time.perf_counter() - t0:.1f} s")
        state = train.init_train_state(unet, opt)
        # `state` holds the UNet too: it must go before the bf16 steps, or
        # their peak memory counts the float32 state beside their own.
        state, losses["f32"], walls["f32"], all_launches["f32"] = run_steps(
            "train f32", step, state, TRAIN_F32_STEPS, "_f32", g32)
        del unet, opt, step, state
        torch.cuda.empty_cache()

        # (b) bf16 activations over float32 masters.
        t0 = time.perf_counter()
        unet, opt, step = build("bfloat16")
        mask = train.gligen_adapter_mask(unet)
        named = dict(unet.named_parameters())
        # On the host, so that the steps' peak memory is the training's own.
        before = {n: p.detach().cpu() for n, p in named.items()}
        n_adapter = sum(mask.values())
        log(f"train bf16: UNet built in {time.perf_counter() - t0:.1f} s; "
            f"{sum(p.numel() for n, p in named.items() if mask[n]) / 1e6:.1f}M adapter "
            f"parameters in {n_adapter} tensors, "
            f"{sum(p.numel() for n, p in named.items() if not mask[n]) / 1e6:.1f}M frozen")
        state = train.init_train_state(unet, opt)
        state, losses["bf16"], walls["bf16"], all_launches["bf16"] = run_steps(
            "train bf16", step, state, TRAIN_BF16_STEPS, "", g16)
        l16, l32 = losses["bf16"][0], losses["f32"][0]
        share = abs(l16 - l32) / abs(l32)
        if share > TOL_TRAIN_LOSS:
            fail(f"train: first bf16 loss {l16} vs float32 {l32}: {share:.2e} > "
                 f"{TOL_TRAIN_LOSS}")
        unchanged = [n for n, p in named.items()
                     if mask[n] and torch.equal(p.detach().cpu(), before[n])]
        moved = [n for n, p in named.items()
                 if not mask[n] and not torch.equal(p.detach().cpu(), before[n])]
        if unchanged or moved:
            fail(f"train bf16: adapter parameters unchanged {unchanged[:5]} ({len(unchanged)}), "
                 f"frozen parameters changed {moved[:5]} ({len(moved)})")
        if set(g16) != set(g32) or set(g16) != {n for n, on in mask.items() if on}:
            fail(f"train: first-step gradients of {len(g16)} bf16 / {len(g32)} float32 "
                 f"tensors, {n_adapter} adapter tensors")
        # Each tensor on its own, the scalar gates as one vector: a gate's
        # gradient sums its whole layer's products, which cancel, so bf16
        # moves a single one by up to half (scripts/torch_train_memory.py).
        gates = sorted(n for n, w in g32.items() if w.numel() == 1)
        g16["gates"], g32["gates"] = (torch.stack([g[n] for n in gates]) for g in (g16, g32))
        gaps = sorted(((float(torch.linalg.vector_norm(g16[n] - w) /
                              torch.linalg.vector_norm(w)), n)
                       for n, w in g32.items() if n not in gates), reverse=True)
        if not gaps[0][0] <= TOL_TRAIN_GRAD:
            fail(f"train: first-step bf16 gradients against float32's, ||g16 - g32|| / ||g32||:"
                 f" {gaps[:5]} > {TOL_TRAIN_GRAD}")
        del g16, g32
        log(f"train: first loss bf16 {l16} vs float32 {l32} ({share:.2e} of it, within "
            f"{TOL_TRAIN_LOSS}); first-step gradients ||g16 - g32|| / ||g32|| over "
            f"{len(gaps) - 1} tensors and the {len(gates)} gates as one: median "
            f"{gaps[len(gaps) // 2][0]:.3e}, largest {gaps[:3]}, the gates "
            f"{dict((n, g) for g, n in gaps)['gates']:.3e}, within {TOL_TRAIN_GRAD}; all "
            f"{n_adapter} adapter tensors changed, {len(named) - n_adapter} frozen ones bit "
            f"for bit unchanged")
        del before

        # (c) the checkpoint round trip.
        with tempfile.TemporaryDirectory(prefix="lmdx_train_ckpt_") as root:
            path = os.path.join(root, f"step_{state.step}")
            t0 = time.perf_counter()
            checkpoint.save(path, state)
            t_save = time.perf_counter() - t0
            nbytes = _dir_bytes(path)
            saved_params = {n: p.detach().clone() for n, p in named.items()}
            saved_moments = {n: {k: torch.as_tensor(v).clone() for k, v in
                                 state.opt_state.state[p].items()}
                             for n, p in named.items() if mask[n]}
            saved_step = state.step
            state, loss_after, _, launches = run_steps("train bf16 +1", step, state, 1, "")
            all_launches["bf16 +1"] = launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = checkpoint.restore(path, state)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            if checkpoint.latest_step_dir(root) != path:
                fail(f"train: latest_step_dir({root}) is not {path}")
        bad = [n for n, p in named.items() if not torch.equal(p, saved_params[n])]
        bad += [f"{n}.{k}" for n, m in saved_moments.items()
                for k, v in m.items() if not torch.equal(
                    torch.as_tensor(state.opt_state.state[named[n]][k]), v)]
        if bad or state.step != saved_step:
            fail(f"train: restore differs from the saved state: {bad[:5]} ({len(bad)}), step "
                 f"{state.step} vs {saved_step}")
        log(f"train: checkpoint of {nbytes / 1e9:.2f} GB saved in {t_save:.1f} s and restored "
            f"in {t_restore:.1f} s, bit for bit ({len(named)} parameters, "
            f"{len(saved_moments)} x 3 moments, step {saved_step}) after a step that moved "
            f"them (loss {loss_after})")
        del saved_params, saved_moments

        # (d) one step traced.
        with tempfile.TemporaryDirectory(prefix="lmdx_train_trace_") as root:
            fa.reset_launch_counts()
            with tracelib.trace(root) as log_dir:
                with tracelib.annotate("train_step"):
                    state, loss = step(state, batch)
            launches = {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}
            all_launches["bf16 traced"] = launches
            files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
            if len(files) != 1:
                fail(f"train trace: {files} in {log_dir}")
            with open(os.path.join(log_dir, files[0])) as f:
                events = json.load(f)["traceEvents"]
            names = [e.get("name", "") for e in events]
            counts = {what: sum(what in n for n in names)
                      for what in ("train_step", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                                   "flash_bwd_dkdv_kernel", "flash_bwd_dq_sm90_kernel",
                                   "flash_bwd_dkdv_sm90_kernel")}
            if min(counts.values()) < 1:
                fail(f"train trace: events {counts}: the span or a kernel is missing (the step "
                     f"launched {fwd_per_step} forwards and {bwd_per_step} backwards)")
            log(f"train trace: {os.path.getsize(os.path.join(log_dir, files[0])) / 1e6:.1f} MB "
                f"Chrome trace, {len(events)} events: {counts}; loss {float(loss)}")
        del unet, opt, step, state, named
        torch.cuda.empty_cache()
    _require_checked_shapes("train", seen, required=("fwd", "bwd"))
    bf16_steady = sorted(walls["bf16"][1:])[len(walls["bf16"][1:]) // 2]
    f32_steady = sorted(walls["f32"][1:])[len(walls["f32"][1:]) // 2]
    log(f"train: median step wall after the first: bf16 {bf16_steady:.3f} s, float32 "
        f"{f32_steady:.3f} s (batch 2, 512x512)")
    log(f"train: phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return _sum_launches(all_launches)


# Phase 16: the dist slice. (b)'s two ranks share the one card over a gloo
# group (NCCL refuses two ranks on one device).
DIST_TRAIN_STEPS = 3
DIST_TIMEOUT = 480  # seconds for phase 16 (b)'s two ranks, start-up included
TOL_TP = TOL_OPTIN  # tp 2 UNet against the whole one, share of max|whole|
TOL_TP_F32 = TOL_OPTIN_F32


def _launches():
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa

    return {**fa.LAUNCHES, **sa.LAUNCHES, **gn.LAUNCHES}


def _reset_launches():
    from lmdx_torch.nn.kernels import flash_attention as fa
    from lmdx_torch.nn.kernels import group_norm as gn
    from lmdx_torch.nn.kernels import sam_attention as sa

    fa.reset_launch_counts()
    sa.reset_launch_counts()
    gn.reset_launch_counts()


def dist_child(rank: int, port: int, work: str, dp_steps: int, tp_steps: int) -> None:
    """Phase 16 (b), one of its two ranks on the one card, over a gloo
    group: dp 2, tp 2 and dp-2 training (`phase_dist`'s docstring). Writes
    what the parent checks to <work>/rank<rank>.json."""
    import hashlib

    import numpy as np
    import torch

    from lmdx_torch.core.schedule import make_alphas_cumprod
    from lmdx_torch.dist import mesh as meshlib
    from lmdx_torch.dist import serve
    from lmdx_torch.methods._grounded import GroundedParams
    from lmdx_torch.methods.batch import run_lmd_plus_batch
    from lmdx_torch.runtime import models
    from lmdx_torch.training import checkpoint, train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshlib.initialize_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    key = "gligen/diffusers-generation-text-box"
    report = {"rank": rank, "launches": {}, "walls": {}}
    t_child = time.perf_counter()

    def digest(images):
        return hashlib.sha1(np.ascontiguousarray(np.stack(images)).tobytes()).hexdigest()

    with _recording_shapes() as seen:
        bundle = models.load_bundle(key, seed=0, device="cuda")
        cfg = bundle.config

        def lmd_plus(label, b, steps, specs, seeds):
            q = GroundedParams(num_inference_steps=steps)
            return _drive(label, lambda: run_lmd_plus_batch(specs, b, bg_seeds=seeds,
                                                            num_inference_steps=steps),
                          cfg, steps, _default_expect(
                              cfg, steps, 0.4, [(q.overall_max_iter,
                                                 q.overall_max_index_step)], 0))

        # dp 2: each rank's layout, gathered; then its layout alone.
        mesh, sharded = serve.activate_mesh(bundle, dp=2)
        if sharded.unet is not bundle.unet or mesh.dp_index != rank:
            fail(f"dist rank {rank}: dp 2 copied the UNet or placed rank {rank} at row "
                 f"{mesh.dp_index}")
        t0 = time.perf_counter()
        results, report["launches"]["dp2"] = lmd_plus(f"dist dp2 r{rank}", sharded, dp_steps,
                                                       SPECS, [1, 2])
        report["walls"]["dp2"] = time.perf_counter() - t0
        serve.deactivate_mesh()
        images = [r.image for r in results]
        t0 = time.perf_counter()
        own = run_lmd_plus_batch([SPECS[rank]], bundle, bg_seeds=[[1, 2][rank]],
                                 num_inference_steps=dp_steps)[0].image
        report["walls"]["own layout"] = time.perf_counter() - t0
        report["dp2_digest"] = digest(images)
        report["dp2_own_equal"] = bool(np.array_equal(own, images[rank]))
        if rank == 0:
            t0 = time.perf_counter()
            batch2 = run_lmd_plus_batch(SPECS, bundle, bg_seeds=[1, 2],
                                        num_inference_steps=dp_steps)
            report["walls"]["batch 2"] = time.perf_counter() - t0
            report["dp2_gap_to_batch2"] = int(max(
                np.abs(a.astype(int) - r.image.astype(int)).max()
                for a, r in zip(images, batch2)))

        # tp 2: the UNet check, then LMD+ at tp_steps.
        mesh, sharded = serve.activate_mesh(bundle, tp=2)
        eps_w, grad_w = _unet_probe(bundle)
        _reset_launches()
        eps_s, grad_s = _unet_probe(sharded)
        torch.cuda.synchronize()
        report["launches"]["tp2 unet"] = _launches()
        report["tp2_unet"] = [
            _hold(f"dist tp2 r{rank}", "UNet eps, tp 2 against whole", eps_s, eps_w, TOL_TP),
            _hold(f"dist tp2 r{rank}", "latent gradient, tp 2 against whole", grad_s, grad_w,
                  TOL_TP)]
        report["tp2_eps_digest"] = hashlib.sha1(eps_s.float().cpu().numpy().tobytes()).hexdigest()
        heads = sorted({m.heads for m in sharded.unet.modules() if hasattr(m, "heads")})
        if heads != [cfg.unet.num_attention_heads[0] // 2]:
            fail(f"dist tp2 r{rank}: local heads {heads}")
        del eps_w, grad_w, eps_s, grad_s
        t0 = time.perf_counter()
        results, report["launches"]["tp2 lmd_plus"] = lmd_plus(
            f"dist tp2 r{rank}", sharded, tp_steps, SPECS, [1, 2])
        report["walls"]["tp2"] = time.perf_counter() - t0
        serve.deactivate_mesh()
        tp_images = [r.image for r in results]
        report["tp2_digest"] = digest(tp_images)
        if rank == 0:
            t0 = time.perf_counter()
            whole = run_lmd_plus_batch(SPECS, bundle, bg_seeds=[1, 2],
                                       num_inference_steps=tp_steps)
            report["walls"]["tp1"] = time.perf_counter() - t0
            report["tp2_gap_to_tp1"] = int(max(
                np.abs(a.astype(int) - r.image.astype(int)).max()
                for a, r in zip(tp_images, whole)))
        del sharded, results

        # The float32 UNet check at tp 2.
        bundle32 = models.load_bundle(key, seed=0, dtype="float32", device="cuda")
        mesh, sharded32 = serve.activate_mesh(bundle32, tp=2)
        eps_w, grad_w = _unet_probe(bundle32)
        _reset_launches()
        eps_s, grad_s = _unet_probe(sharded32)
        torch.cuda.synchronize()
        report["launches"]["tp2 unet f32"] = _launches()
        report["tp2_unet_f32"] = [
            _hold(f"dist tp2 f32 r{rank}", "UNet eps, tp 2 against whole", eps_s, eps_w,
                  TOL_TP_F32),
            _hold(f"dist tp2 f32 r{rank}", "latent gradient, tp 2 against whole", grad_s,
                  grad_w, TOL_TP_F32)]
        serve.deactivate_mesh()
        del bundle32, sharded32, eps_w, grad_w, eps_s, grad_s
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # dp 2 training, bf16 over float32 masters: the one-process step at
        # batch 2 first, then DIST_TRAIN_STEPS sharded steps at batch 1 a rank.
        batch = _train_batch(key, bundle)
        del bundle
        torch.cuda.empty_cache()
        alphas = make_alphas_cumprod()
        objs_fn = lambda _, b: b["objs"]  # noqa: E731
        unet, opt = _gated_train_unet(cfg, "bfloat16")
        state = train.init_train_state(unet, opt)
        _, loss_one = train.make_train_step(unet, opt, alphas, objs_fn=objs_fn)(state, batch)
        report["train_one_process_loss"] = float(loss_one)
        del unet, opt, state
        torch.cuda.empty_cache()
        unet, opt = _gated_train_unet(cfg, "bfloat16")
        mesh = meshlib.make_mesh(dp=2)
        state = train.shard_state(train.init_train_state(unet, opt), mesh)
        step = train.make_sharded_train_step(state.params, opt, alphas, mesh, objs_fn=objs_fn)
        shard = meshlib.shard_batch(batch, mesh)
        _reset_launches()
        losses, walls = [], []
        for _ in range(DIST_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, shard)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(loss))
        report["launches"]["dp2 train"] = _launches()
        fwd_per_step = _expected_launches(cfg, 1, 1.0, [], passes=1)[0]
        want = {k: 0 for k in report["launches"]["dp2 train"]}
        want.update(flash_attention_fwd=DIST_TRAIN_STEPS * fwd_per_step,
                    flash_attention_bwd=DIST_TRAIN_STEPS * (fwd_per_step - 1),
                    # all but the 256-token level's third (head dim 160)
                    flash_attention_bwd_sm90=DIST_TRAIN_STEPS * (fwd_per_step - 1
                                                                 - fwd_per_step // 3))
        if report["launches"]["dp2 train"] != want:
            fail(f"dist train r{rank}: launches {report['launches']['dp2 train']}, expected "
                 f"{want}")
        report["train_losses"], report["walls"]["train steps"] = losses, walls
        report["train_rows"] = int(shard["x0"].shape[0])
        named = dict(state.params.named_parameters())
        with tempfile.TemporaryDirectory(prefix="lmdx_dist_ckpt_") as root:
            path = meshlib.from_rank0(os.path.join(root, "step"))
            t0 = time.perf_counter()
            checkpoint.save(path, state)
            report["walls"]["checkpoint save"] = time.perf_counter() - t0
            saved = {n: p.detach().clone() for n, p in named.items() if p.requires_grad}
            moments = {n: {k: torch.as_tensor(v).clone()
                           for k, v in state.opt_state.state[named[n]].items()}
                       for n in saved}
            state, _ = step(state, shard)
            t0 = time.perf_counter()
            state = checkpoint.restore(path, state)
            report["walls"]["checkpoint restore"] = time.perf_counter() - t0
            meshlib.barrier()  # rank 0's directory outlives every restore
        bad = [n for n in saved if not torch.equal(named[n], saved[n])]
        bad += [f"{n}.{k}" for n in saved for k, v in moments[n].items()
                if not torch.equal(torch.as_tensor(state.opt_state.state[named[n]][k]), v)]
        report["checkpoint_bad"] = bad[:5]
        report["checkpoint_step"] = int(state.step)
    report["seen"] = {k: sorted(v) for k, v in seen.items()}
    report["walls"]["child"] = time.perf_counter() - t_child
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def phase_dist(cli_steps: int, dp_steps: int, tp_steps: int):
    """Phase 16: the dist slice (`lmdx_torch/dist/`).

    (a) In this process, one rank over NCCL: the CLI's batched LMD+ on the
    first two demo prompts (one batch of 2) at `cli_steps`, once without and
    once with `--mesh auto`
    (one card: a 1x1 mesh over a one-rank group on localhost); the PNGs equal
    bit for bit and the `mesh:` line printed.
    (b) Two child processes on the one card over an explicitly named gloo
    group (`dist_child`), each building SD1.4+GLIGEN (random weights, seed
    0): dp 2 LMD+ on SPECS at `dp_steps` (each rank its layout, `_drive`'s
    checks, every rank's gathered images alike and its own image equal bit
    for bit to a one-process run of its layout; the gap to the batch-2 run
    reported); tp 2 (4 of the 8 heads a rank): one UNet forward and latent
    gradient within TOL_TP of the whole bundle's, then LMD+ on SPECS at
    `tp_steps` with `_drive`'s checks, both ranks' images alike (the gap to
    tp 1 reported); the same UNet check in float32 within TOL_TP_F32; dp-2
    bf16 training (DIST_TRAIN_STEPS steps at batch 1 a rank): the first loss
    within TOL_TRAIN_LOSS of the one-process step at batch 2, and the
    checkpoint round trip (rank 0 writes, each rank restores) bit for bit.
    The ranks report their launches and wrapper shapes: kernels 1 and 2
    must have run at the split head count, and every shape must be one
    phase 2 checked."""
    import numpy as np
    import torch

    from lmdx_torch.dist.mesh import free_port
    from lmdx_torch.eval.prompts import PROMPTS_DEMO
    from lmdx_torch.text import parser
    from lmdx_torch.text.cache import LayoutCache

    t_phase = time.perf_counter()
    all_launches = {}
    with tempfile.TemporaryDirectory(prefix="lmdx_dist_") as root:
        # (a) the CLI's --mesh auto, one rank over NCCL in this process.
        cache_path = os.path.join(root, "cache_demo_v0.1_gpt-4.json")
        cache = LayoutCache(cache_path)
        for prompt, response in zip(PROMPTS_DEMO, DEMO_RESPONSES):
            parser.parse_layout_response(response)
            cache.add(prompt.strip().rstrip("."), response)
        argv = ["--prompt-type", "demo", "--run-model", "lmd_plus", "--image-batch-size", "2",
                "--num_prompts", "2", "--cache-path", cache_path, "--force_run_ind", "0",
                "--num_inference_steps", str(cli_steps), "--no-continue-on-error"]
        _cli(argv + ["--save-dir", os.path.join(root, "plain")])
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = _cli(argv + ["--save-dir", os.path.join(root, "mesh"), "--mesh", "auto"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        all_launches["cli mesh auto"] = _launches()
        if "mesh: {'dp': 1, 'tp': 1} over 1 devices" not in printed:
            fail("dist cli: no mesh: line for --mesh auto on one card")
        rel = sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, "plain"))
                     for d, _, fs in os.walk(os.path.join(root, "plain")) for f in fs)
        rel_mesh = sorted(os.path.relpath(os.path.join(d, f), os.path.join(root, "mesh"))
                          for d, _, fs in os.walk(os.path.join(root, "mesh")) for f in fs)
        if rel != rel_mesh or not rel:
            fail(f"dist cli: --mesh auto wrote {rel_mesh}, without it {rel}")
        for r in rel:
            a = _read_png(os.path.join(root, "plain", r))
            b = _read_png(os.path.join(root, "mesh", r))
            if not np.array_equal(a, b):
                fail(f"dist cli: {r} differs with --mesh auto")
        if all_launches["cli mesh auto"]["flash_attention_fwd"] <= 0:
            fail(f"dist cli: launches {all_launches['cli mesh auto']}")
        log(f"dist cli: --mesh auto (one rank over NCCL) wrote {len(rel)} PNGs equal bit for "
            f"bit to the run without --mesh; wall {wall:.2f} s with the bundle's build, "
            f"launches {all_launches['cli mesh auto']}")

        # (b) two ranks on the one card over gloo.
        work = os.path.join(root, "ranks")
        os.makedirs(work)
        port = free_port()
        code = (f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                f"chip_smoke.dist_child({{rank}}, {port}, {work!r}, {dp_steps}, {tp_steps})")
        logs = [open(os.path.join(work, f"log{r}.txt"), "w") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code.format(rank=r)], cwd=HERE,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            while any(p.poll() is None for p in procs):
                if (any(p.poll() not in (None, 0) for p in procs)
                        or time.perf_counter() - t0 > DIST_TIMEOUT):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        for r in range(2):
            with open(os.path.join(work, f"log{r}.txt")) as f:
                for line in f.read().splitlines():
                    log(f"  [rank {r}] {line[:300]}")
        codes = [p.returncode for p in procs]
        if codes != [0, 0]:
            fail(f"dist: the ranks exited {codes} after {wall:.1f} s (limit {DIST_TIMEOUT} s)")
        reports = []
        for r in range(2):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                reports.append(json.load(f))

    r0, r1 = reports
    for what in ("dp2_digest", "tp2_digest", "tp2_eps_digest"):
        if r0[what] != r1[what]:
            fail(f"dist: the ranks' {what} differ")
    if not (r0["dp2_own_equal"] and r1["dp2_own_equal"]):
        fail("dist dp2: a rank's image differs from its one-process run of its layout")
    losses = [r["train_losses"] for r in reports]
    one = r0["train_one_process_loss"]
    share = abs(losses[0][0] - one) / abs(one)
    if losses[0] != losses[1] or share > TOL_TRAIN_LOSS or not all(
            math.isfinite(x) for x in losses[0]):
        fail(f"dist train: losses {losses} against the one-process {one} ({share:.2e} > "
             f"{TOL_TRAIN_LOSS} or unequal)")
    for r in reports:
        if r["checkpoint_bad"] or r["checkpoint_step"] != DIST_TRAIN_STEPS:
            fail(f"dist train r{r['rank']}: restore differs: {r['checkpoint_bad']}, step "
                 f"{r['checkpoint_step']}")
        if r["train_rows"] != 1:
            fail(f"dist train r{r['rank']}: {r['train_rows']} rows a rank")
    # Kernels 1 and 2 at the split head count, each tp run; every shape one
    # phase 2 checked.
    split = {h for h, _, _ in SPLIT_LEVELS}
    for r in reports:
        for name, key in (("tp2 lmd_plus", ""), ("tp2 unet", ""), ("tp2 unet f32", "_f32")):
            got = r["launches"][name]
            if got[f"flash_attention_fwd{key}"] <= 0 or got[f"flash_attention_bwd{key}"] <= 0:
                fail(f"dist r{r['rank']} {name}: launches {got}")
        heads = {s[1] for s in r["seen"]["fwd"] + r["seen"]["bwd"]}
        if not split <= heads:
            fail(f"dist r{r['rank']}: no flash call at the split heads {split}: {heads}")
    seen = {k: {tuple(x) for r in reports for x in r["seen"][k]} for k in ("fwd", "bwd", "sam")}
    _require_checked_shapes("dist", seen, required=("fwd", "bwd"))
    for r in reports:
        for name, launches in r["launches"].items():
            all_launches[f"{name} r{r['rank']}"] = launches
    walls0 = r0["walls"]
    split_launches = _sum_launches({f"{name} r{r['rank']}": r["launches"][name]
                                    for r in reports
                                    for name in ("tp2 unet", "tp2 lmd_plus", "tp2 unet f32")})
    log(f"dist: dp 2 LMD+ at {dp_steps} steps, each rank's image equal bit for bit to its "
        f"one-process run; gap to the batch-2 run {r0['dp2_gap_to_batch2']} uint8 levels; "
        f"walls {[round(r['walls']['dp2'], 2) for r in reports]} s (the ranks' one-layout "
        f"runs {[round(r['walls']['own layout'], 2) for r in reports]} s side by side, rank "
        f"0's batch-2 run {walls0['batch 2']:.2f} s while rank 1 waited)")
    log(f"dist: tp 2 UNet eps / gradient {r0['tp2_unet']} of max|whole| (bf16, limit "
        f"{TOL_TP}), {r0['tp2_unet_f32']} (float32, limit {TOL_TP_F32}); LMD+ at {tp_steps} "
        f"steps, walls {[round(r['walls']['tp2'], 2) for r in reports]} s (rank 0's tp-1 run "
        f"{walls0['tp1']:.2f} s), gap to tp 1 {r0['tp2_gap_to_tp1']} uint8 levels; launches "
        f"at 4 heads a rank, both ranks: {split_launches}")
    step_walls = [[round(w, 3) for w in r["walls"]["train steps"]] for r in reports]
    log(f"dist: dp 2 training: losses {losses[0]} (one process at batch 2: {one}, "
        f"{share:.2e} of it), step walls {step_walls} s; "
        f"checkpoint save {r0['walls']['checkpoint save']:.1f} s, restore "
        f"{r0['walls']['checkpoint restore']:.1f} s, bit for bit; peak "
        f"{[round(r['peak_gib'], 2) for r in reports]} GiB a rank; children "
        f"{[round(r['walls']['child'], 1) for r in reports]} s of {wall:.1f} s")
    log(f"dist: phase 16 took {time.perf_counter() - t_phase:.1f} s")
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
    ap.add_argument("--single-steps", type=int, default=10,
                    help="DDIM steps of the single-image methods of phase 6 (depth only; "
                         "cut from 50 to 10 to keep the script within 600 s with phase 16)")
    ap.add_argument("--baseline-steps", type=int, default=10,
                    help="steps of phase 7's BoxDiff, MultiDiffusion, DPM-Solver++ and "
                         "inversion runs (depth only; cut from 50 to 10 for phase 16's time)")
    ap.add_argument("--ckpt-steps", type=int, default=10,
                    help="DDIM steps of phase 8's LMD+ and LMD renders on the loaded "
                         "checkpoints (depth only; cut from 50 to 10 for phase 16's time)")
    ap.add_argument("--cli-f32-steps", type=int, default=50,
                    help="DDIM steps of phase 9's float32 LMD through the CLI (depth only; a "
                         "rehearsal flag: the check is the 50 steps of the default)")
    ap.add_argument("--cli-steps", type=int, default=20,
                    help="DDIM steps of phase 9's batched bf16 LMD+, of phase 11's LMD+ "
                         "before the refiner, of phase 12's LMD on SD2.1, of phase "
                         "13's opt-in LMD+ and of phase 16 (a), through the CLI (depth "
                         "only: phases 3-5 run the same work at 50 steps; the refiners' "
                         "15 steps are not cut)")
    ap.add_argument("--optin-f32-steps", type=int, default=50,
                    help="DDIM steps of phase 10's float32 LMD+ with every opt-in kernel "
                         "(depth only; a rehearsal flag: the check is the 50 steps of the "
                         "default)")
    ap.add_argument("--webui-steps", type=int, default=10,
                    help="DDIM steps of phase 14's webui requests (depth only; cut from "
                         "--cli-steps' 20 to 10 for phase 16's time)")
    ap.add_argument("--dist-steps", type=int, default=10,
                    help="DDIM steps of phase 16's dp-2 LMD+ (depth only)")
    ap.add_argument("--dist-tp-steps", type=int, default=2,
                    help="DDIM steps of phase 16's tp-2 LMD+ (depth only: its tensor-split "
                         "collectives go through the host over gloo, two ranks on one "
                         "card)")
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
    sdxl = phase_sdxl(args.cli_steps)
    sd21 = phase_sd21(args.cli_steps)
    cli_optin = phase_cli_optin(args.cli_steps)
    webui = phase_webui(args.webui_steps)
    training = phase_train()
    dist = phase_dist(args.cli_steps, args.dist_steps, args.dist_tp_steps)
    runs = (plus, lmd, optin, single, baselines, checkpoint, cli, optin_f32, sdxl, sd21,
            cli_optin, webui, training, dist)
    launches = {name: sum(run[name] for run in runs) for name in kernels}
    log(f"launches: LMD+ path {plus}, LMD path {lmd}, opt-in LMD+ path {optin}, "
        f"single-image methods {single}, baselines and solvers {baselines}, "
        f"checkpoint path {checkpoint}, CLI {cli}, float32 opt-in LMD+ path {optin_f32}, "
        f"SDXL refiner through the CLI {sdxl}, SD2.1 and the SDXL base through the CLI "
        f"{sd21}, the CLI's opt-in kernels {cli_optin}, the webui {webui}, training "
        f"{training}, the dist slice (both ranks) {dist}")

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
    n21 = len(SD21_LEVELS)
    log(f"kernel times: ms, plain_ms, bound_ms and library_ms are sums of one call "
        f"at each shape above ({3 * len(FWD_CASES)} + {len(REFINER_FWD_CASES)} + "
        f"{len(SDXL_BASE_FWD_CASES)} + {n21 * len(SD21_FWD_CASES)} at d "
        f"{REFINER_HEAD_DIM} + {3 * len(SPLIT_FWD_CASES)} at tp 2 for the flash forward, "
        f"{3 * len(BWD_CASES)} + {n21 * len(SD21_BWD_CASES)} at d 64 + "
        f"{3 * len(SPLIT_BWD_CASES)} at tp 2 + {len(BWD_SHORT_KV)} "
        f"for the backward, {len(SAM_CASES)} for SAM, "
        f"{len(PACKED_CASES) * n_opt} for the packed forward, {len(FUSED_CASES) * n_opt} "
        f"for the fused-heads forward, {len(STAT_CASES) * n_opt} + {len(STAT_BWD_CASES)} "
        f"+ {len(STAT_CASES) * n_opt} float32 (x, x) for pair_stats, "
        f"{3 * len(F32_FWD_CASES)} + {n21 * len(SD21_FWD_CASES)} at d 64 + "
        f"{3 * len(SPLIT_F32_FWD_CASES)} at tp 2 for the float32 forward, "
        f"{3 * len(F32_BWD_CASES)} + {n21 * len(SD21_BWD_CASES)} at d 64 + "
        f"{3 * len(SPLIT_F32_BWD_CASES)} at tp 2 + "
        f"{len(F32_OPTIN_BWD)} for the float32 backward, "
        f"{len(F32_SAM_CASES)} for float32 SAM, {4 * n_opt} for the float32 packed "
        f"forward, {len(F32_FUSED_CASES) * n_opt} for the float32 fused-heads forward); "
        f"launches are those of the LMD+, LMD and opt-in LMD+ paths, the single-image "
        f"methods, the baselines and solvers, the checkpoint path, the CLI, the "
        f"float32 opt-in LMD+ path, the SDXL refiner through the CLI, SD2.1 with the "
        f"SDXL base through the CLI, the CLI with the opt-in variables, the webui, "
        f"the training steps and phase 16's mesh runs (both ranks) together")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
