"""Batch stage-2 generation CLI (the port's copy of the JAX package's
cli/generate.py, with the same flags, seeds and printed lines).

Prompts come from a benchmark or demo prompt set, layouts from the stage-1
layout cache, methods from `lmdx_torch.methods`, with the reference's seed
derivation (the LARGE_CONSTANT family), skip-if-exists resume, per-prompt
error tolerance and the cache-access count. `--image-batch-size N` (lmd,
lmd_plus) runs the batched throughput mode (`run_batched`), which copies
and saves each batch's images after launching the next batch
(`--no-pipeline-batches` turns that off).

Precision: by default the bundle computes in bfloat16. `--use_autocast 0`
loads it in float32, the reference's no-autocast configuration (LMD's
published one), on the float32 attention kernels, and turns TF32 off for
matmuls and cuDNN's convolutions (`torch.backends.cuda.matmul.allow_tf32`,
`torch.backends.cudnn.allow_tf32`; cuDNN's default is TF32), so that every
product is full float32 (`runtime/precision.py`; `load_bundle` does the same
for any float32 bundle).

Opt-in kernels: LMDX_PACKED_ATTENTION, LMDX_FUSED_HEADS and
LMDX_PALLAS_GROUPNORM, the JAX package's switches, set to "1" choose the
head-packed forward, the fused-heads forward and the `pair_stats`
GroupNorm; the CLI reads them (`config.kernel_options_from_env`) and builds
its bundle with that `KernelOptions`.

Two flags of the JAX CLI bound XLA compiles; an eager program compiles
nothing, and both keep the JAX plan without changing an image:
`--max-compiled-variants N` merges the batches' shape classes as the JAX
CLI plans them (its printed line counts them) and fills a short tail
group with duplicate jobs whose images are discarded, so the batches the
CLI runs are the JAX CLI's; `--warm-ahead` walks the classes in the
JAX order and prints each one, with nothing to warm.

`--use-sdv2` runs the stage-2 method on SD2.1 base
(stabilityai/stable-diffusion-2-1-base); GLIGEN methods need SD1.4 and stop
on the JAX CLI's assertion.

`--sdxl` refines each image with the SDXL refiner
(`methods/sdxl_refine.py`: LANCZOS upscale to 1024x1024, img2img at strength
`--sdxl-step-ratio` on the model's scheduler, seed + LARGE_CONSTANT4) after
the method and before the PNG is written, in both loops; the refiner bundle
is built once, on the first refined image, at its own bfloat16 whatever
`--use_autocast` says, from `$LMDX_CHECKPOINT_DIR/<model--key>` or random
weights. LMDX_REFINER_MODEL names another configuration: the SDXL base
(stabilityai/stable-diffusion-xl-base-1.0, two text towers, DDIM) or a tiny
one.

`--mesh auto|dp=N|dp=N,tp=M` splits the run over a ("dp", "tp") mesh of
processes, one per card (`lmdx_torch/dist/`): the batched mode's images
over dp, the UNet's and the text towers' matmuls over tp. With
LMDX_COORDINATOR, LMDX_NUM_PROCESSES and LMDX_PROCESS_ID set (one process
per card, started by the user) each process joins the group
(`dist.mesh.initialize_multihost`) before any device use and prints the
`multihost:` line. Without them the CLI starts the mesh's processes on
localhost itself (`auto`: one per local card); a mesh of one rank (one
card, or `auto` with `--cpu`) runs in this process. Every rank prints the
`mesh:` line; the run directory and the resume decisions are global rank
0's, and only rank 0 writes PNGs (and so the resume state).

Refused, with the ROADMAP item that holds it: an SDXL `--sd-model` key
(item 6: an SDXL configuration serves only as the `--sdxl` refiner; its
UNet needs text_time conditioning, which no stage-2 method passes, as in
the JAX package). JAX's compile cache has no counterpart.

Example (offline, cached layouts, the CPU and the tiny test model):
    python -m lmdx_torch.cli.generate --cpu --sd-model tiny-test \\
        --prompt-type demo --run-model lmd_plus --num_inference_steps 4 \\
        --cache-path cache/cache_demo_v0.1_gpt-4.json
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import subprocess
import sys
import time
import traceback

from PIL import Image

from .. import methods as methods_lib
from ..config import SD_CONFIGS, kernel_options_from_env
from ..dist import mesh as meshlib
from ..dist import serve as serve_lib
from ..eval.prompts import get_prompts
from ..methods import base as method_base
from ..runtime.precision import set_full_f32
from ..text.cache import LayoutCache, cache_filename
from ..text.parser import ParseError, filter_boxes, parse_layout_response

LARGE_CONSTANT = 123456789
LARGE_CONSTANT2 = 56789
LARGE_CONSTANT3 = 6789
LARGE_CONSTANT4 = 7890

FLOAT_ARGS = [
    "frozen_step_ratio", "loss_threshold", "ref_ca_loss_weight",
    "fg_top_p", "bg_top_p", "overall_fg_top_p", "overall_bg_top_p",
    "fg_weight", "bg_weight", "overall_fg_weight", "overall_bg_weight",
    "overall_loss_threshold", "fg_blending_ratio", "mask_th_for_point",
    "so_floor_padding",
]
INT_ARGS = [
    "loss_scale", "max_iter", "max_index_step", "overall_max_iter",
    "overall_max_index_step", "overall_loss_scale",
    "horizontal_shift_only", "so_horizontal_center_only", "use_ref_ca",
    "num_inference_steps", "use_fast_schedule",
]
STR_ARGS = ["so_vertical_placement"]
BOOL_INT_ARGS = {"horizontal_shift_only", "so_horizontal_center_only",
                 "use_ref_ca", "use_fast_schedule"}

SDXL_STAGE2 = ("an SDXL configuration serves only as the --sdxl refiner: its UNet "
               "needs text_time conditioning, which no stage-2 method passes "
               "(ROADMAP.md section 1 item 6)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--save-suffix", default=None, type=str)
    parser.add_argument("--model", default="gpt-4",
                        help="LLM model the cache was generated with")
    parser.add_argument("--repeats", default=1, type=int)
    parser.add_argument("--regenerate", default=1, type=int)
    parser.add_argument("--force_run_ind", default=None, type=int)
    parser.add_argument("--skip_first_prompts", default=0, type=int)
    parser.add_argument("--seed_offset", default=0, type=int)
    parser.add_argument("--num_prompts", default=None, type=int)
    parser.add_argument("--run-model", default="lmd_plus",
                        choices=sorted(methods_lib.METHODS))
    parser.add_argument("--scheduler", default=None,
                        help="DDIM (default) or DPMSolverMultistep/dpmpp_2m")
    parser.add_argument("--image-batch-size", default=1, type=int,
                        help="lmd / lmd_plus: generate N prompts per batched "
                             "pipeline invocation (throughput mode)")
    parser.add_argument("--no-shape-schedule", action="store_true",
                        help="batched mode: keep prompt order instead of "
                             "grouping jobs by box count")
    parser.add_argument("--no-pipeline-batches", action="store_true",
                        help="batched mode: copy and save each batch's images "
                             "before launching the next batch, instead of "
                             "after. The images are the same either way; "
                             "pipelining shifts per-batch wall attribution "
                             "by one batch")
    parser.add_argument("--max-compiled-variants", default=0, type=int,
                        help="batched mode: the JAX CLI's compile budget "
                             "(merge the batches' shape classes down to N by "
                             "padding). An eager program compiles nothing: "
                             "the plan is made and printed as in the JAX "
                             "CLI, and a short tail group is filled with "
                             "duplicate jobs whose images are discarded; no "
                             "saved image changes. 0 = no plan (default)")
    parser.add_argument("--warm-ahead", action="store_true",
                        help="batched mode: in the JAX CLI, compile the "
                             "next shape class in a background thread. An "
                             "eager program has nothing to warm: the classes "
                             "are walked in the JAX order and printed, and "
                             "nothing else runs; no image changes")
    parser.add_argument("--mesh", default=None,
                        help="shard the run over a mesh of processes, one per "
                             "card: 'auto' (dp=all local cards, or the "
                             "LMDX_NUM_PROCESSES processes), 'dp=N', or "
                             "'dp=N,tp=M'. Replaces the reference's "
                             "process-level prompt sharding; use with "
                             "--image-batch-size >= dp")
    parser.add_argument("--use-sdv2", action="store_true",
                        help="run on SD2.1 base (stabilityai/stable-diffusion-2-1-base); "
                             "GLIGEN methods need SD1.4")
    parser.add_argument("--sd-model", default=None,
                        help="explicit SD config key override (e.g. tiny-test, "
                             "stabilityai/stable-diffusion-2-1-base); SDXL keys are "
                             "refused: they serve only as the --sdxl refiner "
                             "(LMDX_REFINER_MODEL)")
    parser.add_argument("--ignore-bg-prompt", action="store_true")
    parser.add_argument("--ignore-negative-prompt", action="store_true")
    parser.add_argument("--no-synthetic-prompt", action="store_true")
    parser.add_argument("--no-scale-boxes-default", action="store_true")
    parser.add_argument("--no-continue-on-error", action="store_true")
    parser.add_argument("--prompt-type", default="lmd")
    parser.add_argument("--template_version", default="v0.1")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--cache-path", default=None,
                        help="layout cache JSON (default: reference naming)")
    parser.add_argument("--cache-dir", default="cache")
    parser.add_argument("--save-dir", default="img_generations")
    parser.add_argument("--sdxl", action="store_true",
                        help="refine each image with the SDXL refiner (1024x1024 "
                             "img2img; LMDX_REFINER_MODEL names another one, e.g. "
                             "the SDXL base) before it is saved")
    parser.add_argument("--sdxl-step-ratio", type=float, default=0.3)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (device='cpu'); without it the "
                             "port runs on the card and refuses to start "
                             "without one")
    parser.add_argument("--sam-checkpoint", default=None,
                        help="transformers SAM checkpoint dir for mask "
                             "refinement; default: coarse box/attention masks")
    parser.add_argument("--no-center-or-align", action="store_true",
                        help="skip per-box centered generation + alignment "
                             "(reference generate.py:45,202-204)")
    parser.add_argument("--multidiffusion_bootstrapping", default=20,
                        type=int)
    parser.add_argument("--use_autocast", default=None, type=int,
                        help="reference generate.py:86. Default/1: bf16 "
                             "compute with f32 accumulation. 0: full f32 "
                             "compute on the float32 attention kernels, TF32 "
                             "off for matmuls and convolutions — the "
                             "reference's no-autocast training-free-LMD "
                             "configuration (lmd.py:254)")
    for name in FLOAT_ARGS:
        parser.add_argument("--" + name, default=None, type=float)
    for name in INT_ARGS:
        parser.add_argument("--" + name, default=None, type=int)
    for name in STR_ARGS:
        parser.add_argument("--" + name, default=None, type=str)
    return parser


def collect_run_kwargs(args) -> dict:
    run_kwargs = {}
    for name in FLOAT_ARGS + INT_ARGS + STR_ARGS:
        value = getattr(args, name)
        if value is None:
            continue
        if name in BOOL_INT_ARGS:
            value = bool(value)
        run_kwargs[name] = value
    if args.no_center_or_align:  # reference generate.py:202-204
        run_kwargs["align_with_overall_bboxes"] = False
        run_kwargs["so_center_box"] = False
    return run_kwargs


def select_model_key(args) -> str:
    if args.sd_model:
        return args.sd_model
    if args.use_sdv2:
        assert args.run_model not in ("gligen", "lmd_plus"), \
            "GLIGEN adapters require SD v1.4"
        return "stabilityai/stable-diffusion-2-1-base"
    if args.run_model in ("gligen", "lmd_plus"):
        return "gligen/diffusers-generation-text-box"
    return "runwayml/stable-diffusion-v1-5"


def not_ported(args) -> str | None:
    """Why the flags ask for code the port does not have, or None."""
    if args.sd_model and args.sd_model not in SD_CONFIGS:
        return (f"--sd-model {args.sd_model}: not a configuration of the port "
                f"({', '.join(sorted(SD_CONFIGS))})")
    if args.sd_model and SD_CONFIGS[args.sd_model]().unet.addition_embed_type:
        return f"--sd-model {args.sd_model}: {SDXL_STAGE2}"
    return None


def warn_if_coarse_on_real_weights(bundle, segmenter, run_model) -> bool:
    """Real SD weights + no real segmenter = every mask silently degrades to
    the coarse box (an accuracy trap the reference cannot hit — it always
    loads SAM, generate.py:126). Warn loudly. Returns True if warned."""
    if (run_model in ("lmd", "lmd_plus") and segmenter is None
            and getattr(bundle, "checkpoint_dir", None)):
        import warnings

        warnings.warn(
            "real SD weights are loaded but mask refinement is the coarse "
            "box segmenter (no SAM checkpoint found). Grounding accuracy "
            "will degrade. Pass --sam-checkpoint or place "
            "facebook--sam-vit-base under $LMDX_CHECKPOINT_DIR.",
            stacklevel=2)
        return True
    return False


def make_save_dir(args) -> str:
    suffix = f"_{args.save_suffix}" if args.save_suffix else ""
    base = (f"{args.save_dir}/template{args.template_version}"
            f"_{args.run_model}_{args.prompt_type}{suffix}")
    if args.force_run_ind is not None:
        return f"{base}/run{args.force_run_ind}"
    run_ind = 0
    while os.path.exists(f"{base}/run{run_ind}"):
        run_ind += 1
    return f"{base}/run{run_ind}"


def local_world(mesh_kwargs: dict, n_local: int) -> int:
    """Ranks of a mesh started on this host: `auto` takes every local card
    (`n_local`; 1 on the CPU), a missing axis is filled from them as
    `make_mesh` fills it."""
    dp, tp = mesh_kwargs.get("dp"), mesh_kwargs.get("tp")
    if dp is None and tp is None:
        return n_local
    if dp is None:
        dp = max(n_local // tp, 1)
    if tp is None:
        tp = max(n_local // dp, 1)
    return dp * tp


def launch_local(argv: list[str], world: int) -> int:
    """Run this CLI as `world` processes on localhost, one per card, joined
    through LMDX_COORDINATOR / LMDX_NUM_PROCESSES / LMDX_PROCESS_ID. Returns
    0, or the first failing process's exit code after stopping the rest."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base = {**os.environ, "LMDX_COORDINATOR": f"localhost:{meshlib.free_port()}",
            "LMDX_NUM_PROCESSES": str(world),
            "PYTHONPATH": os.pathsep.join(
                [root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs = [subprocess.Popen([sys.executable, "-m", "lmdx_torch.cli.generate", *argv],
                              env={**base, "LMDX_PROCESS_ID": str(i)})
             for i in range(world)]
    try:
        while True:
            codes = [proc.poll() for proc in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                return failed[0] if failed else 0
            time.sleep(0.2)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refused = not_ported(args)
    if refused:
        parser.error(refused)
    mesh_kwargs = None
    if args.mesh is not None and not args.dry_run:
        try:
            mesh_kwargs = serve_lib.parse_mesh_arg(args.mesh)
        except ValueError as e:
            parser.error(str(e))
        if not os.environ.get("LMDX_COORDINATOR"):
            import torch

            n_local = 1 if args.cpu else torch.cuda.device_count()
            world = local_world(mesh_kwargs, max(n_local, 1))
            if not args.cpu and world > n_local:
                parser.error(f"--mesh {args.mesh}: {world} processes, one per card, but "
                             f"{n_local} card(s) here")
            if world > 1:
                return launch_local(sys.argv[1:] if argv is None else list(argv), world)
    # Multi-host (no-op unless LMDX_COORDINATOR is set): before any device
    # use, so that every process joins the same group.
    joined = meshlib.initialize_multihost(device="cpu" if args.cpu else None)
    if joined:
        import torch.distributed as dist

        print(f"multihost: process {dist.get_rank()}/{dist.get_world_size()}, 1 local / "
              f"{dist.get_world_size()} global devices")
    try:
        return _main(args, mesh_kwargs)
    finally:
        serve_lib.deactivate_mesh()
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, mesh_kwargs) -> int:
    if args.scheduler:
        alias = {"DPMSolverMultistep": "dpmpp_2m", "DDIM": "ddim",
                 "DDIMScheduler": "ddim"}
        args.scheduler = alias.get(args.scheduler, args.scheduler)
    device = "cpu" if args.cpu else None
    run_kwargs = collect_run_kwargs(args)
    method = methods_lib.get_method(args.run_model)

    cache_path = args.cache_path or cache_filename(
        args.prompt_type, args.template_version, args.model, args.cache_dir)
    cache = LayoutCache(cache_path, allow_nonexist=False)

    prompts = get_prompts(args.prompt_type, model=args.model)
    save_dir = meshlib.from_rank0(make_save_dir(args))
    print(f"save_dir: {save_dir}, cache: {cache_path}")

    bundle = None
    segmenter = None
    if not args.dry_run:
        from ..runtime import models

        if args.use_autocast == 0:
            print(set_full_f32())
        bundle = models.load_bundle(
            select_model_key(args),
            dtype="float32" if args.use_autocast == 0 else None, device=device,
            kernels=kernel_options_from_env())
        if mesh_kwargs is not None:
            mesh, bundle = serve_lib.activate_mesh(bundle, **mesh_kwargs)
            print(f"mesh: {mesh.shape} over {mesh.size} devices")
            if mesh.dp > 1 and args.image_batch_size < mesh.dp:
                print(f"NOTE: dp={mesh.dp} but --image-batch-size="
                      f"{args.image_batch_size}; dp sharding only pays off "
                      "when the image batch divides by dp")
        sam_checkpoint = args.sam_checkpoint or models.discover_sam_checkpoint()
        if sam_checkpoint:
            print(f"SAM segmenter: {sam_checkpoint}"
                  + ("" if args.sam_checkpoint else " (auto-discovered)"))
            segmenter = models.load_segmenter(sam_checkpoint, device=device)
        else:
            warn_if_coarse_on_real_weights(bundle, segmenter, args.run_model)

    writer = meshlib.is_writer()
    refine = None
    if args.sdxl and not args.dry_run and writer:
        from ..methods import sdxl_refine

        def refine(image, spec, seed):
            return sdxl_refine.refine(
                image, spec, refine_seed=seed + LARGE_CONSTANT4,
                refinement_step_ratio=args.sdxl_step_ratio,
                bundle=sdxl_refine.load_refiner_bundle(device))

    if args.image_batch_size > 1:
        assert args.run_model in ("lmd", "lmd_plus"), \
            "--image-batch-size needs --run-model lmd or lmd_plus"
        assert args.regenerate == 1
        return run_batched(args, run_kwargs, cache, prompts, save_dir,
                           bundle, segmenter, refine)

    scale_boxes_default = not args.no_scale_boxes_default
    ind = 0
    if args.regenerate > 1:
        assert args.skip_first_prompts == 0

    for regenerate_ind in range(args.regenerate):
        cache.reset_access()
        for prompt_ind, prompt in enumerate(prompts):
            if prompt_ind < args.skip_first_prompts:
                ind += 1
                continue
            if args.num_prompts is not None and prompt_ind >= (
                    args.skip_first_prompts + args.num_prompts):
                ind += 1
                continue

            kwargs = {}
            if isinstance(prompt, list):
                prompt, kwargs = prompt
            prompt = prompt.strip().rstrip(".")
            ind_override = kwargs.get("seed")
            scale_boxes = kwargs.get("scale_boxes", scale_boxes_default)

            resp = cache.get(prompt)
            if resp is None:
                print(f"Cache miss, skipping prompt: {prompt}")
                ind += 1
                continue

            img_dir = f"{save_dir}/{ind}"
            existing = meshlib.from_rank0(
                [f for f in os.listdir(img_dir) if f.startswith("img")]
                if os.path.exists(img_dir) else []
            )
            if len(existing) >= args.repeats:
                print(f"Image exists at {img_dir}, skipping")
                ind += 1
                continue
            if writer:
                os.makedirs(img_dir, exist_ok=True)

            try:
                layout = parse_layout_response(resp)
                bg_prompt = "" if args.ignore_bg_prompt else layout.bg_prompt
                neg_prompt = "" if args.ignore_negative_prompt else layout.neg_prompt
                gen_boxes = filter_boxes(layout.gen_boxes, scale_boxes=scale_boxes)
                spec = {
                    "prompt": prompt,
                    "gen_boxes": gen_boxes,
                    "bg_prompt": bg_prompt,
                    "extra_neg_prompt": neg_prompt,
                }
                print(f"[{ind}] spec: {spec}")
                if args.dry_run:
                    ind += 1
                    continue

                from ..utils import vis

                if writer:
                    vis.draw_boxes(gen_boxes, bg_prompt=bg_prompt,
                                   neg_prompt=neg_prompt).save(
                        f"{img_dir}/boxes.png")

                original_ind_base = (
                    ind_override + regenerate_ind * LARGE_CONSTANT2
                    if ind_override is not None else ind
                )
                for repeat_ind in range(args.repeats):
                    ind_offset = repeat_ind * LARGE_CONSTANT3 + args.seed_offset
                    seed = original_ind_base + ind_offset
                    call_kwargs = dict(run_kwargs)
                    if args.scheduler and args.run_model != "multidiffusion":
                        call_kwargs["scheduler"] = args.scheduler
                    if args.run_model == "multidiffusion":
                        call_kwargs["bootstrapping"] = (
                            args.multidiffusion_bootstrapping)
                    if args.run_model in ("lmd", "lmd_plus"):
                        call_kwargs["fg_seed_start"] = ind + ind_offset + LARGE_CONSTANT
                        call_kwargs["segmenter"] = segmenter
                        if args.no_synthetic_prompt:
                            call_kwargs["overall_prompt_override"] = prompt
                    result = method.run(spec, bundle, bg_seed=seed, **call_kwargs)
                    if not writer:
                        continue
                    image = result.image
                    if result.aux.get("masks"):
                        # Colored mask composite (reference parse.show_masks,
                        # saved as masks.png by multidiffusion.py:384).
                        vis.mask_overlay(result.aux["masks"]).save(
                            f"{img_dir}/masks_{repeat_ind}.png")
                    for so_ind, so_img in enumerate(result.so_img_list):
                        Image.fromarray(so_img).save(
                            f"{img_dir}/so_{repeat_ind}_{so_ind}.png")
                    if refine is not None:
                        image = refine(image, spec, seed)
                    Image.fromarray(image).save(f"{img_dir}/img_{repeat_ind}.png")
            except KeyboardInterrupt:
                raise
            except ParseError as e:
                print(f"***Parse error on prompt {prompt!r}: {e}***")
                if args.no_continue_on_error:
                    raise
            except Exception as e:  # mirrors generate.py:388-401 tolerance
                print(f"***Error: {e}***")
                print(traceback.format_exc())
                if args.no_continue_on_error:
                    raise
                time.sleep(1)
            ind += 1

        if cache.values_accessed() != len(prompts):
            print(
                f"**Cache hit {cache.values_accessed()} time(s) for "
                f"{len(prompts)} prompts: there may be cache misses or "
                f"prompt/cache inconsistencies.**"
            )
    return 0


def _pow2_bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _flat_bucket(n: int) -> int:
    """The JAX package's flat per-box pad (its methods/batch.py:_box_bucket)."""
    if n <= 0:
        return 0
    if n <= 8:
        return _pow2_bucket(n)
    return ((n + 7) // 8) * 8


def plan_shape_classes(groups: list[list[int]], max_variants: int,
                       position_floor: int = 4):
    """Merge batch shape classes down to a compile budget (the JAX CLI's
    plan, kept so that both CLIs form and print the same classes; the
    port's batch functions check the floors and run unpadded).

    groups: per batch, the list of box counts of its images. Each distinct
    (flat per-box pad, per-image object bucket, group size) triple is one
    class. With max_variants > 0, choose that many canonical classes (always
    including one that dominates everything) and pad every non-empty batch
    up to the smallest dominating canonical class — minimizing total pad
    waste, lexicographically (extra per-box rows, then extra object slots).
    Empty-layout batches are left alone, and only groups at the dominant
    group size G merge.

    position_floor: shared word-position pad (workload_position_floor).

    Returns per group either None (use defaults) or a
    {"pad_boxes_to", "pad_objs_to", "pad_positions_to"} dict.
    """
    keys = []
    for g in groups:
        s, mx = sum(g), max(g, default=0)
        keys.append((s, mx, len(g)) if s else None)
    glens = [k[2] for k in keys if k]
    if not glens:
        return [None] * len(groups)
    g_main = max(set(glens), key=glens.count)
    classes = sorted({(_flat_bucket(s), _pow2_bucket(mx))
                      for s, mx, glen in (k for k in keys if k)
                      if glen == g_main})
    if max_variants <= 0 or len(classes) <= max_variants:
        return [None] * len(groups)

    top = (max(c[0] for c in classes), max(c[1] for c in classes))
    candidates = sorted(set(classes) | {top})

    def assign(chosen):
        plan, flat_waste, obj_waste = [], 0, 0
        for key in keys:
            if key is None or key[2] != g_main:
                plan.append(None)
                continue
            s, mx, _ = key
            best = min((c for c in chosen
                        if c[0] >= s and c[1] >= _pow2_bucket(mx)),
                       key=lambda c: (c[0], c[1]))
            plan.append({"pad_boxes_to": best[0], "pad_objs_to": best[1],
                         "pad_positions_to": position_floor})
            flat_waste += best[0] - s
            obj_waste += best[1] - _pow2_bucket(mx)
        return plan, (flat_waste, obj_waste)

    # Exhaustive subset search is exponential in the class count; past a
    # bounded combination count, drop greedily the class whose reassignment
    # costs least.
    n_combos = math.comb(len(candidates) - 1, max_variants - 1)
    if n_combos <= 20_000:
        best_plan, best_cost = None, None
        for chosen in itertools.combinations(candidates, max_variants):
            if top not in chosen:
                continue
            plan, cost = assign(chosen)
            if best_cost is None or cost < best_cost:
                best_plan, best_cost = plan, cost
        return best_plan

    chosen = set(candidates)
    while len(chosen) > max_variants:
        best_drop, best_cost = None, None
        for c in sorted(chosen - {top}):
            _, cost = assign(sorted(chosen - {c}))
            if best_cost is None or cost < best_cost:
                best_drop, best_cost = c, cost
        chosen.remove(best_drop)
    return assign(sorted(chosen))[0]


def workload_position_floor(tokenizer, specs) -> int:
    """Maximum word-position bucket over the workload's overall prompts,
    taken globally so that the plan floors every class to one shared
    value."""
    from ..text import tokens as toklib
    from ..text.parser import BOX_SCALE, convert_spec

    best = 1
    for spec in specs:
        conv = convert_spec(spec, *BOX_SCALE)
        phrases = [x[0] for x in conv.overall_phrases_words_bboxes]
        words = [x[1] for x in conv.overall_phrases_words_bboxes]
        if not phrases:
            continue
        idx = toklib.get_phrase_indices(
            tokenizer, conv.overall_prompt, phrases, words=words,
            add_suffix_if_not_found=True)
        best = max(best, max(
            (len(pos) for pos in idx.object_positions), default=1))
    return _pow2_bucket(best)


def build_jobs(args, cache, prompts, save_dir) -> list[dict]:
    """Pending (prompt, repeat) jobs for the batched mode: parsed specs,
    per-job seeds (reference derivation), skip-if-exists resume. Pure given
    (flags, cache, prompt set, save_dir)."""
    scale_boxes_default = not args.no_scale_boxes_default
    jobs = []
    for ind, prompt in enumerate(prompts):
        if ind < args.skip_first_prompts:
            continue
        if args.num_prompts is not None and ind >= (
                args.skip_first_prompts + args.num_prompts):
            continue
        kwargs = {}
        if isinstance(prompt, list):
            prompt, kwargs = prompt
        prompt = prompt.strip().rstrip(".")
        resp = cache.get(prompt)
        if resp is None:
            print(f"Cache miss, skipping prompt: {prompt}")
            continue
        img_dir = f"{save_dir}/{ind}"
        existing = ([f for f in os.listdir(img_dir) if f.startswith("img")]
                    if os.path.exists(img_dir) else [])
        if len(existing) >= args.repeats:
            continue
        try:
            layout = parse_layout_response(resp)
        except ParseError as e:
            print(f"***Parse error on {prompt!r}: {e}***")
            continue
        gen_boxes = filter_boxes(
            layout.gen_boxes,
            scale_boxes=kwargs.get("scale_boxes", scale_boxes_default))
        spec = {
            "prompt": prompt, "gen_boxes": gen_boxes,
            "bg_prompt": "" if args.ignore_bg_prompt else layout.bg_prompt,
            "extra_neg_prompt": ("" if args.ignore_negative_prompt
                                 else layout.neg_prompt),
        }
        base_seed = kwargs.get("seed", ind)
        for repeat_ind in range(args.repeats):
            offset = repeat_ind * LARGE_CONSTANT3 + args.seed_offset
            jobs.append({
                "ind": ind, "repeat": repeat_ind, "spec": spec,
                "img_dir": img_dir,
                "bg_seed": base_seed + offset,
                "fg_seed_start": ind + offset + LARGE_CONSTANT,
            })
    return jobs


def plan_groups(args, jobs, tokenizer=None):
    """Order jobs, form batches, and plan the compile-budget pads.

    Returns (groups, pad_plan, position_floor); groups may contain jobs
    marked {"pad": True} (duplicates whose results callers must discard).
    """
    # Shape scheduling: group jobs by box count (stable: index order within
    # a count), so each batch is near-uniform; seeds are per job and outputs
    # are keyed by prompt index, so the order changes no image.
    if not args.no_shape_schedule:
        jobs = sorted(jobs, key=lambda j: len(j["spec"]["gen_boxes"]))

    groups = [jobs[s : s + args.image_batch_size]
              for s in range(0, len(jobs), args.image_batch_size)]
    # Compile-budget mode: the JAX CLI fills a short tail group with
    # duplicate jobs (marked, images discarded) so that every group shares
    # one size.
    if args.max_compiled_variants > 0 and len(groups) > 1:
        for g in groups:
            while len(g) < args.image_batch_size:
                g.append({**g[-1], "pad": True})

    position_floor = 4
    if args.max_compiled_variants > 0 and tokenizer is not None:
        position_floor = workload_position_floor(
            tokenizer, [j["spec"] for j in jobs])
    pad_plan = plan_shape_classes(
        [[len(j["spec"]["gen_boxes"]) for j in g] for g in groups],
        args.max_compiled_variants, position_floor=position_floor)
    return groups, pad_plan, position_floor


def group_class_key(group, pads):
    """A batch's shape class as the JAX CLI keys it."""
    counts = [len(j["spec"]["gen_boxes"]) for j in group]
    if pads:
        return ("merged", pads["pad_boxes_to"], pads["pad_objs_to"],
                pads["pad_positions_to"], len(group))
    if sum(counts) == 0:
        return ("empty", len(group))
    return ("natural", _flat_bucket(sum(counts)),
            _pow2_bucket(max(counts)), len(group))


def run_batched(args, run_kwargs, cache, prompts, save_dir, bundle, segmenter,
                refine=None) -> int:
    """Throughput mode: group pending (prompt, repeat) jobs into batches of
    --image-batch-size and run them through the multi-image LMD / LMD+
    pipeline (lmdx_torch.methods.batch). Resume and seed semantics match the
    sequential loop. Pipelined (the default), a batch's images are copied
    and saved after the next batch's work is launched. `refine(image, spec,
    seed)` (`--sdxl`), when given, runs on each image before it is saved."""
    from ..methods.batch import run_lmd_batch, run_lmd_plus_batch

    run_batch_fn = (run_lmd_plus_batch if args.run_model == "lmd_plus"
                    else run_lmd_batch)

    jobs = meshlib.from_rank0(build_jobs(args, cache, prompts, save_dir))
    groups, pad_plan, position_floor = plan_groups(
        args, jobs, tokenizer=bundle.tokenizer if bundle else None)
    if any(pad_plan):
        cls_keys = set()
        for g, pads in zip(groups, pad_plan):
            counts = [len(j["spec"]["gen_boxes"]) for j in g]
            if pads:
                cls_keys.add((pads["pad_boxes_to"], pads["pad_objs_to"],
                              pads["pad_positions_to"], len(g)))
            elif sum(counts):
                cls_keys.add((_flat_bucket(sum(counts)),
                              _pow2_bucket(max(counts)), None, len(g)))
        print(f"[batched] with-box shape classes merged to {len(cls_keys)} "
              f"compiled variants (--max-compiled-variants "
              f"{args.max_compiled_variants}, position floor "
              f"{position_floor})")

    pipeline = not args.no_pipeline_batches
    writer = meshlib.is_writer()
    print(f"[batched] {len(jobs)} jobs, batch size {args.image_batch_size}"
          + (" (pipelined)" if pipeline else ""))

    if args.warm_ahead and bundle is not None:
        # The JAX CLI compiles each class after the first in a background
        # thread; an eager program compiles nothing, so the classes are only
        # walked, in the same order.
        class_order = list(dict.fromkeys(
            group_class_key(g, pads) for g, pads in zip(groups, pad_plan)))
        for key in class_order[1:]:
            print(f"[warm-ahead] {key}: nothing to compile (eager)", flush=True)

    done = 0
    t_last = time.perf_counter()
    pending = None   # (group, results, pads, box_counts, n_real)

    def flush(entry):
        """Copy and save one batch's images. Pipelined, this runs after the
        next batch's work is launched."""
        nonlocal done, t_last
        group, results, pads, box_counts, n_real = entry
        method_base.finalize_results(results)  # one copy; no-op when eager
        for job, result in zip(group, results):
            if job.get("pad") or not writer:
                continue
            os.makedirs(job["img_dir"], exist_ok=True)
            if result.aux.get("masks"):
                from ..utils import vis
                vis.mask_overlay(result.aux["masks"]).save(
                    f"{job['img_dir']}/masks_{job['repeat']}.png")
            image = result.image
            if refine is not None:
                image = refine(image, job["spec"], job["bg_seed"])
            Image.fromarray(image).save(
                f"{job['img_dir']}/img_{job['repeat']}.png")
        # Per-batch wall: boxes= lists the whole (pad-inclusive) batch;
        # img/s counts the saved images. Pipelined walls lag one batch.
        dt = time.perf_counter() - t_last
        t_last = time.perf_counter()
        done += n_real
        pad_note = (f" pad=({pads['pad_boxes_to']},{pads['pad_objs_to']})"
                    if pads else "")
        print(f"[batched] {done}/{len(jobs)} "
              f"done  boxes={box_counts}{pad_note} {dt:.1f}s "
              f"({n_real / dt:.3f} img/s)", flush=True)

    for group, pads in zip(groups, pad_plan):
        n_real = sum(1 for j in group if not j.get("pad"))
        box_counts = [len(j["spec"]["gen_boxes"]) for j in group]
        failed = False
        try:
            results = run_batch_fn(
                [j["spec"] for j in group], bundle,
                bg_seeds=[j["bg_seed"] for j in group],
                fg_seed_starts=[j["fg_seed_start"] for j in group],
                segmenter=segmenter, defer_fetch=pipeline,
                **(pads or {}), **run_kwargs)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            print(f"***Batch error: {e}***")
            traceback.print_exc()
            if args.no_continue_on_error:
                if pending is not None:  # don't lose the finished batch
                    flush(pending)
                raise
            failed = True
        if pending is not None:
            flush(pending)
            pending = None
        if failed:
            continue
        entry = (group, results, pads, box_counts, n_real)
        if pipeline:
            pending = entry
        else:
            flush(entry)
    if pending is not None:
        flush(pending)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
