#!/usr/bin/env python3
"""What one GLIGEN adapter training step of the port holds on a CUDA card,
what its bf16 casts cost, and how far its bf16 gradients lie from its
float32 ones. The step is `chip_smoke.py` phase 15's: the SD1.4+GLIGEN UNet
with random weights from seed 0, every fuser's gates opened to
`TRAIN_GATES`, 512x512 latents at batch 2 (`_train_batch`), the adapter
mask, AdamW at lr 1e-4; first in float32, then in bf16 over float32 masters.

    python3 scripts/torch_train_memory.py [--steps 3] [--out chiprun_out/train_memory.json]

For each mode the step is taken --steps times. On the last one (Adam's
moments then exist, as in every later step) the script records
- the memory allocated before the step, at the end of the UNet's forward
  (a forward hook), and the step's peak (`torch.cuda.max_memory_allocated`);
- every tensor autograd saves for the backward (`saved_tensors_hooks`), each
  storage once, summed by what it is: a parameter (a float32 master), a
  parameter's cast (`train.compute_params`), or an activation, by dtype and
  by the operation that made it (its `grad_fn`, "none" where it needs no
  gradient);
- the device time of `compute_params` alone (CUDA events, with autograd on,
  as the step calls it).
The first step's gradients (the same float32 state and batch in both modes)
are compared tensor by tensor: ||g_bf16 - g_f32|| / ||g_f32||, and the
first losses. Prints a summary and writes the numbers as JSON to --out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = 2**30


def _tally(unet, train):
    """Saved-tensor hooks and a recording `compute_params` for one step:
    returns (hooks, saved, undo); saved maps a storage's address to
    (kind, bytes)."""
    import torch

    masters = {p.untyped_storage().data_ptr() for p in unet.parameters()}
    casts: set = set()
    saved: dict = {}
    plain = train.compute_params

    def recording(module, dtype):
        out = plain(module, dtype)
        casts.update(t.untyped_storage().data_ptr() for t in out.values())
        return out

    def pack(t):
        storage = t.untyped_storage()
        ptr = storage.data_ptr()
        if ptr not in saved:
            dtype = str(t.dtype).removeprefix("torch.")
            if ptr in masters:
                kind = "parameter, float32 master"
            elif ptr in casts:
                kind = f"parameter cast to {dtype}"
            else:
                made_by = t.grad_fn.name() if t.grad_fn is not None else "none"
                kind = f"activation {dtype}, made by {made_by}"
            saved[ptr] = (kind, storage.nbytes())
        return t

    train.compute_params = recording

    def undo():
        train.compute_params = plain

    return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), saved, undo


def _grad_gaps(g16: dict, g32: dict) -> dict:
    import torch

    return {n: float(torch.linalg.vector_norm(g16[n] - w) / torch.linalg.vector_norm(w))
            for n, w in g32.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "train_memory.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_train_memory: no CUDA device is available")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from lmdx_torch.config import SD_CONFIGS
    from lmdx_torch.core.schedule import make_alphas_cumprod
    from lmdx_torch.nn.attention import GatedSelfAttention
    from lmdx_torch.runtime import models
    from lmdx_torch.training import train

    card = cs.gpu_name_and_limit()
    print(f"gpu: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    key = "gligen/diffusers-generation-text-box"
    cfg = SD_CONFIGS[key]()
    alphas = make_alphas_cumprod()
    batch = cs._train_batch(key)
    result = {"card": card, "steps": args.steps, "modes": {}}
    first = {}
    for dtype_name in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        unet = models.build_train_unet(dataclasses.replace(cfg, dtype=dtype_name), seed=0,
                                       device="cuda")
        with torch.no_grad():
            for m in unet.modules():
                if isinstance(m, GatedSelfAttention):
                    m.alpha_attn.fill_(cs.TRAIN_GATES[0])
                    m.alpha_dense.fill_(cs.TRAIN_GATES[1])
        opt = train.make_optimizer(1e-4, trainable_mask=train.gligen_adapter_mask(unet))
        step = train.make_train_step(unet, opt, alphas, objs_fn=lambda _, b: b["objs"])
        state = train.init_train_state(unet, opt)
        losses, marks = [], {}
        for i in range(args.steps):
            if i == args.steps - 1:
                torch.cuda.synchronize()
                marks["before"] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()

                def forward_end(*_):
                    marks["forward_end"] = torch.cuda.memory_allocated()

                hook = unet.register_forward_hook(forward_end)
                hooks, saved, undo = _tally(unet, train)
                with hooks:
                    state, loss = step(state, batch)
                torch.cuda.synchronize()
                undo()
                hook.remove()
                marks["peak"] = torch.cuda.max_memory_allocated()
            else:
                state, loss = step(state, batch)
            losses.append(float(loss))
            if i == 0:
                first[dtype_name] = {n: p.grad.detach().float().cpu()
                                     for n, p in unet.named_parameters() if p.grad is not None}
        named = dict(unet.named_parameters())
        trained = [p for p in named.values() if p.requires_grad]
        held = {
            "parameters (float32 masters)": sum(p.nbytes for p in named.values()),
            "gradients": sum(p.grad.nbytes for p in trained if p.grad is not None),
            "Adam moments": sum(t.nbytes for s in state.opt_state.state.values()
                                for t in s.values() if torch.is_tensor(t) and t.dim()),
            "batch": sum(v.nbytes for v in batch.values()),
        }
        kinds: dict = {}
        for kind, nbytes in saved.values():
            kinds[kind] = kinds.get(kind, 0) + nbytes
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        dtype = unet.compute_dtype
        train.compute_params(unet, dtype)
        torch.cuda.synchronize()
        start.record()
        for _ in range(5):
            train.compute_params(unet, dtype)
        stop.record()
        torch.cuda.synchronize()
        mode = {
            "losses": losses,
            "before_gib": marks["before"] / GIB,
            "forward_end_gib": marks["forward_end"] / GIB,
            "peak_gib": marks["peak"] / GIB,
            "held_gib": {k: v / GIB for k, v in held.items()},
            "saved_gib": sum(kinds.values()) / GIB,
            "saved_by_kind_gib": {k: v / GIB for k, v in
                                  sorted(kinds.items(), key=lambda kv: -kv[1])},
            "compute_params_ms": start.elapsed_time(stop) / 5,
        }
        result["modes"][dtype_name] = mode
        print(f"\n{dtype_name}: losses {losses}", flush=True)
        print(f"  allocated before the step {mode['before_gib']:.3f} GiB, at the forward's end "
              f"{mode['forward_end_gib']:.3f}, peak {mode['peak_gib']:.3f}; compute_params "
              f"{mode['compute_params_ms']:.3f} ms", flush=True)
        for k, v in mode["held_gib"].items():
            print(f"  held: {k}: {v:.3f} GiB")
        print(f"  saved for the backward: {mode['saved_gib']:.3f} GiB in {len(saved)} storages")
        for k, v in list(mode["saved_by_kind_gib"].items())[:20]:
            print(f"    {v:8.3f} GiB  {k}")
        del unet, opt, step, state, named, trained, saved
        torch.cuda.empty_cache()

    gaps = _grad_gaps(first["bfloat16"], first["float32"])
    ordered = sorted(gaps.items(), key=lambda kv: -kv[1])
    values = sorted(gaps.values())
    l16, l32 = (result["modes"][m]["losses"][0] for m in ("bfloat16", "float32"))
    result["first_loss_gap"] = abs(l16 - l32) / abs(l32)
    result["grad_gap"] = {"tensors": len(values), "median": values[len(values) // 2],
                          "p90": values[int(0.9 * (len(values) - 1))], "max": values[-1],
                          "worst": ordered[:15]}
    by_suffix: dict = {}
    for name, gap in gaps.items():
        suffix = name.split("fuser.")[-1]
        by_suffix[suffix] = max(by_suffix.get(suffix, 0.0), gap)
    result["grad_gap"]["max_by_parameter"] = dict(sorted(by_suffix.items(),
                                                         key=lambda kv: -kv[1]))
    print(f"\nfirst loss: bf16 {l16} vs float32 {l32} ({result['first_loss_gap']:.3e})")
    print(f"first-step gradients, ||g_bf16 - g_f32|| / ||g_f32|| over {len(values)} tensors: "
          f"median {result['grad_gap']['median']:.3e}, p90 {result['grad_gap']['p90']:.3e}, "
          f"max {values[-1]:.3e}")
    for name, gap in ordered[:15]:
        print(f"    {gap:.3e}  {name}")
    for name, gap in result["grad_gap"]["max_by_parameter"].items():
        print(f"  max {gap:.3e}  {name}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\nwrote {args.out}")


if __name__ == "__main__":
    main()
