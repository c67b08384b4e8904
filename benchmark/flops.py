"""Operations, bytes and peaks: the yardstick of the roofline and MFU
readers.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bf16, 495 TFLOP/s in TF32, so 165 TFLOP/s for float32 products computed as
3xTF32 (the program's float32 attention kernels), 3.35 TB/s of HBM3.

An attention call's least time is the larger of its operations at the peak
and its bytes at the memory rate: the forward 4 B h Lq Lk d operations and
q, k, v and o read or written once (plus the float32 LSE); the backward 10
B h Lq Lk d (S recomputed, dV, dP, dQ, dK) and q, k, v, o, dO, LSE read, dQ,
dK, dV written.

A model's operations are counted by `torch.utils.flop_counter` over the
benchmark's plain reference at the call's shapes, on the meta device, so
the count is the same whatever implements the work.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_FLOPS = 989e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12


def peak_flops(dtype: str) -> float:
    return PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_TF32X3_FLOPS


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """Least time (s) for the work: operations at `peak` or bytes at the
    memory rate, whichever is longer."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def attention_bound_s(kind: str, b, h, lq, lk, d, size, peak) -> float:
    bh = b * h
    if kind == "fwd":
        flops = 4 * bh * lq * lk * d
        nbytes = size * bh * d * (2 * lq + 2 * lk) + 4 * bh * lq
    else:
        flops = 10 * bh * lq * lk * d
        nbytes = (size * bh * d * (3 * lq + 2 * lk) + 4 * bh * lq
                  + size * bh * d * (lq + 2 * lk))
    return bound_s(flops, nbytes, peak)


def _count(fn) -> int:
    fc = FlopCounterMode(display=False)
    with fc:
        fn()
    return fc.get_total_flops()


def _meta_state(shapes: dict, grad_names=()) -> dict:
    return {n: torch.empty(s, device="meta", requires_grad=n in grad_names)
            for n, s in shapes.items()}


@functools.lru_cache(maxsize=None)
def _unet_flops(cfg_json: str, shapes_json: str, batch: int, grounded: bool, guided: bool,
                tap_names: tuple, train: bool) -> int:
    from .reference import sd
    from .reference.prec import Prec

    cfg = json.loads(cfg_json)
    shapes = {k: tuple(v) for k, v in json.loads(shapes_json).items()}
    u = cfg["unet"]
    h, w = sd.latent_hw(cfg)
    trained = {n for n in shapes if ".fuser." in n} if train else set()
    P = _meta_state(shapes, trained)
    x = torch.empty((batch, h, w, u["in_channels"]), device="meta", requires_grad=guided)
    ctx = torch.empty((batch, cfg["clip"]["max_length"], u["cross_attention_dim"]),
                      device="meta")
    objs = (torch.empty((batch, u["gligen_max_objs"], u["cross_attention_dim"]), device="meta")
            if grounded else None)

    def run():
        eps, taps = sd.unet(P, cfg, Prec("f32"), x, 500, ctx, objs, tap_names=tap_names,
                            stop_after_taps=guided)
        if guided:
            torch.autograd.grad(sum(v.sum() for v in taps.values()), x)
        elif train:
            leaves = [P[n] for n in sorted(trained)]
            torch.autograd.grad(eps.square().mean(), leaves)

    return _count(run)


def unet_flops(cfg: dict, shapes: dict, batch: int, grounded: bool, guided: bool = False,
               tap_names=(), train: bool = False) -> int:
    """Operations of one UNet call: a forward (CFG or training), or a
    guidance iteration (the early-exit forward to the last tapped block and
    its backward to the latents), or a training step (forward and the
    backward to the trained adapters)."""
    return _unet_flops(json.dumps(cfg, sort_keys=True),
                       json.dumps({k: list(v) for k, v in shapes.items()}, sort_keys=True),
                       batch, grounded, guided, tuple(tap_names), train)


def clip_flops(cfg: dict, shapes: dict, n: int) -> int:
    from .reference import sd
    from .reference.prec import Prec

    P = _meta_state(shapes)
    ids = torch.zeros((n, cfg["clip"]["max_length"]), dtype=torch.int64, device="meta")
    return _count(lambda: sd.clip_text(P, cfg, Prec("f32"), ids))


def vae_flops(cfg: dict, shapes: dict, n: int) -> int:
    from .reference import sd
    from .reference.prec import Prec

    P = _meta_state(shapes)
    z = torch.empty((n, *sd.latent_hw(cfg), cfg["vae"]["latent_channels"]), device="meta")
    return _count(lambda: sd.vae_decode(P, cfg, Prec("f32"), z))


def sam_flops(cfg: dict, shapes: dict, n: int, oh: int, ow: int) -> int:
    from .reference import sam
    from .reference.prec import Prec

    P = _meta_state(shapes)
    img = torch.empty((n, oh, ow, 3), device="meta")
    pts = torch.zeros((n, 2, 2), device="meta")
    lab = torch.zeros((n, 2), dtype=torch.int64, device="meta")
    return _count(lambda: sam.sam(P, cfg, Prec("f32"), img, pts, lab))


def window_flops(view) -> float:
    """Model operations of the traced window: every UNet call the probes
    counted (by batch, grounding, guidance and taps), the text rows encoded,
    the images segmented and decoded; for a training cell, its steps.
    PositionNet's few operations are left out."""
    cfg, driver = view.cfg, view.driver
    shapes = driver.shapes
    if driver.mix["entry"] == "train":
        return view.steps * unet_flops(cfg, shapes["unet"], driver.mix["batch"], True,
                                       train=True)
    total = 0
    for (batch, grounded, guided, taps), n in view.probes.unet_calls.items():
        total += n * unet_flops(cfg, shapes["unet"], batch, grounded, guided, taps)
    c = view.probes.counts
    if c["text_rows"]:
        total += c["text_rows"] * clip_flops(cfg, shapes["text"], 1)
    if c["decode_images"]:
        total += c["decode_images"] * vae_flops(cfg, shapes["vae"], 1)
    if c["sam_images"]:
        total += c["sam_images"] * sam_flops(cfg, shapes["sam"], 1, cfg["height"], cfg["width"])
    return float(total)
