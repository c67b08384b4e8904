"""The arithmetic the per-layer readers share. Each reader is a file of its
own, named after its metric, with one function `read(view)` that returns the
metric's value or None where the traced window holds nothing to read."""

from __future__ import annotations

# The spans of work on the device's behalf: everything outside them is the
# host's own orchestration (composition, shifts, seeds, fetches).
MODEL_SPANS = ("sample", "segmenter", "text", "gligen", "decode")


def host_orchestration_pct(view):
    return 100.0 * (1.0 - view.span_share(MODEL_SPANS))


def guidance_pct(view):
    return 100.0 * view.span_share(("guidance",))


def guidance_iters_per_image(view):
    if not view.images:
        return None
    return view.probes.counts.get("guidance_iters", 0) / view.images


def mfu_pct(view):
    flops = view.model_flops()
    if flops <= 0:
        return None
    return 100.0 * flops / (view.window_s * view.peak())


def roofline_pct(view, kind: str):
    device_s = view.trace["attn_fwd_s" if kind == "fwd" else "attn_bwd_s"]
    bound = view.attention_bound_s(kind)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device_s


def device_idle_pct(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
