"""Share of the traced window inside the guidance loop of a sampler step: CA-
energy gradients through the early-exit UNet (sampler layer)."""

from benchmark.metrics._shares import guidance_pct


def read(view):
    return guidance_pct(view)
