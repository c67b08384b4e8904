"""Guidance iterations run in the traced window per image completed; the loop
stops at its loss threshold, so this is work done against the ladder's
maximum of 65 a pass (sampler layer)."""

from benchmark.metrics._shares import guidance_iters_per_image


def read(view):
    return guidance_iters_per_image(view)
