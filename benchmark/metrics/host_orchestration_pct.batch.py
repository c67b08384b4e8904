"""Share of the traced window outside the spans around the sampler, the
segmenter, text encoding, grounding and decode: the host's own composition,
shifts, seeds and fetches (methods layer)."""

from benchmark.metrics._shares import host_orchestration_pct


def read(view):
    return host_orchestration_pct(view)
