"""Model FLOPs of the traced window over the window times the dtype's peak;
FLOPs from the plain reference at the calls' shapes (model-step layer)."""

from benchmark.metrics._shares import mfu_pct


def read(view):
    return mfu_pct(view)
