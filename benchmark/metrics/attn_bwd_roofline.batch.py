"""Sum of the least times of the attention backward calls at the dispatch
(operations at the dtype's peak or bytes at 3.35 TB/s) over the device time
of the port's attention backward kernels in the traced window (kernels
layer)."""

from benchmark.metrics._shares import roofline_pct


def read(view):
    return roofline_pct(view, "bwd")
