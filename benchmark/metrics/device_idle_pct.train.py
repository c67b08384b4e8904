"""Share of the traced window with no kernel or copy on the device, from the
union of device intervals (device layer)."""

from benchmark.metrics._shares import device_idle_pct


def read(view):
    return device_idle_pct(view)
