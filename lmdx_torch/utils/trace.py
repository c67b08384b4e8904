"""Profiling and tracing (port of the JAX package's utils/trace.py, same API).

- `trace(dir)` records a torch.profiler trace of the host and, when a card
  is present, the device (CUDA kernels and copies), and writes it into `dir`
  as a Chrome trace (`trace_<pid>_<ns>.json`), which Perfetto or
  chrome://tracing open.
- `annotate(name)` marks a host-side phase inside a trace
  (`torch.profiler.record_function`).
- `timed(name)` logs a phase's wall clock without a profile, in the JAX
  package's line `[lmdx] {name}: {seconds:.3f}s`. It reads the host clock
  only: time device work with it after a `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profiles the body; yields `log_dir` (default: `lmdx_trace` under the
    temporary directory), where the trace file is written on exit."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "lmdx_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class timed:
    """with timed("phase") as t: ...; t.seconds afterwards."""

    def __init__(self, name: str, verbose: bool = True):
        self.name = name
        self.verbose = verbose
        self.seconds = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        if self.verbose:
            print(f"[lmdx] {self.name}: {self.seconds:.3f}s", flush=True)
        return False
