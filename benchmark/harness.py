"""One run of one cell: set-up, the measured window, the output check, and
the result line.

Everything that belongs to one item is found by name: the cell in
`BENCHMARK.json`, its configuration in `benchmark/configs/<config>.json`,
its traffic mix in `benchmark/traffic/<traffic>.json`, the limits of its
output check in `benchmark/limits/<cell>.json`, and each per-layer metric's
reader in `benchmark/metrics/<metric>.py`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lmdx")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a checkout's first run builds; nothing that would
    pull in JAX through a library."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (`lmdx_torch` is not `lmdx`)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _finite(x: float) -> float:
    """A reading as JSON can carry it: not finite reads as the largest float."""
    return x if math.isfinite(x) else sys.float_info.max


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics, or with
    `trace` the per-layer metrics that list it (or, listing no cells, move
    one of its end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class RunView:
    """What a per-layer reader reads: the traced window, the benchmark's
    spans and counters, the device trace's reduction, the model's FLOPs."""

    def __init__(self, driver, trace: dict, t0: float, t_end: float):
        self.driver = driver
        self.cfg = driver.cfg
        self.trace = trace
        self.t0, self.t_end = t0, t_end
        self.window_s = trace["window_s"]
        self.busy_s = trace["busy_s"]
        self.probes = driver.probes
        self.images = getattr(driver, "images", 0)
        self.steps = getattr(driver, "attempted", 0)

    def span_share(self, names) -> float:
        """Share of the window (0..1) covered by the spans of `names`."""
        from .devtrace import union

        iv = [(max(a, self.t0), min(b, self.t_end)) for n, a, b in self.probes.spans
              if n in names and b > self.t0 and a < self.t_end]
        covered = sum(e - s for s, e in union(iv))
        return covered / (self.t_end - self.t0)

    def peak(self) -> float:
        from .flops import peak_flops

        return peak_flops(self.cfg["dtype"])

    def attention_bound_s(self, kind: str) -> float:
        from .flops import attention_bound_s

        return sum(attention_bound_s(k, b, h, lq, lk, d, size, self.peak())
                   for k, b, h, lq, lk, d, size in self.probes.attn_calls if k == kind)

    def model_flops(self) -> float:
        from . import flops

        return flops.window_flops(self)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             bench: dict | None = None, cfg: dict | None = None, mix: dict | None = None,
             limits: dict | None = None, t_start: float | None = None, log=None,
             control: str | None = None) -> dict:
    """Runs the cell once and returns the result line's object. `device`
    None takes the card; the other arguments replace the files (tests).
    `control` ("fp8", "int8" or "tf32") adds the control's readings on the same
    inputs under "control_checks" (`benchmark/control.py`)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = find_cell(bench, workload)
    cfg = cfg or load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    if limits is None:
        path = BENCH_DIR / "limits" / f"{workload}.json"
        limits = load_json(path) if path.exists() else {}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"the cell needs {cell['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count()}")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    from .generate import Generation
    from .training import Training

    driver_cls = Training if mix["entry"] == "train" else Generation
    driver = driver_cls(cell, cfg, mix, seed, dev, trace)
    driver.log = log
    driver.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    view = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .devtrace import reduce

        # Device activity only: the host's side is the benchmark's spans, and
        # recording every host operation would slow the window and its reading.
        acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            epoch = time.time_ns() - time.perf_counter_ns()
            out = driver.window(seconds, t0)
        reduced = reduce(prof, t0, out["end"], driver.probes.spans, epoch)
        del prof
        view = RunView(driver, reduced, t0, out["end"])
    else:
        out = driver.window(seconds, t0)
    e2e = driver.metrics(t0, out)
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    from .reference.prec import Prec, full_f32

    full_f32()
    numbers, judged, stages = driver.check(Prec("f32"))
    # The numbers the cell's limits name are compared; one the run did not
    # produce (a stage that never ran) reads as failed.
    checks = {name: {"value": _finite(numbers.get(name, math.inf)), "limit": lim}
              for name, lim in sorted(limits.items())}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            value = reader(m["name"])(view)
        else:
            value = e2e.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    # A call that fails raises, and the run ends without a result.
    result = {"correct": correct, "attempted": driver.attempted, "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = view.busy_s
        device_info["window_s"] = view.window_s
        result["breakdown"] = view.trace["breakdown"]
    per_call = out.get("per_call_s")
    if per_call:
        q = statistics.quantiles(per_call, n=4) if len(per_call) > 1 else per_call * 3
        log(f"calls {len(per_call)}: per-call seconds median {statistics.median(per_call)}, "
            f"quartiles {q[0]} {q[2]}, highest {max(per_call)} (samples {len(per_call)})")
    log(f"memory peak {peak} bytes; guidance iterations "
        f"{driver.probes.counts.get('guidance_iters', 0)}; judged requests {judged}; "
        f"stages {sorted(stages)}")
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    if control:
        result["numbers"] = numbers
        result["control_checks"] = driver.control(Prec("f32"), Prec(control))
    result["checks"] = checks
    return result
