"""Every cell runs end to end at the tiny-test size on the CPU and gives a
well-formed result: the contract's keys, its end-to-end metrics untraced and
its per-layer metrics traced, and every compared number with its limit."""

import json
import math

import pytest

from benchmark import harness
from benchmark.tests.conftest import CELLS, load

E2E = {"lmd_plus.tiny.batch4": "images_per_s", "lmd.tiny.seq": "image_latency_s",
       "train.tiny": "train_step_s"}


def _well_formed(res):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    json.dumps(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in res["device"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_untraced(cell, run_tiny):
    res = run_tiny(cell)
    _well_formed(res)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {E2E[cell], "setup_s"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_traced(cell, run_tiny):
    res = run_tiny(cell, trace=True)
    _well_formed(res)
    assert res["correct"] is True
    bench = load("bench_tiny.json")
    want = {m["name"] for m in harness.cell_metrics(bench, harness.find_cell(bench, cell), True)}
    got = set(res["metrics"])
    # The CPU has no attention kernels to time: the rooflines stay silent.
    assert got == {n for n in want if "roofline" not in n}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, m in res["metrics"].items():
        if name.endswith("pct") or name.startswith("mfu"):
            assert 0 <= m["value"] <= 100


def test_cell_metrics_follow_the_benchmark_file():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
        assert "setup_s" in e2e and len(e2e) == 2
        per = harness.cell_metrics(bench, cell, True)
        assert per and all(m["moves"] in e2e for m in per)
