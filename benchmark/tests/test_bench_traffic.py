"""The traffic generator: the same seed gives the same requests, and the
work of every call (its layouts' box counts and tasks) is fixed by the mix,
whatever the seed."""

import json

import pytest

from benchmark import traffic
from benchmark.harness import BENCH_DIR, ROOT

MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))
LAYOUT_MIXES = [m for m in MIXES if traffic.load(m)["entry"] != "train"]
SEEDS = (0, 7, 2**31 + 12345, 987654321987)


@pytest.mark.parametrize("mix", LAYOUT_MIXES)
def test_same_seed_same_layouts(mix):
    m = traffic.load(mix)
    for k in range(2 * len(m["cycle"])):
        assert traffic.call(m, 2**31 + 5, k) == traffic.call(m, 2**31 + 5, k)
    assert traffic.call(m, 1, 0) != traffic.call(m, 2, 0)


@pytest.mark.parametrize("mix", LAYOUT_MIXES)
def test_box_cycle_does_not_depend_on_the_seed(mix):
    m = traffic.load(mix)
    for k in range(2 * len(m["cycle"])):
        want = [int(n) for _, n in m["cycle"][k % len(m["cycle"])]]
        for seed in SEEDS:
            call = traffic.call(m, seed, k)
            assert [len(c["spec"]["gen_boxes"]) for c in call] == want
            for c in call:
                assert c["spec"]["bg_prompt"] == m["bg_prompt"]
                for _, (x, y, w, h) in c["spec"]["gen_boxes"]:
                    assert 0 <= x and 0 <= y and x + w <= 512 and y + h <= 512 and w > 0 < h


def test_cell_one_has_ten_boxes_every_call():
    m = traffic.load("lmd_plus.batch4")
    for k in range(10):
        counts = traffic.box_counts(m, k)
        n = 1 + k % 5
        assert counts == [n, 2, 2, 6 - n]


def test_spatial_layouts_keep_their_relation():
    m = traffic.load("lmd.seq")
    rng = traffic._rng(3, 1)
    for _ in range(50):
        spec = traffic.layout(m, "spatial", 2, rng)
        (_, a), (_, b) = spec["gen_boxes"]
        rel = next(r for r in m["relations"] if f" {r} " in spec["prompt"])
        if rel == "left of":
            assert a[0] + a[2] <= 256 <= b[0]
        elif rel == "right of":
            assert b[0] + b[2] <= 256 <= a[0]
        elif rel == "above":
            assert a[1] + a[3] <= 256 <= b[1]
        else:
            assert b[1] + b[3] <= 256 <= a[1]


def test_every_cell_names_files_that_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{cell['traffic']}.json").exists()
        assert (BENCH_DIR / "configs" / f"{cell['config']}.json").exists()
        assert (BENCH_DIR / "limits" / f"{cell['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
