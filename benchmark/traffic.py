"""The general traffic generator. A mix is a data file,
`benchmark/traffic/<mix>.json`, that names the program entry it drives and
the parameters of its requests; this module turns it and the run's seed into
requests, the same for the same seed.

Layout mixes (`"entry"`: "batch" or "single") give calls of layouts of the
kinds that stage 1's LLM returns for the LMD benchmark's tasks:

- numeracy: n boxes of one class ("a cat" n times);
- attribution: two boxes, each a modifier and a class;
- spatial: two boxes of two classes, the first left of, right of, above or
  below the second.

The call cycle (the box count and task of every layout of every call) is
fixed by the mix and never by the seed, so every seed gives the same work;
the seed picks classes, modifiers, relations, box positions and sizes, and
the noise seeds. Box sides are drawn between the mix's limits in pixels of
the 512-pixel layout canvas. `warm_calls` is the number of the cycle's
first calls whose shapes set-up warms: those a window of the benchmark's
length starts, and one more.

A training mix (`"entry"`: "train") gives the batches' row count, the
number of batches made and the cycle of grounding boxes per row.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
CANVAS = 512


def load(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), *keys]))


def _box(rng, lo, hi, x_range=(0, CANVAS), y_range=(0, CANVAS)):
    w, h = (int(v) for v in rng.integers(lo, hi + 1, size=2))
    x0 = int(rng.integers(x_range[0], max(x_range[0], x_range[1] - w) + 1))
    y0 = int(rng.integers(y_range[0], max(y_range[0], y_range[1] - h) + 1))
    return (x0, y0, min(w, CANVAS - x0), min(h, CANVAS - y0))


def layout(mix: dict, task: str, n_boxes: int, rng) -> dict:
    """One layout spec of `task` with `n_boxes` boxes."""
    lo, hi = mix["box_side_px"]
    classes, modifiers = mix["classes"], mix["modifiers"]
    if task == "numeracy":
        cls = classes[int(rng.integers(len(classes)))]
        boxes = [(f"a {cls}", _box(rng, lo, hi)) for _ in range(n_boxes)]
        caption = f"{n_boxes} {cls}s"
    elif task == "attribution":
        if n_boxes != 2:
            raise ValueError("an attribution layout has two boxes")
        c = rng.choice(len(classes), 2, replace=False)
        m = rng.choice(len(modifiers), 2, replace=False)
        names = [f"a {modifiers[int(m[i])]} {classes[int(c[i])]}" for i in range(2)]
        boxes = [(names[0], _box(rng, lo, hi)), (names[1], _box(rng, lo, hi))]
        caption = f"{names[0]} and {names[1]}"
    elif task == "spatial":
        if n_boxes != 2:
            raise ValueError("a spatial layout has two boxes")
        c = rng.choice(len(classes), 2, replace=False)
        rel = mix["relations"][int(rng.integers(len(mix["relations"])))]
        half = CANVAS // 2
        lo_half, hi_half = (0, half), (half, CANVAS)
        first, second = {"left of": (lo_half, hi_half), "right of": (hi_half, lo_half),
                         "above": (lo_half, hi_half), "below": (hi_half, lo_half)}[rel]
        key = "x_range" if rel in ("left of", "right of") else "y_range"
        boxes = [(f"a {classes[int(c[i])]}", _box(rng, lo, min(hi, half), **{key: r}))
                 for i, r in enumerate((first, second))]
        caption = f"a {classes[int(c[0])]} {rel} a {classes[int(c[1])]}"
    else:
        raise ValueError(f"unknown task {task!r}")
    return {"prompt": caption, "gen_boxes": boxes, "bg_prompt": mix["bg_prompt"],
            "extra_neg_prompt": mix.get("extra_neg_prompt", "")}


def call(mix: dict, seed: int, k: int) -> list[dict]:
    """Call k of the mix: its layouts, each {"spec", "bg_seed", "fg_seed"}."""
    cycle = mix["cycle"]
    rng = _rng(seed, k)
    out = []
    for task, n_boxes in cycle[k % len(cycle)]:
        spec = layout(mix, task, int(n_boxes), rng)
        bg, fg = (int(v) for v in rng.integers(0, 2**31 - 1, size=2))
        out.append({"spec": spec, "bg_seed": bg, "fg_seed": fg})
    return out


def box_counts(mix: dict, k: int) -> list[int]:
    return [int(n) for _, n in mix["cycle"][k % len(mix["cycle"])]]


def train_boxes(mix: dict, row: int) -> int:
    cyc = mix["boxes_cycle"]
    return int(cyc[row % len(cyc)])
