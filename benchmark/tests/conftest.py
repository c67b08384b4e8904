"""Shared fixtures of the benchmark's CPU tests: the tiny-test configuration
and its cells, run in this process on the CPU at a short window."""

import json
from pathlib import Path

import pytest

DATA = Path(__file__).resolve().parent / "data"

# tiny cell -> its mix file under data/
CELLS = {"lmd_plus.tiny.batch4": "lmd_plus.batch4", "lmd.tiny.seq": "lmd.seq",
         "train.tiny": "train"}
# tiny cell -> the numbers its check compares
STAGES = {"lmd_plus.tiny.batch4": ("text", "gligen", "unet", "guidance", "step", "compose",
                                   "sam", "decode", "tables", "masks"),
          "lmd.tiny.seq": ("text", "unet", "guidance", "step", "compose", "sam", "decode",
                           "tables", "masks"),
          "train.tiny": ("loss", "grad", "change")}


def tiny_limits(cell):
    return {k: v for k, v in load("limits_tiny.json").items() if k in STAGES[cell]}


def load(name):
    with open(DATA / name) as f:
        return json.load(f)


@pytest.fixture
def run_tiny():
    """run_tiny(cell, seed=..., trace=..., limits=..., control=...) -> result."""
    import torch

    from benchmark import harness

    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(cell, seed=1234567890123, trace=False, limits=None, control=None, seconds=0.3):
        return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                                bench=load("bench_tiny.json"), cfg=load("tiny.json"),
                                mix=load(CELLS[cell] + ".json"),
                                limits=tiny_limits(cell) if limits is None else limits,
                                control=control, log=lambda msg: None)

    yield run
    torch.set_num_threads(threads)
