"""The port's tracing API (`lmdx_torch/utils/trace.py`) against the JAX
package's (`lmdx/utils/trace.py`), on the CPU.

- `trace(dir)` yields `dir` and writes one Chrome trace there, holding the
  host-side span that `annotate(name)` opened and the ops inside it; without
  a directory it writes under the temporary directory's `lmdx_trace`.
- `timed(name)` prints the JAX package's line for the same elapsed time, and
  keeps the seconds; `verbose=False` prints nothing.
"""

import json
import os
import tempfile

import pytest
import torch

from lmdx.utils import trace as jtrace
from lmdx_torch.utils import trace as ttrace


def _events(log_dir):
    files = sorted(os.listdir(log_dir))
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(os.path.join(log_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("given", [True, False], ids=["dir", "default"])
def test_trace_writes_annotated_chrome_trace(tmp_path, monkeypatch, given):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want_dir = str(tmp_path / "run") if given else str(tmp_path / "lmdx_trace")
    with ttrace.trace(want_dir if given else None) as log_dir:
        assert log_dir == want_dir
        with ttrace.annotate("train_step"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    events = _events(log_dir)
    span = [e for e in events if e.get("name") == "train_step"]
    assert len(span) == 1 and span[0]["dur"] > 0
    start, end = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    inside = [e for e in events if e.get("name") in ("aten::mm", "aten::matmul")]
    assert inside and all(start <= e["ts"] <= end for e in inside)


def test_timed_prints_the_jax_line(monkeypatch, capsys):
    lines = {}
    for name, mod in (("jax", jtrace), ("torch", ttrace)):
        clock = iter([100.0, 101.2345])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        with mod.timed("decode") as t:
            pass
        assert t.seconds == pytest.approx(1.2345)
        lines[name] = capsys.readouterr().out
    assert lines["torch"] == lines["jax"] == "[lmdx] decode: 1.234s\n"
    monkeypatch.undo()
    with ttrace.timed("quiet", verbose=False) as t:
        pass
    assert capsys.readouterr().out == "" and t.seconds >= 0.0
