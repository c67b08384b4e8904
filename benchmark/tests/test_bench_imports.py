"""Nothing under benchmark/ imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the program; names are compared whole by
their top-level part (`lmdx_torch` is not `lmdx`)."""

import ast
import subprocess
import sys

import pytest

from benchmark.harness import BENCH_DIR, ROOT

SOURCES = sorted(BENCH_DIR.rglob("*.py"))


def _top_levels(path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_levels(path) & {"jax", "jaxlib", "flax", "lmdx"}


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "lmdx_torch" not in _top_levels(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "lmdx_torch_probe_module", sys)
    assert "lmdx_torch_probe_module" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lmdx.probe", sys)
    assert "lmdx.probe" in harness.forbidden_modules()


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "lmd.sd15_sam_f32.seq", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_cell_run_loads_no_jax(tmp_path):
    """A tiny cell run in a fresh process leaves no JAX module loaded."""
    code = (
        "import json, sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark import harness\n"
        "from benchmark.tests.conftest import load, tiny_limits\n"
        "r = harness.run_cell('lmd.tiny.seq', 5, 0.2, False, device='cpu',"
        " bench=load('bench_tiny.json'), cfg=load('tiny.json'), mix=load('lmd.seq.json'),"
        " limits=tiny_limits('lmd.tiny.seq'), log=lambda m: None)\n"
        "print(json.dumps({'found': harness.forbidden_modules(), 'correct': r['correct']}))\n"
    ) % str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"found": [], "correct": True}
