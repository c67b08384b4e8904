"""Builds the port's CUDA sources (`lmdx_torch/csrc/*.cu`) into shared
libraries with a plain C interface, loaded with ctypes.

Each source is compiled by its own `nvcc` process for `sm_90a`; `build()`
starts them all together and waits. Libraries go to `build/kernels/` at the
repo root (listed in .gitignore), named by a digest of the sources, so an
edited source rebuilds and an unchanged one is reused. Nothing here runs at
import time: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_bwd", "sam_attention", "flash_fwd_packed",
           "flash_fwd_fusedheads", "pair_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> compiler messages of the last build in this process (ptxas -v
# register / shared-memory / spill report), for chip_smoke.py to print.
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, one nvcc
    per source, all started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def _short_kernel_name(mangled: str) -> str:
    """`flash_fwd_kernel<48,8>` from an Itanium-mangled kernel name: the
    length-prefixed identifier that ends in `_kernel` and the integer template
    arguments after it."""
    for m in re.finditer(r"\d+", mangled):
        for start in range(m.start(), m.end()):  # a hash may end in digits
            ident = mangled[m.end():m.end() + int(mangled[start:m.end()])]
            if ident.endswith("_kernel") and re.fullmatch(r"[a-z_0-9]+", ident):
                ints = re.findall(r"Li(\d+)E", mangled[m.end() + len(ident):])
                return ident + ("<" + ",".join(ints) + ">" if ints else "")
    return mangled


def ptxas_report(log: str) -> list[dict]:
    """One entry per kernel of a source's `-Xptxas -v` messages: its name
    with the integer template arguments (`flash_fwd_kernel<48,8>`: head dim,
    warps), registers a thread and spilled bytes (stores + loads)."""
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _short_kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append({"kernel": name, "registers": int(m.group(1)), "spill_bytes": spill})
            name, spill = None, 0
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
