"""Stage-2 method registry (port of the JAX package's methods/__init__.py).

Each method module exposes `version` and `run(spec, bundle, ...)` returning a
`base.GenerationResult` for one layout; `get_method` maps a --run-model name
to its module ("-" and "_" alike). `batch` holds the batched LMD and LMD+
over many layouts. BoxDiff and MultiDiffusion are not ported yet, so they
are not in the registry.
"""

from . import backward_guidance, gligen, lmd, lmd_plus, sd

METHODS = {m.version: m for m in (sd, gligen, backward_guidance, lmd, lmd_plus)}


def get_method(name: str):
    key = name.replace("-", "_")
    if key not in METHODS:
        raise KeyError(f"unknown method {name!r}; available: {sorted(METHODS)}")
    return METHODS[key]
