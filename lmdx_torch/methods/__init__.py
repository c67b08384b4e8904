"""Stage-2 method registry (port of the JAX package's methods/__init__.py).

Each method module exposes `version` and `run(spec, bundle, ...)` returning a
`base.GenerationResult` for one layout; `get_method` maps a --run-model name
to its module ("-" and "_" alike). The registry holds every stage-2 method of
the JAX one: SD, GLIGEN, Backward Guidance, BoxDiff, MultiDiffusion, LMD and
LMD+. `batch` holds the batched LMD and LMD+ over many layouts. The SDXL
refinement stage (`sdxl_refine` on the JAX side, on the Euler solver) is not
ported yet.
"""

from . import backward_guidance, boxdiff, gligen, lmd, lmd_plus, multidiffusion, sd

METHODS = {
    m.version: m
    for m in (sd, gligen, backward_guidance, boxdiff, multidiffusion, lmd, lmd_plus)
}


def get_method(name: str):
    key = name.replace("-", "_")
    if key not in METHODS:
        raise KeyError(f"unknown method {name!r}; available: {sorted(METHODS)}")
    return METHODS[key]
