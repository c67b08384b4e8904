"""Mesh-parallel serving: split the inference pipeline over a ("dp", "tp")
mesh of processes (port of the JAX package's dist/serve.py).

One process per card joins the mesh (`mesh.initialize_multihost`); each
activates it on its bundle (`activate_mesh`). The batched pipeline
(methods/batch.py) then runs each dp row's share of the images through the
unchanged pipeline and gathers every image back to every rank, in input
order; with tp > 1 each row's UNet and CLIP towers are tensor-split
(`mesh.shard_params`) and their collectives run inside the modules.
"""

from __future__ import annotations

import dataclasses
import warnings

from . import mesh as meshlib

# Set by activate_mesh(); consulted by methods/batch.py. One process drives
# one place in one mesh, so a module global matches the runtime model.
_ACTIVE_MESH: meshlib.Mesh | None = None


def active_mesh() -> meshlib.Mesh | None:
    return _ACTIVE_MESH


def parse_mesh_arg(arg: str) -> dict:
    """Parse "--mesh dp=4,tp=2" / "dp=8" / "auto" into make_mesh kwargs."""
    if arg in ("auto", ""):
        return {}
    kwargs = {}
    for part in arg.split(","):
        k, _, v = part.partition("=")
        if k not in ("dp", "tp") or not v.isdigit():
            raise ValueError(
                f"bad --mesh {arg!r}; expected e.g. 'dp=4', 'dp=4,tp=2', 'auto'")
        kwargs[k] = int(v)
    return kwargs


def activate_mesh(bundle, dp: int | None = None, tp: int | None = None):
    """Create the mesh on the bundle's device, split the bundle over it and
    mark it active. Returns (mesh, sharded_bundle); `bundle` stays usable as
    it was.

    tp == 1: every rank holds the whole bundle (pure data parallel; the
    same modules). tp > 1: the UNet's and the text towers' transformer
    matmuls are split Megatron-style (`mesh.shard_params`); the VAE and
    PositionNet stay whole."""
    global _ACTIVE_MESH
    mesh = meshlib.make_mesh(dp=dp, tp=tp, device=bundle.device)
    sharded = dataclasses.replace(
        bundle,
        unet=meshlib.shard_params(bundle.unet, mesh),
        text_encoder=meshlib.shard_params(bundle.text_encoder, mesh),
        text_encoder_2=(None if bundle.text_encoder_2 is None
                        else meshlib.shard_params(bundle.text_encoder_2, mesh)),
        position_net=(None if bundle.position_net is None
                      else meshlib.shard_params(bundle.position_net, mesh)))
    _ACTIVE_MESH = mesh
    return mesh, sharded


def deactivate_mesh():
    """Forget the active mesh; ends the one-rank group `make_mesh` started
    for a process without one."""
    global _ACTIVE_MESH
    if _ACTIVE_MESH is not None:
        _ACTIVE_MESH.close()
    _ACTIVE_MESH = None


def shard_leading_axis(x, mesh: meshlib.Mesh | None = None, axis: int = 0):
    """This dp rank's share of `x` (a list, tuple, numpy array or tensor)
    along `axis`; `x` itself without a mesh or at dp 1.

    A dim that does not divide dp is not split: every dp row then computes
    all of it, a silent 1/dp throughput loss if hit on the hot path (e.g.
    --image-batch-size not a multiple of dp), so it warns, once per
    (dim, axis, dp)."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None or mesh.dp == 1:
        return x
    dp = mesh.dp
    seq = isinstance(x, (list, tuple))
    if seq and axis != 0:
        raise ValueError("a sequence is split along axis 0 only")
    dim = len(x) if seq else (x.shape[axis] if x.ndim > axis else None)
    if dim is None or dim % dp != 0:
        sig = (dim, axis, dp)
        if sig not in _WARNED_REPLICATED:
            _WARNED_REPLICATED.add(sig)
            warnings.warn(
                f"shard_leading_axis: axis {axis} of length {dim} does not divide "
                f"dp={dp}; replicating instead of sharding (1/{dp} of the mesh's dp "
                f"throughput). Pick a batch size divisible by dp.", stacklevel=2)
        return x
    n = dim // dp
    lo, hi = mesh.dp_index * n, (mesh.dp_index + 1) * n
    if seq:
        return type(x)(x[lo:hi])
    return x[(slice(None),) * axis + (slice(lo, hi),)]


_WARNED_REPLICATED: set = set()
