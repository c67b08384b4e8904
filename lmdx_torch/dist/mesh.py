"""Device meshes and tensor-split layouts over torch.distributed (port of the
JAX package's dist/mesh.py).

One process drives one card (or the CPU). The processes form a
("dp", "tp") mesh:

- ``dp`` (data parallel): images and training examples are split over the
  dp rows; every row holds the whole model.
- ``tp`` (tensor parallel): the transformer matmuls of the UNet and the
  CLIP towers are split Megatron-style over the ranks of a tp row.
  Attention q/k/v, the MLP up-projections (GEGLU's `net.0.proj`, CLIP's
  `fc1`) and the time embedding's `linear_1` are column-split (each rank
  holds its share of the output features, attention by whole heads);
  attention out, the MLP down-projections and `linear_2` are row-split (each
  rank holds its share of the input features; the partial products are
  all-reduced and the bias is added once, after the sum). Convolutions,
  norms, embeddings and every other weight stay whole.

GSPMD places the collectives on the JAX side; here the split modules call
their `TensorSplit` at three places:

- `copy_in`: a column-split layer's input. Identity forward; the
  gradient is all-reduced backward, so the gradient that leaves the layer
  holds every rank's heads, not only the local ones.
- `reduce_out`: a row-split layer's output. All-reduce forward, identity
  backward.
- `gather_heads`: the probability maps a tapped cross-attention exports
  (B, heads, n, L), all-gathered over heads, so the guidance losses, the
  masks and the reference maps downstream see every head as without a
  mesh. Backward it keeps the rank's own slice of the gradient: every rank
  computes the same loss from the same gathered maps, so a sum over the
  ranks would multiply the guidance step by tp.

A pair that tp cannot split stays whole on every rank: an attention whose
heads tp does not divide (SD2.1's 5 heads at level 0 at tp 2, the VAE's
single head), PositionNet's `linears.0` (it has no row-split partner). The
result is the same; only the placement differs, and `param_spec` says which.

Every tensor-split result is the unsplit model's weights, split
(`shard_params` slices a whole module): shards are never initialised on
their own, so random weights, `from_jax_params` and `load_bundle` give the
same model at every tp.

Collectives take the tensors where they lie: NCCL on the cards; gloo on the
CPU, and for several ranks on one card (NCCL refuses a duplicate device),
where torch's gloo has a CUDA form of every collective the port uses
(all_reduce, all_gather, broadcast; measured on torch 2.11, it copies
through the host itself). All-reduces add the partial sums in float32 and
return the input's dtype.
"""

from __future__ import annotations

import copy
import os
import re
import socket
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..nn.attention import CrossAttention, FeedForward, Linear
from ..nn.blocks import TimestepEmbedding
from ..nn.clip import CLIPAttention, CLIPMLP

COLUMN, ROW, WHOLE = "column", "row", "whole"

# The JAX package's leaf-path rules on the port's diffusers / transformers
# names: what a tp mesh splits, column (output features) or row (input
# features; the bias stays whole).
_COLUMN_SPLIT = re.compile(
    r"(to_q|to_k|to_v|q_proj|k_proj|v_proj|fc1|net\.0\.proj|linear_1|linears\.0)"
    r"\.(weight|bias)$")
_ROW_SPLIT = re.compile(r"(to_out\.0|out_proj|fc2|net\.2|linear_2)\.weight$")


@dataclass(frozen=True)
class _Plan:
    """A module whose column / row pair tp may split: its column-split
    children, the number of equal chunks each of their outputs holds (GEGLU's
    `proj` is (h, gate): each rank takes its slice of both), its row-split
    child, and the count of units (heads, features) the split must divide."""

    columns: tuple[str, ...]
    chunks: int
    row: str
    units: object  # module -> int


_PLANS = {
    CrossAttention: _Plan(("to_q", "to_k", "to_v"), 1, "to_out.0", lambda m: m.heads),
    CLIPAttention: _Plan(("q_proj", "k_proj", "v_proj"), 1, "out_proj", lambda m: m.heads),
    FeedForward: _Plan(("net.0.proj",), 2, "net.2", lambda m: m.net[0].proj.out_features // 2),
    CLIPMLP: _Plan(("fc1",), 1, "fc2", lambda m: m.fc1.out_features),
    TimestepEmbedding: _Plan(("linear_1",), 1, "linear_2", lambda m: m.linear_1.out_features),
}

# Set by initialize_multihost: the card (or the CPU) of this process.
_PROCESS_DEVICE: torch.device | None = None


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         device=None) -> bool:
    """Join the processes of a mesh: one process per card. Call once per
    process before any device use. Arguments default to LMDX_COORDINATOR
    (host:port of process 0), LMDX_NUM_PROCESSES and LMDX_PROCESS_ID.
    Returns False and starts nothing without a coordinator (a single-process
    run, the default); otherwise joins `init_process_group` at
    tcp://<coordinator> and returns True.

    The process's device is cuda:(process_id % device_count), or the CPU when
    `device` names it. The backend is nccl for a card and gloo for the CPU
    unless `backend` names one (gloo puts several ranks on one card).

    One line per card:
        LMDX_COORDINATOR=host0:8476 LMDX_NUM_PROCESSES=4 LMDX_PROCESS_ID=$i \\
            python -m lmdx_torch.cli.generate --mesh auto ...
    """
    global _PROCESS_DEVICE
    coordinator = coordinator or os.environ.get("LMDX_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = _env_int("LMDX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("LMDX_PROCESS_ID")
    if device is None or torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to join "
                               "the mesh from the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    _PROCESS_DEVICE = dev
    return True


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if not value:
        raise ValueError(f"LMDX_COORDINATOR is set but {name} is not")
    return int(value)


def arrange_devices(devices: Sequence, dp: int, tp: int) -> np.ndarray:
    """Host-aware (dp, tp) layout of device records. Pure topology math: only
    `.process_index` (the host, or the process on the JAX side) and `.id`
    are read.

    Invariants:
    - every tp group lies within ONE host, so the tensor-split collectives
      (one all-reduce per attention / MLP pair) stay on the host's links;
    - the dp axis is host-major: dp index = host * local_dp + local_row, so
      per-image work never crosses hosts.
    """
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(
            f"uneven device counts per process: "
            f"{ {p: len(v) for p, v in by_proc.items()} }")
    per = counts.pop()
    if tp > per or per % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the {per} devices of each process "
            f"(tensor parallelism rides ICI and cannot span DCN)")
    ici_dp = per // tp
    if dp != len(by_proc) * ici_dp:
        raise ValueError(
            f"dp={dp} != processes({len(by_proc)}) x ici_dp({ici_dp}) for tp={tp}")
    rows = []
    for pid in sorted(by_proc):
        ds = sorted(by_proc[pid], key=lambda d: d.id)
        rows.extend(ds[i * tp:(i + 1) * tp] for i in range(ici_dp))
    arr = np.empty((dp, tp), dtype=object)
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            arr[i, j] = d
    return arr


@dataclass(frozen=True)
class _Rank:
    """A rank as `arrange_devices` reads it: its host and its global rank."""

    id: int
    process_index: int


class TensorSplit:
    """What a tensor-split module holds: its tp group, its place in it and
    the group's global ranks in mesh order."""

    def __init__(self, group, rank: int, size: int, members: Sequence[int]):
        self.group, self.rank, self.size = group, rank, size
        self.members = tuple(members)

    def __deepcopy__(self, memo):
        return self

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self)

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherHeads.apply(x, self)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.split.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        return all_reduce(x, split.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split):
        ctx.split, ctx.local = split, x.shape[1]
        return torch.cat(all_gather(x, split.group, split.members), dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.split.rank * ctx.local, ctx.local).contiguous(), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, added in float32; `x`'s dtype."""
    y = x.detach().to(torch.float32, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group, members: Sequence[int]) -> list[torch.Tensor]:
    """Every member's `x`, in the order of `members` (global ranks)."""
    y = x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in members]
    dist.all_gather(parts, y, group=group)
    return [parts[dist.get_group_rank(group, m)] for m in members]


def all_gather_object(obj, group, members: Sequence[int]) -> list:
    """Every member's picklable `obj`, in the order of `members`."""
    parts = [None] * len(members)
    dist.all_gather_object(parts, obj, group=group)
    return [parts[dist.get_group_rank(group, m)] for m in members]


def from_rank0(obj):
    """Global rank 0's `obj` on every rank (`obj` itself without a process
    group): decisions read from the disk (the run directory, the resume
    state) are taken once, so every rank runs the same work."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def is_writer() -> bool:
    """True on the one process that writes files: global rank 0, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ("dp", "tp") mesh of global ranks and this process's groups in it."""

    ranks: np.ndarray          # (dp, tp) global ranks
    rank: int                  # this process's global rank
    device: torch.device
    dp_group: object           # this rank's column: the ranks that share its tp index
    tp_group: object           # this rank's row: the ranks that hold one model
    owns_world: bool           # the one-rank group was started by make_mesh

    @property
    def shape(self) -> dict:
        return {"dp": self.ranks.shape[0], "tp": self.ranks.shape[1]}

    @property
    def dp(self) -> int:
        return self.ranks.shape[0]

    @property
    def tp(self) -> int:
        return self.ranks.shape[1]

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def dp_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 0])

    @property
    def tp_index(self) -> int:
        return int(np.argwhere(self.ranks == self.rank)[0, 1])

    @property
    def dp_members(self) -> list[int]:
        return [int(r) for r in self.ranks[:, self.tp_index]]

    @property
    def tp_members(self) -> list[int]:
        return [int(r) for r in self.ranks[self.dp_index]]

    def split(self) -> TensorSplit:
        return TensorSplit(self.tp_group, self.tp_index, self.tp, self.tp_members)

    def close(self) -> None:
        """Ends the one-rank group make_mesh started (nothing otherwise)."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(dp: int | None = None, tp: int | None = None, device=None) -> Mesh:
    """Build a ("dp", "tp") mesh over every rank of the process group.

    With neither axis size given: tp=1, dp=#ranks (the LMD workload is
    embarrassingly data-parallel). Every rank must call it, in the same
    order. A process without a group (no `initialize_multihost`) gets a 1x1
    mesh over a one-rank group on localhost (nccl on a card, gloo on the
    CPU), so the same code runs; `Mesh.close` ends that group. `device`
    defaults to the process's card."""
    owns = not dist.is_initialized()
    if owns:
        dev = torch.device(device) if device is not None else _default_device()
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    else:
        dev = (torch.device(device) if device is not None
               else _PROCESS_DEVICE or _default_device())
    n, rank = dist.get_world_size(), dist.get_rank()
    if dp is None and tp is None:
        dp, tp = n, 1
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} ranks")
    hosts = [socket.gethostname()]
    if n > 1:
        hosts = [None] * n
        dist.all_gather_object(hosts, socket.gethostname())
    if len(set(hosts)) > 1:
        # Several hosts: tp inside a host, dp host-major.
        order = list(dict.fromkeys(hosts))
        grid = arrange_devices([_Rank(r, order.index(h)) for r, h in enumerate(hosts)], dp, tp)
        ranks = np.vectorize(lambda r: r.id)(grid).astype(np.int64)
    else:
        ranks = np.arange(n).reshape(dp, tp)
    # Every rank creates every group, in one order.
    tp_groups = [dist.new_group([int(r) for r in row]) for row in ranks]
    dp_groups = [dist.new_group([int(r) for r in col]) for col in ranks.T]
    i, j = (int(a) for a in np.argwhere(ranks == rank)[0])
    return Mesh(ranks=ranks, rank=rank, device=dev, dp_group=dp_groups[j],
                tp_group=tp_groups[i], owns_world=owns)


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to build the "
                           "mesh on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _split_owners(module: nn.Module, tp: int):
    """(name, owner, plan) of every module whose pair tp splits."""
    for name, owner in module.named_modules():
        plan = _PLANS.get(type(owner))
        if plan is not None and tp > 1 and plan.units(owner) % tp == 0:
            yield name, owner, plan


def _join(*parts: str) -> str:
    return ".".join(p for p in parts if p)


def param_spec(module: nn.Module, tp: int) -> dict[str, str]:
    """{parameter name: "column" | "row" | "whole"} of `module` on a mesh
    of tensor-split size `tp`.

    A name the JAX package's rules split (`_COLUMN_SPLIT`, `_ROW_SPLIT`)
    keeps its kind where tp splits its pair (an attention by whole heads,
    an MLP by features) and is whole where it cannot: the whole-kept layers
    of the module docstring. Every other parameter is whole."""
    splittable = set()
    for name, _, plan in _split_owners(module, tp):
        for child in plan.columns:
            splittable |= {_join(name, child, "weight"), _join(name, child, "bias")}
        splittable.add(_join(name, plan.row, "weight"))
    spec = {}
    for name, _ in module.named_parameters():
        kind = (COLUMN if _COLUMN_SPLIT.search(name) else
                ROW if _ROW_SPLIT.search(name) else WHOLE)
        spec[name] = kind if name in splittable else WHOLE
    return spec


def _column_rows(n_out: int, chunks: int, rank: int, size: int) -> torch.Tensor:
    """The output rows a column-split rank holds: its slice of each chunk."""
    per, local = n_out // chunks, n_out // chunks // size
    return torch.cat([torch.arange(c * per + rank * local, c * per + (rank + 1) * local)
                      for c in range(chunks)])


class RowSplitLinear(Linear):
    """A row-split Linear: the rank's columns of the weight (its share of
    the input features). The partial products are all-reduced over the tp
    group and the whole bias is added once, after the sum."""

    def __init__(self, linear: nn.Linear, split: TensorSplit):
        nn.Module.__init__(self)
        n = linear.in_features // split.size
        self.in_features, self.out_features = n, linear.out_features
        w = linear.weight.detach()[:, split.rank * n:(split.rank + 1) * n].clone()
        self.weight = nn.Parameter(w, requires_grad=linear.weight.requires_grad)
        self.register_parameter("bias", linear.bias)
        self.split = split

    def forward(self, x):
        y = self.split.reduce_out(F.linear(x.to(self.weight.dtype), self.weight))
        return y if self.bias is None else y + self.bias


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """The module with every pair tp can split replaced by the rank's
    shards: a copy; `module` is left as it was. Without anything to split
    (tp 1, or a module of whole layers only) it is `module` itself."""
    owners = [(name, plan) for name, _, plan in _split_owners(module, mesh.tp)]
    if not owners:
        return module
    split = mesh.split()
    out = copy.deepcopy(module)
    for name, plan in owners:
        owner = out.get_submodule(name) if name else out
        for child in plan.columns:
            lin = owner.get_submodule(child)
            rows = _column_rows(lin.out_features, plan.chunks, split.rank, split.size)
            lin.weight = nn.Parameter(lin.weight.detach()[rows.to(lin.weight.device)],
                                      requires_grad=lin.weight.requires_grad)
            if lin.bias is not None:
                lin.bias = nn.Parameter(lin.bias.detach()[rows.to(lin.bias.device)],
                                        requires_grad=lin.bias.requires_grad)
            lin.out_features = len(rows)
        parent, _, leaf = plan.row.rpartition(".")
        holder = owner.get_submodule(parent) if parent else owner
        setattr(holder, leaf, RowSplitLinear(owner.get_submodule(plan.row), split))
        owner.tp_split = split
        if hasattr(owner, "heads"):
            owner.heads //= split.size
    return out


def split_params(module: nn.Module) -> dict[str, tuple]:
    """{parameter name: (TensorSplit, kind, chunks)} of every parameter
    `shard_params` split in `module` (empty for an unsplit module)."""
    out = {}
    for name, owner in module.named_modules():
        split = getattr(owner, "tp_split", None)
        if split is None:
            continue
        plan = _PLANS[type(owner)]
        for child in plan.columns:
            for leaf in ("weight", "bias"):
                out[_join(name, child, leaf)] = (split, COLUMN, plan.chunks)
        out[_join(name, plan.row, "weight")] = (split, ROW, 1)
    return out


def whole_tensor(entry, t: torch.Tensor) -> torch.Tensor:
    """The unsplit tensor of a split parameter's shard `t` (or of anything
    shaped like it, such as Adam's moments), gathered over its tp group;
    `t` itself when `entry` (from `split_params`) is None."""
    if entry is None or t.dim() == 0:
        return t
    split, kind, chunks = entry
    parts = all_gather(t, split.group, split.members)
    if kind == ROW:
        return torch.cat(parts, dim=1)
    return torch.cat([p.chunk(chunks)[c] for c in range(chunks) for p in parts])


def local_tensor(entry, t: torch.Tensor) -> torch.Tensor:
    """The rank's shard of the unsplit tensor `t` (the inverse of
    `whole_tensor`), a copy; `t` itself when `entry` is None."""
    if entry is None or t.dim() == 0:
        return t
    split, kind, chunks = entry
    if kind == ROW:
        n = t.shape[1] // split.size
        return t[:, split.rank * n:(split.rank + 1) * n].clone()
    rows = _column_rows(t.shape[0], chunks, split.rank, split.size)
    return t[rows.to(t.device)].clone()


def batch_spec(ndim: int = 4) -> tuple:
    """Leading-axis data-parallel layout of activations and latents."""
    return ("dp",) + (None,) * (ndim - 1)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(tree, mesh: Mesh):
    """This dp rank's share of a batch tree on the mesh's device: each
    leaf's leading axis split over dp (a leaf whose leading dim does not
    divide dp, or a scalar, is whole on every rank)."""
    dp, i = mesh.dp, mesh.dp_index

    def put(x):
        x = torch.as_tensor(x)
        if x.dim() >= 1 and x.shape[0] % dp == 0:
            n = x.shape[0] // dp
            x = x[i * n:(i + 1) * n]
        return x.to(mesh.device)

    return _map(tree, put)


def replicate(tree, mesh: Mesh):
    """The whole tree on every rank, on the mesh's device."""
    return _map(tree, lambda x: torch.as_tensor(x).to(mesh.device))


def mean_over_dp(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Replaces each tensor by its mean over the dp group, in place (one
    float32 all-reduce of all of them together)."""
    if mesh.dp == 1 or not tensors:
        return
    flat = all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]), mesh.dp_group)
    flat /= mesh.dp
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
