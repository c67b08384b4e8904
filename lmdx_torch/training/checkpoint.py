"""Training-state checkpointing (port of the JAX package's
training/checkpoint.py, on the port's own safetensors writer).

A checkpoint is a directory:

- `params.safetensors`: every parameter of the trained module, by name, in
  its dtype (float32 masters);
- `opt.safetensors`: Adam's moments and step count of each trained
  parameter, as `<name>.exp_avg`, `<name>.exp_avg_sq` and `<name>.step`;
- `state.json`: the train step, the optimizer's hyper-parameters and the
  names of the trained parameters.

`restore` loads one into a template state of the same module and trainable
set (what `init_train_state` builds), bit for bit. The JAX package writes
orbax checkpoints instead; the port reads neither format of the other.
`latest_step_dir` finds the newest `step_<n>` directory of a run, as the JAX
function does.

A state split over a mesh (`training.train.shard_state`) is saved whole:
every rank calls `save`, the split parameters and their moments are
gathered over tp, and only global rank 0 writes. `restore` slices the whole
tensors for the template's split, so a checkpoint saved at one tp restores
at any other, bit for bit.
"""

from __future__ import annotations

import json
import os

import torch

from ..dist import mesh as meshlib
from ..runtime import safetensors_io
from .train import TrainState

_MOMENTS = ("exp_avg", "exp_avg_sq", "step")
_HYPER = ("lr", "betas", "eps", "weight_decay")


def _trained(state: TrainState) -> list[tuple[str, torch.nn.Parameter]]:
    """(name, parameter) of every parameter the optimizer holds, in its
    order."""
    names = {id(p): n for n, p in state.params.named_parameters()}
    return [(names[id(p)], p) for group in state.opt_state.param_groups
            for p in group["params"]]


def save(path: str, state: TrainState) -> None:
    path = os.path.abspath(path)
    splits = meshlib.split_params(state.params)
    params = {n: meshlib.whole_tensor(splits.get(n), t)
              for n, t in state.params.state_dict().items()}
    moments = {}
    for name, p in _trained(state):
        for key, value in state.opt_state.state.get(p, {}).items():
            if key not in _MOMENTS:
                raise ValueError(f"{name}: optimizer state {key!r} has no place in a checkpoint")
            moments[f"{name}.{key}"] = meshlib.whole_tensor(splits.get(name),
                                                            torch.as_tensor(value))
    if meshlib.is_writer():
        os.makedirs(path, exist_ok=True)
        safetensors_io.write(params, os.path.join(path, "params.safetensors"))
        safetensors_io.write(moments, os.path.join(path, "opt.safetensors"))
        (group,) = state.opt_state.param_groups
        meta = {"step": int(state.step), "trained": [n for n, _ in _trained(state)],
                "optimizer": {k: group[k] for k in _HYPER}}
        with open(os.path.join(path, "state.json"), "w") as f:
            json.dump(meta, f, indent=1)
    meshlib.barrier()


def restore(path: str, template: TrainState) -> TrainState:
    """Loads the checkpoint at `path` into `template` (its module and
    optimizer, in place) and returns the restored state."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "state.json")) as f:
        meta = json.load(f)
    trained = _trained(template)
    if meta["trained"] != [n for n, _ in trained]:
        raise ValueError(f"{path}: the checkpoint trains other parameters than the template")
    splits = meshlib.split_params(template.params)
    params = safetensors_io.read(os.path.join(path, "params.safetensors"))
    template.params.load_state_dict(
        {n: meshlib.local_tensor(splits.get(n), t) for n, t in params.items()}, strict=True)
    moments = safetensors_io.read(os.path.join(path, "opt.safetensors"))
    opt = template.opt_state.state_dict()
    opt["state"] = {}
    for i, (name, _) in enumerate(trained):
        entry = {key: meshlib.local_tensor(splits.get(name), moments[f"{name}.{key}"])
                 for key in _MOMENTS if f"{name}.{key}" in moments}
        if entry:
            opt["state"][i] = entry
    (group,) = opt["param_groups"]
    group.update({k: tuple(v) if k == "betas" else v for k, v in meta["optimizer"].items()})
    template.opt_state.load_state_dict(opt)
    return TrainState(meta["step"], template.params, template.opt_state)


def latest_step_dir(root: str) -> str | None:
    """Resume helper: newest step_* subdirectory under a run root."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda d: int(d.split("_")[1])))
