"""Diffusion training / adapter fine-tuning step (port of the JAX package's
training/train.py, single device).

The epsilon-prediction objective that GLIGEN's adapters (PositionNet and the
gated self-attention fusers) are trained with:

    loss = E_{x0, eps, t} || UNet(sqrt(a_t) x0 + sqrt(1-a_t) eps, t, c) - eps ||^2

Design:
- The state is the UNet module itself (its parameters) and a
  `torch.optim.AdamW` over the parameters it trains, with optax's `adamw`
  constants (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay). A
  trainable mask, as `gligen_adapter_mask` gives, freezes every other
  parameter: it is set to `requires_grad_(False)` and left out of the
  optimizer, so it gets no update (optax's `set_to_zero`) and no gradient is
  computed for it; the trainable gradients are the same either way.
- Float32 parameters and optimizer state. The compute dtype is the one the
  UNet was built for (`runtime.models.build_train_unet(config)`): bfloat16
  casts every parameter but the norms' to bfloat16 at each use, as flax does
  (`torch.func.functional_call` on the cast tensors, so the gradients reach
  the float32 masters through the casts), and the flash layers then receive
  bfloat16 q/k/v: the forward and backward run kernels 1 and 2. float32
  runs in float32 throughout, on kernels 1-f32 and 2-f32, with TF32 off.
- The step runs on the device of the UNet; nothing in it waits for the
  host.
- Over a ("dp", "tp") mesh (`dist/mesh.py`): `shard_state` splits the
  float32 masters Megatron-style over tp (`mesh.shard_params`) and builds
  the AdamW after the split, its moments sliced like their parameters, so
  every moment has its shard's shape; `make_sharded_train_step` runs the
  same step on the rank's share of the batch (`mesh.shard_batch`) and
  averages the gradients and the loss over dp, which with equal shards is
  the JAX step's mean over the whole batch. The optimizer has no
  global-norm clipping, so AdamW on the shards is AdamW on the whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..dist import mesh as meshlib
from ..runtime.models import F32_PARAM_NAME_MARKERS
from ..runtime.precision import set_full_f32
from ..utils import trace

ADAPTER_SEGMENTS = ("fuser", "position_net")


class TrainState(NamedTuple):
    """step: steps taken; params: the module whose parameters are trained
    (the UNet); opt_state: the optimizer that holds Adam's moments."""

    step: int
    params: nn.Module
    opt_state: torch.optim.Optimizer


def gligen_adapter_mask(params: nn.Module) -> dict[str, bool]:
    """{parameter name: trainable} selecting only the GLIGEN grounding
    parameters (a `fuser` or `position_net` segment in the dotted name), the
    adapter fine-tuning regime."""
    return {name: any(seg in ADAPTER_SEGMENTS for seg in name.split("."))
            for name, _ in params.named_parameters()}


@dataclass(frozen=True)
class AdamW:
    """optax's `adamw`, masked, for torch modules: `init(module)` marks the
    frozen parameters and returns the `torch.optim.AdamW` over the rest;
    `update(optimizer)` applies one step from the gradients in `.grad`."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    trainable_mask: dict | None = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: nn.Module) -> torch.optim.AdamW:
        named = list(params.named_parameters())
        mask = self.trainable_mask
        if mask is not None and set(mask) != {name for name, _ in named}:
            raise ValueError("trainable_mask does not name the module's parameters")
        trainable = []
        for name, p in named:
            on = mask is None or bool(mask[name])
            p.requires_grad_(on)
            if on:
                trainable.append(p)
        return torch.optim.AdamW(trainable, lr=self.learning_rate, betas=(self.b1, self.b2),
                                 eps=self.eps, weight_decay=self.weight_decay)

    @staticmethod
    def update(optimizer: torch.optim.Optimizer) -> None:
        optimizer.step()


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.0,
                   trainable_mask: dict | None = None) -> AdamW:
    return AdamW(learning_rate, weight_decay, trainable_mask)


def init_train_state(params: nn.Module, optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def compute_params(unet: nn.Module, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The UNet's parameters as its forward uses them at `dtype`: every one
    cast, the norms' kept in float32 (the storage `cast_for_inference`
    gives a bundle). The casts stay on the autograd graph."""
    return {name: p if any(m in name for m in F32_PARAM_NAME_MARKERS) else p.to(dtype)
            for name, p in unet.named_parameters()}


def make_train_step(unet: nn.Module, optimizer, alphas_cumprod,
                    objs_fn: Callable | None = None) -> Callable:
    """Build the train step: `train_step(state, batch) -> (state, loss)`,
    the loss a 0-d float32 tensor on the UNet's device. `state.params` must
    be `unet`; the step updates it in place. The compute dtype is the one
    the UNet was built for (`unet.compute_dtype`); at float32 TF32 is turned
    off here.

    batch: dict with x0 (B, H, W, C) clean latents; noise (B, H, W, C); t
    (B,) integer train timesteps; text_embeddings (B, L, D); optionally the
    GLIGEN condition that `objs_fn(unet, batch) -> (B, M, D)` grounding
    tokens reads (without `objs_fn` the UNet runs without grounding)."""
    return _make_step(unet, optimizer, alphas_cumprod, objs_fn, mesh=None)


def make_sharded_train_step(unet: nn.Module, optimizer, alphas_cumprod, mesh,
                            objs_fn: Callable | None = None) -> Callable:
    """The train step over `mesh`: `unet` is the split module of a state
    that `shard_state` returned, `batch` the rank's share
    (`mesh.shard_batch`). After the backward the trained gradients are
    averaged over dp (one all-reduce); the returned loss is the mean over
    dp, the whole batch's loss."""
    return _make_step(unet, optimizer, alphas_cumprod, objs_fn, mesh=mesh)


def _make_step(unet, optimizer, alphas_cumprod, objs_fn, mesh):
    dtype = unet.compute_dtype
    if dtype == torch.float32:
        set_full_f32()
    device = next(unet.parameters()).device
    alphas = torch.tensor(np.asarray(alphas_cumprod, np.float32), device=device)

    def loss_fn(batch):
        # At float32 every cast is the master itself.
        with trace.annotate("cast_params"):
            params = compute_params(unet, dtype)
        with trace.annotate("forward"):
            a = alphas[torch.as_tensor(batch["t"], device=device).long()][:, None, None, None]
            noisy = torch.sqrt(a) * batch["x0"] + torch.sqrt(1.0 - a) * batch["noise"]
            objs = objs_fn(unet, batch) if objs_fn is not None else None
            eps = torch.func.functional_call(
                unet, params, (noisy, batch["t"], batch["text_embeddings"]), {"objs": objs})
            return torch.mean(torch.square(eps - batch["noise"]))

    def train_step(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        if state.params is not unet:
            raise ValueError("state.params is not the UNet this step was built for")
        with trace.annotate("train_step", request_id=state.step):
            state.opt_state.zero_grad(set_to_none=True)
            loss = loss_fn(batch)
            with trace.annotate("backward"):
                loss.backward()
            loss = loss.detach()
            if mesh is not None:
                grads = [p.grad for group in state.opt_state.param_groups
                         for p in group["params"] if p.grad is not None]
                meshlib.mean_over_dp(grads + [loss.view(1)], mesh)
            with trace.annotate("optimizer"):
                optimizer.update(state.opt_state)
        return TrainState(state.step + 1, state.params, state.opt_state), loss

    return train_step


def shard_state(state: TrainState, mesh) -> TrainState:
    """The state split over `mesh`: the module through `mesh.shard_params`
    (a copy: `state` stays as it was), a new AdamW with the same
    hyper-parameters over its trained shards, each moment the slice of its
    parameter's moment, and the same step."""
    module = meshlib.shard_params(state.params, mesh)
    splits = meshlib.split_params(module)
    old_names = {id(p): n for n, p in state.params.named_parameters()}
    old_state = {old_names[id(p)]: st for p, st in state.opt_state.state.items()}
    (group,) = state.opt_state.param_groups
    named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
    opt = torch.optim.AdamW([p for _, p in named], lr=group["lr"], betas=group["betas"],
                            eps=group["eps"], weight_decay=group["weight_decay"])
    for name, p in named:
        if name in old_state:
            opt.state[p] = {k: meshlib.local_tensor(splits.get(name), v.clone())
                            for k, v in old_state[name].items()}
    return TrainState(state.step, module, opt)
