"""Faults planted under the timed path, to show that the output check
catches them: the CPU tests plant them at the tiny size, and
`benchmark/control.py --fault <name>` reads them at a cell's own size.

Each fault patches the program's module attributes for the duration of a
`with` block:

- unchanged_step: the DDIM update returns its state unchanged;
- half_batch: the UNet's second half of the batch left out, its rows
  filled from the first half;
- altered_image: every decoded image altered where it is produced;
- shifted_token: the guidance tables' token positions one token late;
- shifted_mask: the latent mask kept from the segmenter one pixel to the
  right (an off-by-one in its resize);
- train_unchanged: the optimizer step leaves the parameters as they were;
- train_half_batch: the training step sees only half of its batch, the
  mean taken over those rows;
- train_altered_gradient: the gradients scaled before the update.

No cell spans chips, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    # The raw attribute, so that a staticmethod goes back as one.
    orig = vars(owner)[name] if isinstance(owner, type) else getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield orig
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def unchanged_step():
    from lmdx_torch.core import schedule

    with _patched(schedule, "ddim_step", lambda sched, eps, t, prev_t, sample: sample):
        yield


@contextlib.contextmanager
def half_batch():
    from lmdx_torch.nn import unet as unetlib

    orig = unetlib.UNet2DCondition.forward

    def forward(self, sample, *args, **kwargs):
        out = orig(self, sample, *args, **kwargs)
        n = sample.shape[0]
        if out is None or n < 2:
            return out
        half = (n + 1) // 2
        return torch.cat([out[:half], out[: n - half]], dim=0)

    with _patched(unetlib.UNet2DCondition, "forward", forward):
        yield


@contextlib.contextmanager
def altered_image():
    from lmdx_torch.nn import vae

    orig = vae.to_uint8
    with _patched(vae, "to_uint8", lambda images: 255 - orig(images)):
        yield


@contextlib.contextmanager
def shifted_token():
    from lmdx_torch.sampling import guidance

    orig = guidance.make_guidance_data

    def make(bboxes, object_positions, *args, **kwargs):
        return orig(bboxes, [[p + 1 for p in pos] for pos in object_positions], *args, **kwargs)

    with _patched(guidance, "make_guidance_data", make):
        yield


@contextlib.contextmanager
def shifted_mask():
    import numpy as np

    from lmdx_torch.sampling import masking

    orig = masking.select_mask

    def select(*args):
        mask = orig(*args)
        out = np.zeros_like(mask)
        out[:, 1:] = mask[:, :-1]
        return out

    with _patched(masking, "select_mask", select):
        yield


@contextlib.contextmanager
def train_unchanged():
    from lmdx_torch.training import train

    with _patched(train.AdamW, "update", staticmethod(lambda optimizer: None)):
        yield


@contextlib.contextmanager
def train_half_batch():
    from lmdx_torch.training import train

    orig = train._make_step

    def make(unet, optimizer, alphas, objs_fn, mesh):
        step = orig(unet, optimizer, alphas, objs_fn, mesh)

        def half(state, batch):
            n = batch["x0"].shape[0]
            return step(state, {k: v[: max(n // 2, 1)] for k, v in batch.items()})
        return half

    with _patched(train, "_make_step", make):
        yield


@contextlib.contextmanager
def train_altered_gradient():
    from lmdx_torch.training import train

    orig = train.AdamW.update          # the plain function of the staticmethod

    def update(optimizer):
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    p.grad.mul_(3.0)
        orig(optimizer)

    with _patched(train.AdamW, "update", staticmethod(update)):
        yield


GENERATION = ("unchanged_step", "half_batch", "altered_image", "shifted_token",
              "shifted_mask")
TRAINING = ("train_unchanged", "train_half_batch", "train_altered_gradient")
