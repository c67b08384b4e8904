"""Shared method-layer plumbing (port of the JAX package's methods/base.py):
the result type, VAE decode and encode, negative-prompt handling, spec
access and the GLIGEN inputs of a single image and of the batched per-box
passes.

Every method module exposes `version` and `run(spec, bundle, ...)`
returning a `GenerationResult` (methods/__init__.py registers them).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..nn import vae as vaelib
from ..runtime import models as runtime_models
from ..runtime.models import ModelBundle
from ..sampling import gligen as gligen_lib


@dataclass
class GenerationResult:
    image: np.ndarray                      # (H, W, 3) uint8
    so_img_list: list = field(default_factory=list)  # per-box images
    aux: dict = field(default_factory=dict)


@torch.no_grad()
def decode_latents(bundle: ModelBundle, latents: torch.Tensor) -> np.ndarray:
    """Latents (B, h, w, 4) -> uint8 images (B, H, W, 3) on the host."""
    images = bundle.vae(latents.to(bundle.device))
    return vaelib.to_uint8(images).cpu().numpy()


@torch.no_grad()
def _vae_encode(bundle: ModelBundle, images: torch.Tensor, noise=None) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1] -> scaled latents (B, h, w, 4) on the
    device (the posterior mean when `noise` is None)."""
    noise = None if noise is None else torch.as_tensor(noise, device=bundle.device)
    return bundle.vae.encode(images.to(bundle.device), noise)


def encode_image(bundle: ModelBundle, image: np.ndarray, noise=None) -> torch.Tensor:
    """uint8 image (H, W, 3) -> scaled latents (1, h, w, 4)."""
    x = torch.as_tensor(np.asarray(image), dtype=torch.float32)[None] / 127.5 - 1.0
    return _vae_encode(bundle, x, noise)


def with_extra_negative(spec, negative_prompt: str) -> str:
    """Prepend the spec's extra negative prompt."""
    extra = spec.get("extra_neg_prompt") if isinstance(spec, dict) else getattr(
        spec, "extra_neg_prompt", "")
    if extra:
        return f"{extra}, {negative_prompt}"
    return negative_prompt


def spec_get(spec, key, default=None):
    if isinstance(spec, dict):
        return spec.get(key, default)
    return getattr(spec, key, default)


def make_gligen_inputs(bundle: ModelBundle, bboxes: list, phrases: list[str],
                       batch_size: int = 1):
    """GLIGEN grounding of one prompt for CFG sampling: at most
    `gligen_max_objs` boxes with their phrases' pooled embeddings (none: zero
    embeddings, every slot off). Returns (objs_full (2B, M, D),
    objs_guidance (B, M, D)): the CFG-doubled tokens with the uncond half
    nulled, and that nulled half for the guidance forwards."""
    max_objs = bundle.config.unet.gligen_max_objs
    bboxes, phrases = bboxes[:max_objs], phrases[:max_objs]
    if phrases:
        pooled = runtime_models.encode_text(bundle, phrases)[1].cpu().numpy()
    else:
        pooled = np.zeros((0, bundle.config.clip.hidden_size), np.float32)
    boxes, embs, masks = gligen_lib.prepare_gligen_condition(
        bboxes, pooled, max_objs=max_objs, num_images_per_prompt=batch_size,
        cfg_double=True)
    objs_full = runtime_models.gligen_objs(bundle, boxes, masks, embs)
    return objs_full, objs_full[:objs_full.shape[0] // 2]


def make_gligen_inputs_batched(bundle: ModelBundle, bboxes: list,
                               pooled: torch.Tensor):
    """Per-box grounding for the batched per-box passes: image i grounds only
    box i (slot 0), with `pooled` (N, D) its phrase embeddings. Returns
    (objs_full (2N, M, D), objs_guidance (N, M, D)) with the uncond half's
    grounding nulled; guidance forwards take the nulled half."""
    n = len(bboxes)
    max_objs = bundle.config.unet.gligen_max_objs
    pooled = pooled.cpu().numpy()

    boxes = np.zeros((n, max_objs, 4), np.float32)
    embs = np.zeros((n, max_objs, pooled.shape[-1]), np.float32)
    masks = np.zeros((n, max_objs), np.float32)
    boxes[:, 0] = np.asarray(bboxes, np.float32)
    embs[:, 0] = pooled
    masks[:, 0] = 1.0

    boxes2 = np.concatenate([boxes, boxes], axis=0)
    embs2 = np.concatenate([embs, embs], axis=0)
    masks2 = np.concatenate([np.zeros_like(masks), masks], axis=0)
    objs_full = runtime_models.gligen_objs(bundle, boxes2, masks2, embs2)
    return objs_full, objs_full[:n]
