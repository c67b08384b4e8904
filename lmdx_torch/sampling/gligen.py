"""GLIGEN grounding-condition packing (port of the JAX package's
sampling/gligen.py): pad (boxes, phrase embeddings) to `max_objs` slots, mark
validity, and double for classifier-free guidance with the unconditional
half's masks zeroed. Host-side numpy; the caller runs PositionNet.
"""

from __future__ import annotations

import numpy as np


def prepare_gligen_condition(bboxes, phrase_embeddings, max_objs: int = 30,
                             num_images_per_prompt: int = 1, cfg_double: bool = True):
    """Returns (boxes (R, max_objs, 4), embeddings (R, max_objs, width),
    masks (R, max_objs)) with R = 2 * num_images_per_prompt when cfg_double
    (uncond first, masks zeroed) else num_images_per_prompt."""
    phrase_embeddings = np.asarray(phrase_embeddings, np.float32)
    width = phrase_embeddings.shape[-1]
    n = min(len(bboxes), max_objs)

    boxes = np.zeros((1, max_objs, 4), np.float32)
    embs = np.zeros((1, max_objs, width), np.float32)
    masks = np.zeros((1, max_objs), np.float32)
    if n > 0:
        boxes[0, :n] = np.asarray(bboxes, np.float32)[:n]
        embs[0, :n] = phrase_embeddings[:n]
        masks[0, :n] = 1.0

    repeat = (2 if cfg_double else 1) * num_images_per_prompt
    boxes = np.repeat(boxes, repeat, axis=0)
    embs = np.repeat(embs, repeat, axis=0)
    masks = np.repeat(masks, repeat, axis=0)
    if cfg_double:
        masks[: repeat // 2] = 0.0
    return boxes, embs, masks
