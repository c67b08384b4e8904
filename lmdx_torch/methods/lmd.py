"""LMD: training-free layout-grounded diffusion on one layout (port of the
JAX package's methods/lmd.py): per-box CA-guided passes, attention-prompted
mask refinement, masked latent composition with alignment, and the frozen
overall pass with CA guidance and reference-attention transfer.
"""

from __future__ import annotations

from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT, DEFAULT_SO_NEGATIVE_PROMPT
from . import base
from ._grounded import GroundedParams, run_grounded

version = "lmd"


def run(spec, bundle, segmenter=None, **overrides) -> base.GenerationResult:
    """LMD defaults: per-box guidance on, boxes centered with floor padding,
    full alignment; `overrides` are GroundedParams fields and win."""
    defaults = dict(
        so_negative_prompt=DEFAULT_SO_NEGATIVE_PROMPT,
        overall_negative_prompt=DEFAULT_OVERALL_NEGATIVE_PROMPT,
        use_gligen=False,
        max_index_step=30,
        so_center_box=True,
        so_horizontal_center_only=False,
        fg_blending_ratio=0.01,
        align_with_overall_bboxes=True,
        horizontal_shift_only=False,
    )
    params = GroundedParams(**{**defaults, **overrides})
    return run_grounded(spec, bundle, params, segmenter=segmenter)
