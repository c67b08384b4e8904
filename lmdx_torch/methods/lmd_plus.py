"""LMD+: LMD with GLIGEN's gated self-attention grounding on one layout (port
of the JAX package's methods/lmd_plus.py): both passes run GLIGEN scheduled
sampling (beta 0.4), per-box guidance is off (max_index_step 0), masks are
box-prompted, and alignment is off with horizontal-only shifts.
"""

from __future__ import annotations

from ..text.template import DEFAULT_OVERALL_NEGATIVE_PROMPT, DEFAULT_SO_NEGATIVE_PROMPT
from . import base
from ._grounded import GroundedParams, run_grounded

version = "lmd_plus"


def run(spec, bundle, segmenter=None, **overrides) -> base.GenerationResult:
    """LMD+ defaults; `overrides` are GroundedParams fields and win."""
    defaults = dict(
        so_negative_prompt=DEFAULT_SO_NEGATIVE_PROMPT,
        overall_negative_prompt=DEFAULT_OVERALL_NEGATIVE_PROMPT,
        use_gligen=True,
        so_gligen_scheduled_sampling_beta=0.4,
        overall_gligen_scheduled_sampling_beta=0.4,
        max_index_step=0,
        so_center_box=False,
        so_horizontal_center_only=True,
        fg_blending_ratio=0.1,
        align_with_overall_bboxes=False,
        horizontal_shift_only=True,
    )
    params = GroundedParams(**{**defaults, **overrides})
    return run_grounded(spec, bundle, params, segmenter=segmenter)
