"""Hyperparameters shared by LMD and LMD+ (port of `GroundedParams` and
`_make_guidance_spec` from the JAX package's methods/_grounded.py; defaults =
LMD, LMD+ overrides in methods/batch.py). The single-image `run_grounded`
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..sampling import guidance as guidance_lib


@dataclass
class GroundedParams:
    bg_seed: int = 1
    fg_seed_start: int = 20
    overall_prompt_override: str = ""
    frozen_step_ratio: float = 0.5
    num_inference_steps: int = 50
    guidance_scale: float = 7.5

    loss_scale: float = 5.0
    loss_threshold: float = 5.0
    max_iter: object = None  # default ladder set in __post_init__
    max_index_step: int = 30
    overall_loss_scale: float = 5.0
    overall_loss_threshold: float = 5.0
    overall_max_iter: object = None
    overall_max_index_step: int = 30

    fg_top_p: float = 0.2
    bg_top_p: float = 0.2
    overall_fg_top_p: float = 0.2
    overall_bg_top_p: float = 0.2
    fg_weight: float = 1.0
    bg_weight: float = 4.0
    overall_fg_weight: float = 1.0
    overall_bg_weight: float = 4.0
    ref_ca_loss_weight: float = 2.0

    so_center_box: bool = True
    so_horizontal_center_only: bool = False
    so_vertical_placement: str = "floor_padding"
    so_floor_padding: float = 0.2
    fg_blending_ratio: float = 0.01
    align_with_overall_bboxes: bool = True
    horizontal_shift_only: bool = False
    use_fast_schedule: bool = False
    fast_rate: int = 2
    use_ref_ca: bool = True
    scheduler: str = "ddim"

    so_negative_prompt: str = ""
    overall_negative_prompt: str = ""

    use_gligen: bool = False
    so_gligen_scheduled_sampling_beta: float = 0.4
    overall_gligen_scheduled_sampling_beta: float = 0.4

    use_box_input: bool = False
    mask_th_for_point: float = 0.25

    # None -> derived from the UNet topology.
    guidance_attn_keys: tuple | None = None
    obj_attn_key: tuple | None = None
    attn_aggregation_step_start: int = 10

    def __post_init__(self):
        default_iters = [4] * 5 + [3] * 5 + [2] * 5 + [2] * 5 + [1] * 10
        if self.max_iter is None:
            self.max_iter = default_iters
        if self.overall_max_iter is None:
            self.overall_max_iter = default_iters


def _make_guidance_spec(p: GroundedParams, overall: bool) -> guidance_lib.GuidanceSpec:
    if overall:
        return guidance_lib.GuidanceSpec(
            keys=tuple(p.guidance_attn_keys),
            loss_scale=p.overall_loss_scale,
            loss_threshold=p.overall_loss_threshold,
            max_index_step=p.overall_max_index_step,
            fg_top_p=p.overall_fg_top_p,
            bg_top_p=p.overall_bg_top_p,
            fg_weight=p.overall_fg_weight,
            bg_weight=p.overall_bg_weight,
            use_ref_ca=p.use_ref_ca,
            ref_ca_loss_weight=p.ref_ca_loss_weight,
        )
    return guidance_lib.GuidanceSpec(
        keys=tuple(p.guidance_attn_keys),
        loss_scale=p.loss_scale,
        loss_threshold=p.loss_threshold,
        max_index_step=p.max_index_step,
        fg_top_p=p.fg_top_p,
        bg_top_p=p.bg_top_p,
        fg_weight=p.fg_weight,
        bg_weight=p.bg_weight,
    )
