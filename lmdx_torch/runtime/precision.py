"""Full float32 precision for the port's float32 entry points.

cuDNN computes float32 convolutions in TF32 by default, and PyTorch may do
the same for float32 matmuls. The JAX package's float32 function has no TF32
anywhere, so every float32 entry point of the port turns both off before it
builds or runs a float32 model: `models.load_bundle(dtype="float32")`,
`models.build_owlvit` (the stage-2 eval's detector), the CLI's
`--use_autocast 0` and the float32 training step. No bfloat16 path calls it.
"""

from __future__ import annotations

import torch


def set_full_f32() -> str:
    """No TF32 anywhere: float32 matmuls and cuDNN convolutions in full
    float32. Returns the line that says so (the CLI prints it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (f"full f32: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32}")
