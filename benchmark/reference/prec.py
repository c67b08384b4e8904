"""The precision the plain reference computes in.

`Prec("f32")` is the reference itself: float32 with TF32 off. The two
controls compute the same reference one precision lower, as the check's
control is defined: for a bfloat16 configuration `Prec("fp8")` (every matmul,
convolution and attention-product operand, and every input of a judged
stage, rounded to float8 e4m3 with a per-tensor scale) or `Prec("int8")`
(the same operands as symmetric int8 with a per-tensor scale), and for a
float32 one `Prec("tf32")` (the same operands rounded to TF32's 10-bit
mantissa). In a
backward the gradients entering each product are rounded too (float8 e5m2,
or TF32), so that the control's backward runs at its precision as well. The
rounding is explicit, so a control reads the same on the CPU and on the
card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("f32", "tf32", "fp8", "int8")
FP8_MAX = 448.0


def full_f32() -> None:
    """float32 matmuls and convolutions without TF32 (the reference's
    precision on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient."""

    @staticmethod
    def forward(ctx, x, prec):
        ctx.prec = prec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.prec.round(g, grad=True), None


class Prec:
    def __init__(self, mode: str = "f32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    @torch.no_grad()
    def round(self, x: torch.Tensor, grad: bool = False) -> torch.Tensor:
        """x rounded to this precision: TF32's mantissa, float8 with a
        per-tensor scale (e4m3 for values, e5m2 for gradients), or int8
        with a per-tensor scale."""
        x = x.float()
        if self.mode == "f32":
            return x
        if self.mode == "tf32":
            bits = x.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        if self.mode == "int8":
            scale = x.abs().amax().clamp_min(1e-30) / 127.0
            return torch.round(x / scale).clamp(-127, 127) * scale
        dtype, top = (torch.float8_e5m2, 57344.0) if grad else (torch.float8_e4m3fn, FP8_MAX)
        scale = x.abs().amax().clamp_min(1e-30) / top
        return (x / scale).to(dtype).float() * scale

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to this precision (float32 out); the gradient passes
        straight through."""
        x = x.float()
        if self.mode == "f32":
            return x
        return x + (self.round(x) - x).detach()

    def _out(self, y):
        """A product's result, whose gradient the backward rounds as well:
        the lower-precision backward products take rounded operands too."""
        if self.mode == "f32" or not y.requires_grad:
            return y
        return _RoundGrad.apply(y, self)

    def linear(self, x, w, b=None):
        y = self._out(torch.matmul(self.q(x), self.q(w).t()))
        return y if b is None else y + b.float()

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self._out(F.conv2d(self.q(x), self.q(w), None if b is None else b.float(),
                                  stride=stride, padding=padding))

    def conv_t(self, x, w, b, stride):
        return self._out(F.conv_transpose2d(self.q(x), self.q(w), b.float(), stride=stride))

    def mm(self, a, b):
        return self._out(torch.matmul(self.q(a), self.q(b)))
