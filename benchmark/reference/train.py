"""Plain float32 reference of the GLIGEN adapter training step: the
epsilon-prediction loss mean((UNet(sqrt(a_t) x0 + sqrt(1 - a_t) noise, t, c,
objs) - noise)^2) over the batch, its gradient with respect to the trained
parameters (the gated self-attention fusers), and AdamW (b1 0.9, b2 0.999,
eps 1e-8, decoupled weight decay) on them. The batch is worked in blocks of
rows, the gradient summed over the blocks, so that a float32 step fits where
the program's bf16 step does.
"""

from __future__ import annotations

import torch

from . import sd
from .prec import Prec


def loss_and_grads(P: dict, trained: list[str], cfg: dict, pr: Prec, alphas: torch.Tensor,
                   batch: dict, rows: int):
    """(loss, {name: gradient}) of one batch, `rows` rows at a time."""
    n = batch["x0"].shape[0]
    grads = {name: torch.zeros_like(P[name], dtype=torch.float32) for name in trained}
    total = 0.0
    count = batch["x0"][0].numel() * n
    for s in range(0, n, rows):
        sl = slice(s, s + rows)
        a = alphas[batch["t"][sl].long()][:, None, None, None]
        noisy = (torch.sqrt(a) * batch["x0"][sl].float()
                 + torch.sqrt(1.0 - a) * batch["noise"][sl].float())
        leaves = {name: P[name].detach().float().requires_grad_(True) for name in trained}
        params = {**P, **leaves}
        with torch.enable_grad():
            eps, _ = sd.unet(params, cfg, pr, noisy, batch["t"][sl],
                             batch["text_embeddings"][sl].float(), batch["objs"][sl].float())
            part = torch.square(eps - batch["noise"][sl].float()).sum() / count
            g = torch.autograd.grad(part, [leaves[name] for name in trained])
        for name, gi in zip(trained, g):
            grads[name] += gi
        total += part.item()
    return total, grads


class AdamW:
    """torch / optax AdamW on float32 masters, one state per trained name."""

    def __init__(self, lr: float, weight_decay: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> None:
        self.t += 1
        for name, g in grads.items():
            m = self.m.setdefault(name, torch.zeros_like(g))
            v = self.v.setdefault(name, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = m / (1 - self.b1 ** self.t)
            vh = v / (1 - self.b2 ** self.t)
            p = P[name].float() * (1 - self.lr * self.wd)
            P[name] = p - self.lr * mh / (vh.sqrt() + self.eps)
