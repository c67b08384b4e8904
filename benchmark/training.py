"""The GLIGEN adapter training driver (entry "train"): the program's
`training/train.py::make_train_step` on `runtime/models.py::build_train_unet`
with the adapter mask and AdamW, as a fine-tuning job over pre-encoded
latents feeds it.

Set-up makes the UNet's float32 masters on the card from the seed, and the
mix's batches (latents, noise, timesteps, text states, grounding tokens for
the row's boxes, the other slots a fixed null token), then drives the step
through its first three steps on batches 0, 1 and 2: the readings the check
compares (each step's loss, the first gradient as AdamW holds it, the
adapters' change after three steps) and the warm-up in one. The window runs
the same step object on the batches in turn.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import traffic as trafficlib
from .generate import make_weights
from .probes import Probes
from .reference import sampling as ref_sampling
from .reference import sd as ref_sd
from .reference import train as ref_train

CHECK_STEPS = 3


class Training:
    def __init__(self, cell: dict, cfg: dict, mix: dict, seed: int, device, traced: bool):
        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        self.device = torch.device(device)
        self.traced = traced
        self.probes = Probes(traced)
        self.attempted = 0
        self.log = lambda msg: None

    def _batches(self, gen):
        u = self.cfg["unet"]
        b, n = self.mix["batch"], self.mix["batches"]
        h, w = ref_sd.latent_hw(self.cfg)
        width, slots = u["cross_attention_dim"], u["gligen_max_objs"]
        dev, dt = self.device, self.sd.torch_dtype()

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        x0, noise = randn(n, b, h, w, u["in_channels"]), randn(n, b, h, w, u["in_channels"])
        t = torch.randint(0, self.cfg["sampler"]["num_train_timesteps"], (n, b), generator=gen,
                          device=dev)
        text = randn(n, b, self.cfg["clip"]["max_length"], width)
        objs = randn(n, b, slots, width).to(dt)
        null = randn(width).to(dt)
        for row in range(n * b):
            objs[row // b, row % b, trafficlib.train_boxes(self.mix, row):] = null
        return [{"x0": x0[i], "noise": noise[i], "t": t[i], "text_embeddings": text[i],
                 "objs": objs[i]} for i in range(n)]

    def setup(self):
        from lmdx_torch.core.schedule import make_alphas_cumprod
        from lmdx_torch.runtime.models import build_train_unet
        from lmdx_torch.training import train

        state, self.sd, _ = make_weights(self.cfg, self.seed, self.device, train=True)
        self.state = state["unet"]
        self.shapes = {"unet": {k: tuple(v.shape) for k, v in self.state.items()}}
        gen = torch.Generator(device=self.device).manual_seed(
            (int(self.seed) + 1) & (2**63 - 1))
        self.batches = self._batches(gen)
        self.trained = sorted(n for n in self.state if ".fuser." in n)
        self.initial = {n: self.state[n].detach().clone() for n in self.trained}
        unet = build_train_unet(self.sd, state_dict=self.state, device=self.device)
        mask = train.gligen_adapter_mask(unet)
        if sorted(n for n, on in mask.items() if on) != self.trained:
            raise ValueError("the adapter mask trains other parameters than the fusers")
        opt = train.make_optimizer(self.mix["learning_rate"], self.mix["weight_decay"], mask)
        self.train_state = train.init_train_state(unet, opt)
        self.step = train.make_train_step(unet, opt, make_alphas_cumprod(),
                                          objs_fn=lambda _, b: b["objs"])
        self.probes.install()
        params = dict(unet.named_parameters())
        self.losses, self.grad1, self.change = [], {}, {}
        b1 = opt.b1
        for i in range(CHECK_STEPS):
            self.train_state, loss = self.step(self.train_state, self.batches[i])
            self.losses.append(loss)
            if i == 0:
                st = self.train_state.opt_state.state
                # A step that took no update leaves no moment: it reads 0.
                self.grad1 = {n: (st[params[n]]["exp_avg"] / (1 - b1)).norm()
                              if "exp_avg" in st.get(params[n], {}) else torch.zeros(())
                              for n in self.trained}
        self.change = {n: (params[n].detach() - self.initial[n]).norm() for n in self.trained}
        self.losses = [float(x) for x in self.losses]
        self.grad1 = {n: float(v) for n, v in self.grad1.items()}
        self.change = {n: float(v) for n, v in self.change.items()}
        self.k = CHECK_STEPS
        self.probes.spans.clear()
        self.probes.attn_calls.clear()

    def window(self, seconds: float, t0: float) -> dict:
        steps = 0
        while time.perf_counter() - t0 < seconds:
            self.train_state, loss = self.probes.span(
                "train_step", self.step, self.train_state,
                self.batches[self.k % len(self.batches)])
            self.k += 1
            steps += 1
        self.attempted = steps
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        if not torch.isfinite(loss):
            raise FloatingPointError(f"the training loss is {float(loss)}")
        return {"steps": steps, "end": end}

    def metrics(self, t0: float, out: dict) -> dict:
        return {"train_step_s": (out["end"] - t0) / out["steps"]}

    def free(self):
        """Drops the program's state; the masters' frozen part stays for the
        reference (the same tensors it was handed)."""
        self.probes.uninstall()
        for n in self.trained:
            self.state[n] = self.initial[n]
        self.train_state = self.step = None

    def _reference(self, pr):
        """(losses, first gradient norms, change norms) of the reference's
        first three steps at `pr`."""
        P = dict(self.state)
        alphas = torch.as_tensor(ref_sampling.alphas_cumprod(self.cfg["sampler"]),
                                 device=self.device)
        opt = ref_train.AdamW(self.mix["learning_rate"], self.mix["weight_decay"])
        losses, grad1 = [], {}
        for i in range(CHECK_STEPS):
            loss, grads = ref_train.loss_and_grads(P, self.trained, self.cfg, pr, alphas,
                                                   self.batches[i], self.mix["reference_rows"])
            losses.append(loss)
            if i == 0:
                grad1 = {n: g.norm().item() for n, g in grads.items()}
            opt.step(P, grads)
            del grads
        change = {n: (P[n] - self.initial[n]).norm().item() for n in self.trained}
        return losses, grad1, change

    def _numbers(self, got, want) -> dict:
        """Each step's loss (loss: the widest of them); the first gradient
        and the change after three steps by the worst leaf and by the median
        leaf: the gap between the two norms over the reference's norm of
        that leaf or of the median leaf, whichever is larger."""
        (l_p, g_p, c_p), (l_r, g_r, c_r) = got, want
        med_g = float(np.median(list(g_r.values())))
        # Leaves whose reference gradient is nought to rounding move under
        # Adam by round-off alone: left out of the change.
        moved = [n for n in self.trained if g_r[n] >= 1e-3 * med_g]
        med_c = float(np.median([c_r[n] for n in moved]))
        grad = {n: abs(g_p[n] - g_r[n]) / max(g_r[n], med_g) for n in self.trained}
        change = {n: abs(c_p[n] - c_r[n]) / max(c_r[n], med_c) for n in moved}
        for name, gaps, a, b in (("grad", grad, g_p, g_r), ("change", change, c_p, c_r)):
            worst = sorted(gaps, key=gaps.get)[-3:]
            self.log(f"{name}: widest leaves " + "; ".join(
                f"{n} {gaps[n]:.3g} ({a[n]:.4g} against {b[n]:.4g})" for n in worst)
                + f"; median leaf {np.median(list(b.values())):.4g}, "
                f"{len(self.trained) - len(moved)} leaves left out")
        losses = [abs(a - b) / abs(b) for a, b in zip(l_p, l_r)]
        out = {"loss": max(losses), "grad": max(grad.values()), "change": max(change.values()),
               "grad_median": float(np.median(list(grad.values()))),
               "change_median": float(np.median(list(change.values())))}
        out.update({f"loss{i + 1}": v for i, v in enumerate(losses)})
        return out

    def check(self, pr) -> tuple:
        self.free()
        self._ref = self._reference(pr)
        numbers = self._numbers((self.losses, self.grad1, self.change), self._ref)
        return numbers, list(range(CHECK_STEPS)), set(numbers)

    def control(self, pr, low) -> dict:
        return self._numbers(self._reference(low), self._ref)
