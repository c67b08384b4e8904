"""The grounded-generation driver: batched LMD+ (`methods/batch.py`, entry
"batch") or one layout a call through the method registry (entry "single"),
closed loop, one client.

Set-up makes the configuration's weights on the card from the seed, builds
the program's bundle and SAM segmenter on them, and warms up, at a few
steps, every batch shape of the calls the window can start: the mix's first
`warm_calls` calls (those a window of the benchmark's length starts, and
one more). The window then sends the mix's
calls one after another for the given seconds; a call started in the window
is finished and counted. Images count when their uint8 pixels are on the
host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import traffic as trafficlib
from .check import Judge
from .probes import Probes
from .weights import SAM_F32, SD_F32, make_state

WARM_STEPS = 3  # the fewest steps at which a call runs every segment (fuser, frozen, free)


def program_config(cfg: dict):
    """The program's SDConfig for the configuration file, checked field by
    field against the file's sizes."""
    from lmdx_torch.config import SD_CONFIGS

    sd = dataclasses.replace(SD_CONFIGS[cfg["model_key"]](), dtype=cfg["dtype"])
    wrong = []
    for part in ("unet", "clip", "vae"):
        have = getattr(sd, part)
        for key, want in cfg[part].items():
            got = getattr(have, key)
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                wrong.append(f"{part}.{key}: program {got!r}, file {want!r}")
    for key in ("height", "width"):
        if getattr(sd, key) != cfg[key]:
            wrong.append(f"{key}: program {getattr(sd, key)}, file {cfg[key]}")
    if wrong:
        raise ValueError("the program's configuration differs from the file: " + "; ".join(wrong))
    return sd


def program_sam_config(cfg: dict):
    from lmdx_torch.nn.sam import SamConfig

    s = {k: v for k, v in cfg["sam"].items() if k != "source"}
    return SamConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in s.items()})


def make_weights(cfg: dict, seed: int, device, train: bool = False):
    """({part: state dict}, program SDConfig, program SamConfig or None)."""
    from lmdx_torch.nn.sam import Sam
    from lmdx_torch.runtime.models import build_modules

    sd = program_config(cfg)
    dtype = torch.float32 if train else sd.torch_dtype()
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    with torch.device("meta"):
        parts = build_modules(sd)
    state = {}
    for name in ("unet", "text", "vae", "position_net"):
        if train and name != "unet":
            continue
        module = parts[name]
        if module is None:
            continue
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        state[name] = make_state(shapes, dtype, SD_F32, gen, device)
    sam_cfg = None
    if not train and "sam" in cfg:
        sam_cfg = program_sam_config(cfg)
        with torch.device("meta"):
            sam = Sam(sam_cfg, dtype)
        shapes = {k: tuple(v.shape) for k, v in sam.state_dict().items()}
        state["sam"] = make_state(shapes, dtype, SAM_F32, gen, device)
    return state, sd, sam_cfg


def record_steps(cfg: dict, seed: int) -> list[int]:
    """Three sampler steps drawn from the seed: one while GLIGEN's fusers run
    (or in the first half), one while the foreground is frozen, one after."""
    s = cfg["sampler"]
    steps = s["num_inference_steps"]
    frozen = int(steps * s["frozen_step_ratio"])
    fuser = int(0.4 * steps) if cfg["unet"].get("use_gligen") else frozen // 2
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), 7]))
    cuts = [0, max(fuser, 1), max(frozen, fuser + 1), steps]
    return sorted({int(rng.integers(a, b)) for a, b in zip(cuts[:-1], cuts[1:]) if b > a})


class Generation:
    def __init__(self, cell: dict, cfg: dict, mix: dict, seed: int, device, traced: bool):
        if mix["entry"] == "batch" and mix["method"] != "lmd_plus":
            raise ValueError("the batched entry drives batched LMD+ only")
        self.cell, self.cfg, self.mix, self.seed = cell, cfg, mix, seed
        self.device = torch.device(device)
        self.traced = traced
        self.probes = Probes(traced, record_steps(cfg, seed))
        self.records: list[dict] = []
        self.attempted = 0
        self.log = lambda msg: None

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from lmdx_torch.nn.sam import SamSegmenter
        from lmdx_torch.runtime.models import build_bundle, build_sam
        from lmdx_torch.runtime.precision import set_full_f32
        from lmdx_torch.text.tokens import WordTokenizer

        t = time.perf_counter()
        self.state, sd, sam_cfg = make_weights(self.cfg, self.seed, self.device)
        self.log(f"weights drawn: {time.perf_counter() - t:.2f} s")
        self.shapes = {part: {k: tuple(v.shape) for k, v in st.items()}
                       for part, st in self.state.items()}
        if sd.torch_dtype() == torch.float32:
            set_full_f32()
        parts = {k: v for k, v in self.state.items() if k != "sam"}
        self.bundle = build_bundle(sd, parts, device=self.device, tokenizer=WordTokenizer())
        model = build_sam(sam_cfg, state_dict=self.state["sam"], device=self.device,
                          dtype=sd.torch_dtype())
        self.segmenter = SamSegmenter(model)
        self._hook = self.probes.watch_sam(model)
        self.probes.install()
        self.warmed = set()
        for k in range(self.mix["warm_calls"]):
            shape = self._shape(k)
            if shape in self.warmed:
                continue
            self.warmed.add(shape)
            t = time.perf_counter()
            self._run(trafficlib.call(self.mix, self.seed, k), steps=WARM_STEPS)
            self.log(f"warm-up call {k} ({shape} boxes, {WARM_STEPS} steps): "
                     f"{time.perf_counter() - t:.2f} s")
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.probes.spans.clear()
        self.probes.counts.clear()
        self.probes.unet_calls.clear()
        self.probes.attn_calls.clear()

    def _shape(self, k):
        """The batch shape of call k: its box counts (batched: their sum)."""
        counts = tuple(sorted(trafficlib.box_counts(self.mix, k)))
        return sum(counts) if self.mix["entry"] == "batch" else counts

    def _overrides(self, steps):
        s = self.cfg["sampler"]
        return dict(num_inference_steps=steps, guidance_scale=s["guidance_scale"],
                    frozen_step_ratio=s["frozen_step_ratio"], scheduler=s["scheduler"])

    def _run(self, call, steps=None):
        """Runs one call; returns its results (deferred under `defer_fetch`)."""
        from lmdx_torch import methods
        from lmdx_torch.methods import batch

        kw = self._overrides(steps or self.cfg["sampler"]["num_inference_steps"])
        if self.mix["entry"] == "batch":
            return batch.run_lmd_plus_batch(
                [c["spec"] for c in call], self.bundle, self.segmenter,
                bg_seeds=[c["bg_seed"] for c in call],
                fg_seed_starts=[c["fg_seed"] for c in call],
                defer_fetch=bool(self.mix.get("defer_fetch")), **kw)
        [c] = call
        method = methods.get_method(self.mix["method"])
        return [method.run(c["spec"], self.bundle, self.segmenter, bg_seed=c["bg_seed"],
                           fg_seed_start=c["fg_seed"], **kw)]

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, t0: float) -> dict:
        from lmdx_torch.methods import base

        h, w = self.cfg["height"], self.cfg["width"]
        arrivals, durations, images = [], [], 0
        pending, k = None, 0

        def land(results):
            nonlocal images
            base.finalize_results(results)
            for r in results:
                img = np.asarray(r.image)
                if img.shape != (h, w, 3) or img.dtype != np.uint8:
                    raise ValueError(f"an image came back as {img.shape} {img.dtype}")
            images += len(results)
            arrivals.append(time.perf_counter())

        while time.perf_counter() - t0 < seconds:
            if self._shape(k) not in self.warmed:
                self.log(f"call {k} starts in the window at a shape set-up did not warm "
                         f"({self._shape(k)}): raise the mix's warm_calls")
            call = trafficlib.call(self.mix, self.seed, k)
            self.attempted += len(call)
            self.probes.current = {"k": k, "boxes": sum(trafficlib.box_counts(self.mix, k)),
                                   "first_pass": self.probes._pass + 1, "units": []}
            t = time.perf_counter()
            results = self._run(call)
            durations.append(time.perf_counter() - t)
            self.records.append(self.probes.current)
            self.probes.current = None
            if not self.mix.get("defer_fetch"):
                land(results)
            elif pending is not None:
                # The previous call's images are fetched once this call has
                # been launched, as the CLI's batched driver does.
                land(pending)
            pending, k = results, k + 1
        if self.mix.get("defer_fetch"):
            land(pending)
        end = arrivals[-1]
        self.images = images
        return {"images": images, "calls": k, "end": end, "per_call_s": durations}

    def metrics(self, t0: float, out: dict) -> dict:
        span = out["end"] - t0
        if self.mix["entry"] == "batch":
            return {"images_per_s": out["images"] / span}
        return {"image_latency_s": span / out["images"]}

    # -- the check ----------------------------------------------------------------

    def check(self, pr) -> dict:
        """Judges a sample of the finished requests drawn from the seed: one
        with the most boxes, and one more."""
        self.probes.uninstall()
        self._hook.remove()
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed) & (2**64 - 1), 11]))
        most = max(r["boxes"] for r in self.records)
        longest = [i for i, r in enumerate(self.records) if r["boxes"] == most]
        chosen = {longest[int(rng.integers(len(longest)))]}
        others = [i for i in range(len(self.records)) if i not in chosen]
        if others:
            chosen.add(others[int(rng.integers(len(others)))])
        self.chosen = sorted(chosen)
        judge = Judge(self.cfg, self.state, pr, self.device)
        for i in self.chosen:
            rec = self.records[i]
            judge.judge(rec["units"])
            judge.layout(rec, [c["spec"] for c in trafficlib.call(self.mix, self.seed, rec["k"])],
                         self.mix["method"])
        seen = {u["kind"] for i in chosen for u in self.records[i]["units"]}
        return judge.numbers, self.chosen, seen

    def control(self, pr, low) -> dict:
        """The same numbers with the reference computed at `low` in the
        program's place (the requests `check` judged)."""
        judge = Judge(self.cfg, self.state, pr, self.device)
        for i in self.chosen:
            judge.control(self.records[i]["units"], low)
        return judge.numbers
