"""The output check of the generation cells: each recorded stage of the
timed path, recomputed by the plain reference from the same inputs and
compared with what the program produced.

The reference follows the program stage by stage from the program's own
state (its latents at a step, its text states, its masks, its guidance
tables): the sampler's trajectory is chaotic, so a reference run from the
initial noise alone would part from any faithful lower-precision run. Each
stage is judged on its own inputs:

- text: the CLIP tower's last and pooled states of every text encoded;
- gligen: PositionNet's grounding tokens;
- unet: the UNet's CFG-doubled noise prediction and exported attention maps
  at the recorded steps, with the GLIGEN fusers where they run;
- guidance: the guidance iterations at the recorded steps, stage by stage
  (`Judge._guidance`): the early-exit forward's attention maps, the energy,
  and its gradient carried back through the UNet to the latents;
- step: classifier-free guidance and the DDIM update at the recorded steps;
- compose: the per-box trajectories composed under the masks (and shifted
  onto the overall boxes where the method aligns them);
- sam: the segmenter's mask logits and IoU scores for its prompts;
- decode: the VAE decode to uint8 images;
- tables (`Judge.layout`): what the call derived on the host from its
  layouts, worked out again from the layout specs by
  `reference/layout.py`: the texts encoded, the guidance tables (token
  positions, box rasters, top-k sizes, the reference-attention rows), the
  word token whose attention the per-box pass keeps, GLIGEN's boxes and the
  segmenter's prompts; the number of entries that differ (exact);
- masks: the latent masks kept from the segmenter's logits (judged under
  sam), worked out again (resize, threshold, pick by size, confidence and
  IoU with the coarse mask); the largest share of a box's latent pixels
  that differ (exact).

Each number is the widest gap, max |program - reference| / max |reference|
over every judged instance (decode: the widest gap in uint8 levels, and
decode_mean the largest mean gap of an image in levels). A cell compares
the numbers its limits file names.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import layout as ref_layout
from .reference import sam as ref_sam
from .reference import sampling as ref_sampling
from .reference import sd as ref_sd
from .reference.prec import Prec

def _key(k) -> str:
    return k if isinstance(k, str) else "_".join(map(str, k))


def _gap(got, want) -> float:
    got = torch.as_tensor(np.asarray(got) if not torch.is_tensor(got) else got).float()
    want = torch.as_tensor(want).float().to(got.device)
    if got.shape != want.shape:
        return float("inf")
    scale = want.abs().max().item()
    d = (got - want).abs().max().item()
    if not np.isfinite(d):
        return float("inf")
    return d / scale if scale > 0 else d


LAYOUT_KINDS = ("aggregate", "masks")   # judged by `Judge.layout`, not stage by stage


def _np(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _named(tree):
    if isinstance(tree, dict):
        return {_key(k): _named(v) for k, v in tree.items()}
    return tree


class Judge:
    """Recomputes recorded stages. `judge(units)` compares the program's
    outputs with the reference's and keeps the widest gap by name in
    `numbers`; `control(units, low)` compares, on the same inputs, the
    reference computed at the precision `low` (the control, in the
    program's place) with the reference."""

    def __init__(self, cfg: dict, state: dict, pr: Prec, device):
        self.cfg, self.pr, self.device = cfg, pr, device
        self.unet = state["unet"]
        self.text = state["text"]
        self.vae = state["vae"]
        self.pn = state.get("position_net")
        self.sam = state.get("sam")
        self.numbers: dict[str, float] = {}

    def _put(self, name, value):
        self.numbers[name] = max(self.numbers.get(name, 0.0), float(value))

    def _dev(self, x):
        if x is None:
            return None
        return (x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))).to(self.device)

    # -- the reference's outputs of one recorded stage -------------------------

    @torch.no_grad()
    def _text(self, u, pr):
        hidden, pooled = ref_sd.encode_text(self.text, self.cfg, pr, u["texts"], self.device)
        return {"hidden": hidden, "pooled": pooled}

    @torch.no_grad()
    def _gligen(self, u, pr):
        return {"out": ref_sd.position_net(self.pn, self.cfg, pr, self._dev(u["boxes"]).float(),
                                           self._dev(u["masks"]).float(),
                                           self._dev(u["phrase"]).float())}

    @torch.no_grad()
    def _unet(self, u, pr):
        eps, taps = ref_sd.unet(self.unet, self.cfg, pr, self._dev(u["sample"]), u["t"],
                                self._dev(u["context"]), self._dev(u["objs"]),
                                tap_names=u["tap_names"], cond_only=u["cond_only"],
                                tap_token_index=self._dev(u["tap_token_index"]))
        return {"eps": eps, "taps": taps}

    def _guidance(self, u, pr):
        """One guidance iteration, stage by stage on the program's own
        inputs: the early-exit forward's attention maps at the latents; the
        energy at the program's maps and its gradient with respect to them
        (the top-k selections and the kinks of the L1 transfer term decided
        on the program's values); that gradient carried back through the
        reference UNet to the latents."""
        x = self._dev(u["sample"]).float().requires_grad_(True)
        with torch.enable_grad():
            _, taps = ref_sd.unet(self.unet, self.cfg, pr, x, u["t"], self._dev(u["context"]),
                                  self._dev(u["objs"]), tap_names=u["tap_names"],
                                  stop_after_taps=True)
            names = sorted(taps)
            given = {n: pr.q(self._dev(v)).detach().requires_grad_(True)
                     for n, v in u["taps"].items()}
            loss = ref_sampling.ca_loss(given, _named(u["data"]), u["spec"],
                                        _named(u["ref_taps"]))
            dtaps = torch.autograd.grad(loss.sum() * u["spec"]["loss_scale"],
                                        [given[n] for n in names])
            grad = torch.autograd.grad([taps[n] for n in names], x, list(dtaps))[0]
        return {"taps": {n: v.detach() for n, v in taps.items()}, "loss": loss.detach(),
                "grad": grad}

    @torch.no_grad()
    def _ddim(self, u, pr):
        s = self.cfg["sampler"]
        grid = ref_sampling.ddim_timesteps(s, s["num_inference_steps"])
        if grid[u["step"]] != (u["t"], u["prev_t"]):
            return {"out": None}
        return {"out": ref_sampling.ddim_cfg_step(s, pr, self._dev(u["eps2"]),
                                                  self._dev(u["sample"]), u["t"], u["prev_t"],
                                                  s["guidance_scale"])}

    @torch.no_grad()
    def _compose(self, u, pr):
        if "image_box_idxs" in u:               # the batched device composition
            traj = self._dev(u["trajectories"])
            parts = [ref_sampling.compose(pr, [traj[:, bi:bi + 1] for bi in idxs],
                                          [u["masks"][bi] for bi in idxs],
                                          u["latents_bg"][gi:gi + 1], u["steps"])
                     for gi, idxs in enumerate(u["image_box_idxs"])]
            return {"composed": torch.cat([c for c, _ in parts], dim=1),
                    "fg": np.stack([f for _, f in parts])}
        trajs = [self._dev(t) for t in u["trajectories"]]
        masks = list(u["masks"])
        if u["align"]:
            trajs, masks = ref_sampling.align(trajs, masks, u["boxes"], u["horizontal_only"])
        composed, fg = ref_sampling.compose(pr, trajs, masks, u["latents_bg"], u["steps"])
        return {"composed": composed, "fg": fg}

    @torch.no_grad()
    def _sam(self, u, pr):
        pixels = self._dev(u["pixels"])
        n, oh, ow = pixels.shape[:3]
        points, labels = ref_sam.prompt_points(self.cfg, n, oh, ow, u["points"], u["boxes"])
        logits, iou = ref_sam.sam(self.sam, self.cfg, pr, pixels, points, labels)
        return {"logits": logits, "iou": iou}

    @torch.no_grad()
    def _decode(self, u, pr):
        return {"images": ref_sd.vae_decode(self.vae, self.cfg, pr, self._dev(u["latents"]))}

    # -- gaps -----------------------------------------------------------------

    def _compare(self, u, got, want):
        kind = u["kind"]
        if kind == "text":
            self._put("text", max(_gap(got["hidden"], want["hidden"]),
                                  _gap(got["pooled"], want["pooled"])))
        elif kind == "gligen":
            self._put("gligen", _gap(got["out"], want["out"]))
        elif kind == "unet":
            gap = _gap(got["eps"], want["eps"])
            for name, w in want["taps"].items():
                gap = max(gap, _gap(got["taps"][name], w))
            self._put("unet", gap)
        elif kind == "guidance":
            if got.get("grad") is None or got.get("loss") is None:
                self._put("guidance", float("inf"))
                return
            gap = max(_gap(got["loss"], want["loss"]), _gap(got["grad"], want["grad"]))
            for name, w in want["taps"].items():
                gap = max(gap, _gap(got["taps"][name], w))
            self._put("guidance", gap)
        elif kind == "ddim":
            self._put("step", float("inf") if want["out"] is None or got["out"] is None
                      else _gap(got["out"], want["out"]))
        elif kind == "compose":
            gap = _gap(self._dev(got["composed"]), want["composed"])
            if not np.array_equal(np.asarray(got["fg"]), np.asarray(want["fg"])):
                gap = float("inf")
            self._put("compose", gap)
        elif kind == "sam":
            self._put("sam", max(_gap(got["logits"], want["logits"]),
                                 _gap(got["iou"], want["iou"])))
        elif kind == "decode":
            g, w = self._dev(got["images"]).float(), want["images"].float()
            if g.shape != w.shape:
                self._put("decode", float("inf"))
                self._put("decode_mean", float("inf"))
                return
            d = (g - w).abs()
            self._put("decode", d.max().item())
            self._put("decode_mean", d.flatten(1).mean(1).max().item())

    def _reference(self, u, pr):
        return getattr(self, "_" + u["kind"])(u, pr)

    def judge(self, units):
        for u in units:
            if u["kind"] not in LAYOUT_KINDS:
                self._compare(u, u, self._reference(u, self.pr))
        return self.numbers

    def control(self, units, low: Prec):
        for u in units:
            if u["kind"] not in LAYOUT_KINDS:
                self._compare(u, self._reference(u, low), self._reference(u, self.pr))
        return self.numbers

    # -- what the call derived from its layouts ---------------------------------

    def _resolutions(self, keys) -> dict:
        h, w = ref_sd.latent_hw(self.cfg)
        levels = len(self.cfg["unet"]["block_out_channels"])
        out = {}
        for key in keys:
            place, idx = key.split("_")[0], int(key.split("_")[1])
            f = 2 ** {"down": idx, "mid": levels - 1, "up": levels - 1 - idx}[place]
            out[key] = (h // f, w // f)
        return out

    def _tables_gap(self, data, expected: list, ref_ca: bool) -> int:
        """Entries of the program's stacked guidance tables (one image a row)
        that differ from the reference's, padding left out."""
        d = {k: ({_key(kk): _np(vv) for kk, vv in v.items()} if isinstance(v, dict) else _np(v))
             for k, v in data.items()}
        keys = sorted(d["masks"])
        res = self._resolutions(keys)
        bad = 0 if d["positions"].shape[0] == len(expected) else 1
        for g, objects in enumerate(expected[:d["positions"].shape[0]]):
            t = ref_layout.tables(objects, res, ref_ca)
            n = len(objects)
            bad += int(float(d["num_objects"][g]) != max(n, 1))
            bad += int(d["obj_valid"][g].sum() != n or not (d["obj_valid"][g][:n] == 1).all())
            for o, pos in enumerate(t["positions"]):
                c = len(pos)
                bad += int(d["pos_count"][g][o] != c or list(d["positions"][g][o][:c]) != pos)
                for key in keys:
                    bad += int(not np.array_equal(d["masks"][key][g][o] > 0,
                                                  t["masks"][key][o].reshape(-1)))
                    bad += int(d["kfg"][key][g][o] != t["kfg"][key][o])
                    bad += int(d["kbg"][key][g][o] != t["kbg"][key][o])
            if ref_ca:
                nb = len(t["box_word_idx"])
                bad += int(list(d["box_word_idx"][g][:nb]) != t["box_word_idx"])
                bad += int(not np.array_equal(d["box_weight"][g][:nb],
                                              np.float32(t["box_weight"])))
                for key in keys:
                    bad += sum(int(not np.array_equal(d["ref_masks"][key][g][b] > 0,
                                                      m.reshape(-1)))
                               for b, m in enumerate(t["ref_masks"][key]))
        return bad

    @torch.no_grad()
    def layout(self, record: dict, specs: list, method: str):
        """The call's host-side derivations (tables) and latent masks
        (masks), worked out again from its layout specs."""
        units = record["units"]
        settings = ref_layout.METHODS[method]
        gligen = settings["gligen"]
        plans = [ref_layout.plan(spec, method) for spec in specs]
        flat = [item for p in plans for item in p["per_box"]]
        bad = 0
        # texts: every prompt (and GLIGEN phrase) the layouts call for is encoded
        texts = {t for u in units if u["kind"] == "text" for t in u["texts"]}
        want = [x[0] for x in flat] + [p["overall_prompt"] for p in plans]
        if gligen:
            want += [x[1] for x in flat] + [ph for p in plans for ph, _, bs in p["overall"]
                                             for _ in bs]
        bad += sum(t not in texts for t in want)
        # guidance tables of the per-box pass (one box an image) and the overall pass
        words = [ref_layout.positions(*x[:3]) for x in flat]
        per_box = [[([x[3]], pos, w)] for x, (pos, w) in zip(flat, words)]
        overall = [[(bs, *ref_layout.positions(p["overall_prompt"], ph, wd))
                    for ph, wd, bs in p["overall"]] for p in plans]
        passes = {}
        for u in units:
            if u["kind"] == "guidance" and "data" in u:
                passes.setdefault(u["pass_index"] - record["first_pass"], u["data"])
        expect = {1: (overall, True)}
        if settings["per_box_guidance"]:
            expect[0] = (per_box, False)
        for index, (objects, ref_ca) in expect.items():
            bad += (self._tables_gap(passes[index], objects, ref_ca) if index in passes else 1)
        bad += int(sorted(passes) != sorted(expect))
        # the word token whose attention the per-box pass keeps
        taps = [u for u in units if u["kind"] == "unet" and u["pass_index"] == record["first_pass"]
                and u["tap_token_index"] is not None]
        bad += sum(list(_np(u["tap_token_index"]).reshape(-1)) != [w for _, w in words]
                   for u in taps)
        # GLIGEN's boxes: one a row in the per-box pass, the image's in the overall
        if gligen:
            grounded = [u for u in units if u["kind"] == "gligen"]
            rows = [[[x[3]] for x in flat], [[b for _, _, bs in p["overall"] for b in bs]
                                             for p in plans]]
            bad += int(len(grounded) != 2)
            for u, want_rows in zip(grounded, rows):
                boxes, masks = _np(u["boxes"]), _np(u["masks"])
                half = boxes.shape[0] // 2
                bad += int(half != len(want_rows) or (masks[:half] != 0).any())
                for r, want_boxes in enumerate(want_rows[:half]):
                    got = boxes[half + r][masks[half + r] > 0]
                    bad += int(not np.array_equal(got, np.float32(want_boxes).reshape(-1, 4)))
        # the segmenter's prompts and the masks kept from its answers
        sams = [u for u in units if u["kind"] == "sam"]
        stacks = [u["stack"] for u in units if u["kind"] == "aggregate"]
        kept = [m for u in units if u["kind"] == "masks" for m in u["masks"]]
        prompts = [p for u in sams for p in (u["boxes"] or u["points"])]
        if len(prompts) != len(flat) or len(kept) != len(flat) or (
                settings["prompt"] == "attention" and len(stacks) != len(flat)):
            self._put("tables", bad + 1)
            self._put("masks", float("inf"))
            return
        h, w = ref_sd.latent_hw(self.cfg)
        logits, iou = [], []
        for u in sams:
            n, oh, ow = u["pixels"].shape[:3]
            logits.append(ref_layout.latent_masks(self._dev(u["logits"]),
                                                  self.cfg["sam"]["image_size"], (oh, ow), (h, w)))
            iou.append(_np(u["iou"]))
        logits, iou = np.concatenate(logits), np.concatenate(iou)
        worst = 0.0
        for b, x in enumerate(flat):
            attn = ref_layout.aggregate(stacks[b]) if stacks else None
            (kind, prompt), coarse = ref_layout.sam_prompt(method, box=x[3], attn_map=attn)
            got = prompts[b][0]
            bad += int(len(got) != len(prompt)
                       or not all(float(a) == float(c) for a, c in zip(got, prompt)))
            coarse = ref_layout.coarse_mask(method, x[3], coarse, (h, w))
            mask = ref_layout.select(logits[b], iou[b], coarse)
            worst = max(worst, float(np.mean(mask != (np.asarray(kept[b]) > 0))))
        self._put("tables", bad)
        self._put("masks", worst)
