"""The benchmark's own spans, counters and recordings around calls into the
program's layers (the program carries no spans of its own yet).

`Probes.install()` wraps module attributes of `lmdx_torch` that the timed
path looks up at call time, and `uninstall()` puts them back:

- spans (host clock; in a traced run each edge waits for the device, so
  that device time falls inside the span that caused it): `sample`,
  `guidance` (one step's guidance loop), `segmenter`, `text`, `gligen`,
  `decode`;
- counters: guidance iterations, UNet calls by batch and kind, attention
  kernel calls with their shapes (traced runs only);
- recordings for the output check, on requests the driver marks: each
  judged stage's inputs and outputs, copied on the device without waiting
  for it. The UNet's noise prediction and the DDIM update are recorded at
  the sampler steps in `record_steps`, and so are the guidance iterations;
  every text encoding, grounding, composition, segmentation and decode is
  recorded, and so are the aggregated attention that prompts the segmenter
  and the latent masks kept from its answers.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch


def _clone(x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return np.array(x, copy=True)


class Probes:
    def __init__(self, traced: bool, record_steps=()):
        self.traced = traced
        self.record_steps = set(record_steps)
        self.spans: list[tuple[str, float, float]] = []
        self.counts: Counter = Counter()
        self.unet_calls: Counter = Counter()       # (batch, grounded, guidance) -> calls
        self.attn_calls: list[tuple] = []          # (kind, b, h, lq, lk, d, itemsize)
        self.current: dict | None = None           # the request being recorded
        self._pass = -1
        self._step = 0
        self._last_eps = None
        self._sam_out = None
        self._saved: list[tuple] = []

    # -- spans ----------------------------------------------------------------

    def _sync(self):
        if self.traced and torch.cuda.is_available():
            torch.cuda.synchronize()

    def span(self, name, fn, *args, **kwargs):
        self._sync()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._sync()
            self.spans.append((name, t0, time.perf_counter()))

    def _unit(self, kind: str, **payload):
        if self.current is not None:
            payload["kind"] = kind
            self.current["units"].append(payload)
            return payload
        return None

    # -- installation ---------------------------------------------------------

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def install(self):
        from lmdx_torch.core import schedule
        from lmdx_torch.methods import _grounded, base, batch
        from lmdx_torch.nn import sam as samlib
        from lmdx_torch.nn.kernels import flash_attention as fa
        from lmdx_torch.nn.kernels import sam_attention as sa
        from lmdx_torch.runtime import models
        from lmdx_torch.sampling import compose, guidance, loop, masking

        self._patch(loop, "apply_unet", self._wrap_unet)
        self._patch(schedule, "ddim_step", self._wrap_ddim)
        self._patch(guidance, "guidance_update_batched", self._wrap_guidance)
        self._patch(guidance, "ca_loss_batched", self._wrap_loss)
        self._patch(batch, "sample", self._wrap_sample)
        self._patch(_grounded, "sample", self._wrap_sample)
        self._patch(models, "encode_text", self._wrap_text)
        self._patch(models, "gligen_objs", self._wrap_gligen)
        self._patch(batch, "_compose_batch_device", self._wrap_compose_device)
        self._patch(compose, "compose_latents_with_alignment", self._wrap_compose_host)
        self._patch(samlib.SamSegmenter, "segment_batch", self._wrap_segment)
        self._patch(samlib.SamSegmenter, "_segment_chunk", self._wrap_chunk)
        self._patch(base, "decode_latents", self._wrap_decode)
        self._patch(compose, "aggregate_token_attention", self._wrap_aggregate)
        for name in ("refine_masks_from_boxes", "refine_masks_from_attn"):
            self._patch(masking, name, self._wrap_refine)
        if self.traced:
            self._patch(fa, "flash_attention_fwd", self._wrap_attn("fwd"))
            self._patch(fa, "flash_attention_bwd", self._wrap_attn("bwd"))
            self._patch(sa, "sam_attention", self._wrap_attn("fwd"))
        return self

    def uninstall(self):
        while self._saved:
            owner, name, orig = self._saved.pop()
            setattr(owner, name, orig)

    def watch_sam(self, model):
        """Keep the segmenter network's last output (its mask logits)."""
        def hook(_module, _inputs, output):
            self._sam_out = output
        return model.register_forward_hook(hook)

    # -- wrappers -------------------------------------------------------------

    def _wrap_sample(self, orig):
        def sample(*args, **kwargs):
            self._pass += 1
            self._step = 0
            return self.span("sample", orig, *args, **kwargs)
        return sample

    def _wrap_unet(self, orig):
        def apply_unet(unet, lat, t, context, objs=None, taps=None, tap_token_index=None,
                       stop_after_taps=False, **kw):
            from lmdx_torch.nn.attention import NO_TAPS
            taps = NO_TAPS if taps is None else taps
            guided = bool(stop_after_taps)
            self.unet_calls[(int(lat.shape[0]), objs is not None, guided,
                             tuple(sorted(taps.names)) if guided else ())] += 1
            rec = None
            if guided and self._step in self.record_steps:
                rec = self._unit("guidance", pass_index=self._pass, step=self._step,
                                 sample=_clone(lat), t=t, context=_clone(context),
                                 objs=_clone(objs), tap_names=sorted(taps.names))
                if rec is not None and lat.requires_grad:
                    lat.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone()))
            eps, taps_out = orig(unet, lat, t, context, objs=objs, taps=taps,
                                 tap_token_index=tap_token_index,
                                 stop_after_taps=stop_after_taps, **kw)
            if not guided:
                self._last_eps = eps
                if self._step in self.record_steps:
                    self._unit("unet", pass_index=self._pass, step=self._step,
                               sample=_clone(lat), t=t, context=_clone(context),
                               objs=_clone(objs), tap_names=sorted(taps.names),
                               cond_only=taps.cond_only,
                               tap_token_index=_clone(tap_token_index), eps=_clone(eps),
                               taps={"_".join(map(str, k)): _clone(v)
                                     for k, v in taps_out.items()})
            return eps, taps_out
        return apply_unet

    def _wrap_ddim(self, orig):
        def ddim_step(schedule, eps, t, prev_t, sample):
            out = orig(schedule, eps, t, prev_t, sample)
            if self._step in self.record_steps:
                self._unit("ddim", pass_index=self._pass, step=self._step, t=int(t),
                           prev_t=int(prev_t), eps2=_clone(self._last_eps),
                           sample=_clone(sample), out=_clone(out))
            self._step += 1
            return out
        return ddim_step

    def _wrap_guidance(self, orig):
        def guidance_update_batched(*args, **kwargs):
            return self.span("guidance", orig, *args, **kwargs)
        return guidance_update_batched

    def _wrap_loss(self, orig):
        def ca_loss_batched(taps, data, spec, ref_taps=None):
            self.counts["guidance_iters"] += 1
            out = orig(taps, data, spec, ref_taps=ref_taps)
            rec = None
            if self.current is not None and self.current["units"]:
                last = self.current["units"][-1]
                if last["kind"] == "guidance" and "loss" not in last:
                    rec = last
            if rec is not None:
                rec.update(data=_clone(data), ref_taps=_clone(ref_taps), loss=_clone(out),
                           spec={"keys": ["_".join(map(str, k)) for k in spec.keys],
                                 "fg_weight": spec.fg_weight, "bg_weight": spec.bg_weight,
                                 "use_ref_ca": spec.use_ref_ca, "loss_scale": spec.loss_scale},
                           taps={"_".join(map(str, k)): _clone(v) for k, v in taps.items()})
            return out
        return ca_loss_batched

    def _wrap_text(self, orig):
        def encode_text(bundle, texts):
            hidden, pooled = self.span("text", orig, bundle, texts)
            self.counts["text_rows"] += len(texts)
            self._unit("text", texts=list(texts), hidden=_clone(hidden), pooled=_clone(pooled))
            return hidden, pooled
        return encode_text

    def _wrap_gligen(self, orig):
        def gligen_objs(bundle, boxes, masks, phrase_embeddings):
            out = self.span("gligen", orig, bundle, boxes, masks, phrase_embeddings)
            self._unit("gligen", boxes=_clone(boxes), masks=_clone(masks),
                       phrase=_clone(phrase_embeddings), out=_clone(out))
            return out
        return gligen_objs

    def _wrap_compose_device(self, orig):
        def compose_device(all_latents, image_box_idxs, mask_flat, latents_bg, steps):
            composed, fg = orig(all_latents, image_box_idxs, mask_flat, latents_bg, steps)
            self._unit("compose", trajectories=_clone(all_latents[:steps + 1]),
                       image_box_idxs=[list(i) for i in image_box_idxs],
                       masks=[_clone(m) for m in mask_flat], latents_bg=_clone(latents_bg),
                       steps=int(steps), align=False, composed=_clone(composed), fg=_clone(fg))
            return composed, fg
        return compose_device

    def _wrap_compose_host(self, orig):
        def compose_latents_with_alignment(latents_all_list, mask_list, latents_bg,
                                           num_compose_steps, align_with_overall_bboxes=True,
                                           overall_bboxes=None, horizontal_shift_only=False,
                                           **kw):
            out = orig(latents_all_list, mask_list, latents_bg, num_compose_steps,
                       align_with_overall_bboxes=align_with_overall_bboxes,
                       overall_bboxes=overall_bboxes,
                       horizontal_shift_only=horizontal_shift_only, **kw)
            self._unit("compose", trajectories=[np.asarray(t) for t in latents_all_list],
                       masks=[np.asarray(m) for m in mask_list],
                       latents_bg=np.asarray(latents_bg), steps=int(num_compose_steps),
                       align=bool(align_with_overall_bboxes and len(latents_all_list)),
                       boxes=[b for bs in (overall_bboxes or []) for b in bs],
                       horizontal_only=bool(horizontal_shift_only),
                       composed=out.latents, fg=out.foreground_indices)
            return out
        return compose_latents_with_alignment

    def _wrap_segment(self, orig):
        def segment_batch(seg, *args, **kwargs):
            return self.span("segmenter", orig, seg, *args, **kwargs)
        return segment_batch

    def _wrap_chunk(self, orig):
        def _segment_chunk(seg, pixels, input_points, input_boxes, target_hw):
            self._sam_out = None
            out = orig(seg, pixels, input_points, input_boxes, target_hw)
            self.counts["sam_images"] += int(pixels.shape[0])
            if self._sam_out is not None:
                logits, iou = self._sam_out
                self._unit("sam", pixels=_clone(pixels), points=input_points,
                           boxes=input_boxes, logits=_clone(logits), iou=_clone(iou))
            return out
        return _segment_chunk

    def _wrap_decode(self, orig):
        def decode_latents(bundle, latents, to_host=True):
            out = self.span("decode", orig, bundle, latents, to_host=to_host)
            self.counts["decode_images"] += int(latents.shape[0])
            self._unit("decode", latents=_clone(latents), images=_clone(out))
            return out
        return decode_latents

    def _wrap_aggregate(self, orig):
        def aggregate_token_attention(taps_stack, start_step=10):
            self._unit("aggregate", stack=np.array(taps_stack, copy=True))
            return orig(taps_stack, start_step=start_step)
        return aggregate_token_attention

    def _wrap_refine(self, orig):
        def refine(prompts, images, latent_hw, segmenter, cfg=None, **kw):
            args = (prompts, images, latent_hw, segmenter) + (() if cfg is None else (cfg,))
            out = orig(*args, **kw)
            self._unit("masks", masks=[np.array(m, copy=True) for m in out])
            return out
        return refine

    def _wrap_attn(self, kind):
        def make(orig):
            def call(q, k, *rest):
                b, h, lq, d = q.shape
                self.attn_calls.append((kind, b, h, lq, int(k.shape[2]), d, q.element_size()))
                return orig(q, k, *rest)
            return call
        return make
