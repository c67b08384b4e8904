"""Stage-2 (image) evaluation with an open-vocabulary detector (port of the
JAX package's eval/owl_vit.py).

Protocol parity with the reference (scripts/owl_vit_eval.py, utils/eval/
eval.py:120-174): per benchmark prompt, detect the prompt-derived query texts
in the generated image, keep detections above the score threshold, apply
(class-aware) NMS, convert boxes to the layout format, and score with the
task predicate.

The detector is pluggable: `OwlViTDetector` (nn/owlvit.py on the card, or on
the CPU when asked) or any callable with the same signature.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..text import tokens as toklib
from .predicates import class_aware_nms, get_eval_info_from_prompt, nms, to_gen_box_format
from .prompts import get_prompts
from .stage_one import EvalReport


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class OwlViTDetector:
    """detect(image, texts) -> (boxes xyxy in [0,1], scores, labels).

    `state_dict`: transformers `OwlViTForObjectDetection` key names (None:
    random weights from `seed`, a smoke run: random weights score nothing
    real). Runs on `cuda` unless `device` names another; without a card and
    without that request it raises."""

    def __init__(self, state_dict=None, config=None, tokenizer=None, *, device=None,
                 seed: int = 0):
        from ..nn import owlvit as owlvit_lib
        from ..runtime import models

        self.config = config or owlvit_lib.owlvit_base_patch32()
        self.model = models.build_owlvit(self.config, state_dict, seed=seed, device=device)
        self.device = next(self.model.parameters()).device
        self.tokenizer = tokenizer or toklib.default_tokenizer()
        self._mean = torch.from_numpy(owlvit_lib.CLIP_MEAN).to(self.device)
        self._std = torch.from_numpy(owlvit_lib.CLIP_STD).to(self.device)

    @classmethod
    def from_checkpoint(cls, path: str, device=None):
        from ..nn import owlvit as owlvit_lib
        from ..runtime import convert

        config = owlvit_lib.owlvit_base_patch32()
        state_dict = convert.load_owlvit_state_dict(path)
        tokenizer = toklib.default_tokenizer()
        tok_dir = os.path.join(path, "tokenizer")
        if os.path.exists(os.path.join(tok_dir, "vocab.json")):
            tokenizer = toklib.ClipBpeTokenizer.from_dir(tok_dir)
        return cls(state_dict, config, tokenizer, device=device)

    def _encode(self, texts: list[str], pad_queries: int) -> np.ndarray:
        """Tokenize a query list, padded to pad_queries rows of empty ids."""
        max_len = self.config.text.max_length
        ids = np.asarray(
            [self.tokenizer.encode(t, pad_to=max_len)[:max_len] for t in texts],
            np.int64,
        ) % self.config.text.vocab_size
        if pad_queries > len(texts):
            ids = np.pad(ids, ((0, pad_queries - len(texts)), (0, 0)))
        return ids

    @staticmethod
    def _post(boxes: np.ndarray, logits: np.ndarray):
        """(N, 4) cxcywh + (N, Q) logits -> (xyxy, scores, labels)."""
        probs = 1.0 / (1.0 + np.exp(-logits))   # (N, Q)
        scores = probs.max(axis=-1)
        labels = probs.argmax(axis=-1)
        cx, cy, w, h = boxes.T
        # NOT clipped to [0,1]: the reference's post_process keeps raw corner
        # coordinates (eval.py:136-144), and the predicates consume them as
        # they are.
        xyxy = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
        return xyxy, scores, labels

    @torch.no_grad()
    def __call__(self, image: np.ndarray, texts: list[str]):
        from ..nn import owlvit as owlvit_lib

        pixels = owlvit_lib.preprocess_image(image, self.config.image_size)
        # The query axis padded to the next power of two with empty queries,
        # as the JAX side buckets it (queries are independent); the padded
        # columns are sliced off below.
        n_q = len(texts)
        ids = self._encode(texts, _pow2(n_q))
        boxes, logits = self.model(torch.from_numpy(pixels).to(self.device),
                                   torch.from_numpy(ids).to(self.device))
        return self._post(boxes[0].cpu().numpy(), logits[0].cpu().numpy()[:, :n_q])

    @torch.no_grad()
    def dispatch_batch(self, images: list[np.ndarray], texts_list: list[list[str]]):
        """Launch one batched forward over B images, each with its OWN query
        set (padded to the chunk's power-of-two query bucket). Returns the
        (boxes, logits) device tensors unsynchronised, so that the caller can
        read and score neighbouring chunks on the host meanwhile;
        finalize_batch copies them to the host.

        Images go to the device as uint8 at source resolution and are
        bicubic-resized and normalized there. Mixed source sizes in one chunk
        (no generation CLI writes them) take the host PIL resize, and the
        device resize then has identity matrices."""
        from ..nn import owlvit as owlvit_lib

        size = self.config.image_size
        if len({img.shape for img in images}) == 1:
            pixels = np.stack(images)
        else:
            pixels = np.stack([owlvit_lib.resize_image(img, size) for img in images])
        wy = owlvit_lib.pil_bicubic_weights(pixels.shape[1], size)
        wx = owlvit_lib.pil_bicubic_weights(pixels.shape[2], size)
        b_q = _pow2(max(len(t) for t in texts_list))
        ids = np.stack([self._encode(t, b_q) for t in texts_list])
        x = torch.from_numpy(pixels).to(self.device, non_blocking=True)
        x = owlvit_lib.device_resize_bicubic(
            x, torch.from_numpy(wy).to(self.device), torch.from_numpy(wx).to(self.device))
        x = (x / 255.0 - self._mean) / self._std
        return self.model(x, torch.from_numpy(ids).to(self.device))

    def finalize_batch(self, dispatched, texts_list: list[list[str]]):
        """Copy a dispatch_batch result to the host -> per-image (xyxy,
        scores, labels) with query pads sliced to each image's real count."""
        boxes, logits = (t.cpu().numpy() for t in dispatched)
        return [self._post(boxes[i], logits[i][:, :len(t)])
                for i, t in enumerate(texts_list)]

    def detect_batch(self, images: list[np.ndarray], texts_list: list[list[str]]):
        """One batched forward; results match per-image __call__ (<=2 LSB
        resize deviation aside: see pil_bicubic_weights)."""
        return self.finalize_batch(self.dispatch_batch(images, texts_list), texts_list)


def eval_prompt(
    prompt: str,
    image: np.ndarray,
    detector,
    score_threshold: float = 0.15,
    nms_threshold: float = 0.15,
    use_class_aware_nms: bool = True,
    top_k_pre_nms: int | None = None,
    verbose: bool = False,
) -> tuple[str, bool]:
    """Score one generated image against its benchmark prompt."""
    texts, eval_info = get_eval_info_from_prompt(prompt)
    text = texts[0]
    detections = detector(image, text)
    return _score_detections(
        prompt, text, eval_info, detections, np.asarray(image).shape[:2],
        score_threshold, nms_threshold, use_class_aware_nms, top_k_pre_nms,
        verbose)


def _score_detections(
    prompt: str,
    text: list[str],
    eval_info: dict,
    detections,
    image_hw: tuple[int, int],
    score_threshold: float = 0.15,
    nms_threshold: float = 0.15,
    use_class_aware_nms: bool = True,
    top_k_pre_nms: int | None = None,
    verbose: bool = False,
) -> tuple[str, bool]:
    boxes, scores, labels = detections
    keep = scores >= score_threshold
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]

    # Pre-NMS cap (score-sorted top-K), opt-in: the reference protocol has no
    # cap (eval.py:11-105). Greedy NMS visits boxes in descending score
    # order, so truncation changes the report only if a box beyond K would
    # have survived suppression by all K higher-scoring ones.
    if top_k_pre_nms and len(scores) > top_k_pre_nms:
        top = np.argsort(-scores, kind="stable")[:top_k_pre_nms]
        boxes, scores, labels = boxes[top], scores[top], labels[top]

    if use_class_aware_nms:
        boxes, scores, labels = class_aware_nms(boxes, scores, labels, nms_threshold)
    else:
        kept = nms(np.asarray(boxes), np.asarray(scores), nms_threshold)
        boxes, scores, labels = boxes[kept], scores[kept], labels[kept]

    # Predicate box space: the image's own pixel size (reference eval.py:130,
    # 168; the 512 LLM canvas for production images).
    height, width = image_hw
    det_boxes = [
        {"name": text[int(label)],
         "bounding_box": to_gen_box_format(box, width, height),
         "score": float(score)}
        for box, score, label in zip(boxes, scores, labels)
    ]
    if verbose:
        print(f"prompt: {prompt}, detections: {det_boxes}")
    return eval_info["type"], bool(eval_info["predicate"](det_boxes))


def evaluate_run(
    run_base_path: str,
    detector,
    prompt_type: str = "lmd",
    model: str = "gpt-4",
    skip_first_prompts: int = 0,
    num_prompts: int | None = None,
    repeats: int = 1,
    run_start_ind: int = 0,
    verbose: bool = False,
    eval_batch: int = 8,
    **eval_kwargs,
) -> EvalReport:
    """Walk a generation run directory ({ind}/img_{r}.png) and score every
    image (reference owl_vit_eval.py:61-102). run_start_ind offsets the
    directory index relative to the prompt index (owl_vit_eval.py:22,61),
    for scoring a run produced with --skip_first_prompts.

    When the detector has detect_batch (OwlViTDetector), images are scored
    in eval_batch-sized chunks, one forward each (the reference evaluates
    one image at a time); the last chunk is padded by repeating its final
    job (pad results discarded), as on the JAX side. With dispatch_batch,
    chunk k+1 is launched before chunk k is copied back and scored, so PNG
    reads and scoring on the host overlap the device's work."""
    from PIL import Image

    prompts = get_prompts(prompt_type, model=model)
    jobs = []  # (prompt, image-path)
    for ind, prompt in enumerate(prompts):
        if isinstance(prompt, list):
            prompt = prompt[0]
        prompt = prompt.strip().rstrip(".")
        if ind < skip_first_prompts:
            continue
        if num_prompts is not None and ind >= skip_first_prompts + num_prompts:
            continue
        for repeat in range(repeats):
            path = os.path.join(run_base_path, str(ind + run_start_ind), f"img_{repeat}.png")
            if not os.path.exists(path):
                if verbose:
                    print(f"missing image: {path}")
                continue
            jobs.append((prompt, path))

    report = EvalReport()
    batched = eval_batch > 1 and hasattr(detector, "detect_batch")
    if not batched:
        for prompt, path in jobs:
            image = np.asarray(Image.open(path).convert("RGB"))
            eval_type, success = eval_prompt(prompt, image, detector,
                                             verbose=verbose, **eval_kwargs)
            report.record(eval_type, success)
        return report

    can_pipeline = hasattr(detector, "dispatch_batch")
    pending = None  # (chunk, n_real, hw_list, texts_list, infos, device_out)

    def _drain(p):
        chunk, n_real, hw_list, texts_list, infos, out = p
        detections = detector.finalize_batch(out, texts_list) if can_pipeline else out
        for i in range(n_real):
            eval_type, success = _score_detections(
                chunk[i][0], texts_list[i], infos[i], detections[i],
                hw_list[i], verbose=verbose, **eval_kwargs)
            report.record(eval_type, success)

    for start in range(0, len(jobs), eval_batch):
        chunk = jobs[start:start + eval_batch]
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (eval_batch - n_real)
        images, texts_list, infos = [], [], []
        for prompt, path in chunk:
            images.append(np.asarray(Image.open(path).convert("RGB")))
            texts, eval_info = get_eval_info_from_prompt(prompt)
            texts_list.append(texts[0])
            infos.append(eval_info)
        hw_list = [img.shape[:2] for img in images]
        out = (detector.dispatch_batch(images, texts_list) if can_pipeline
               else detector.detect_batch(images, texts_list))
        if pending is not None:
            _drain(pending)
        pending = (chunk, n_real, hw_list, texts_list, infos, out)
    if pending is not None:
        _drain(pending)
    return report
