"""LLM layout-response parsing, box filtering, and spec conversion.

Stage 1 of the pipeline: the LLM replies with

    Objects: [('a blue cube', [x, y, w, h]), ...]
    Background prompt: <scene description>
    Negative prompt: <things to exclude>

with boxes in pixel (x, y, w, h) on a 512x512 canvas. This module parses that
grammar, sanitizes the boxes, and converts a layout "spec" into the prompt /
phrase / word / box structures stage 2 consumes.

Behavioral parity with the reference (file:line into the reference tree):
- response grammar & fallbacks  -> utils/parse.py:66-124
- box filtering / rescaling     -> utils/parse.py:126-226
- spec conversion & pluralizing -> utils/parse.py:313-367
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

import numpy as np

from ..core import boxes as boxlib
from . import english

# (height, width) of the canvas the LLM works on.
BOX_SCALE = (512, 512)

OBJECTS_TEXT = "Objects: "
BG_PROMPT_TEXT = "Background prompt:"
NEG_PROMPT_TEXT = "Negative prompt:"


class ParseError(ValueError):
    """Raised when an LLM response does not follow the layout grammar."""


@dataclass
class Layout:
    """A parsed stage-1 layout: captioned pixel boxes + scene prompts."""

    gen_boxes: list  # [(name, (x, y, w, h)), ...] pixel units on BOX_SCALE
    bg_prompt: str = ""
    neg_prompt: str = ""


@dataclass
class Spec:
    """Input to a stage-2 method (see cli/generate.py for construction)."""

    prompt: str
    gen_boxes: list
    bg_prompt: str = ""
    extra_neg_prompt: str = ""

    def as_dict(self):
        return {
            "prompt": self.prompt,
            "gen_boxes": self.gen_boxes,
            "bg_prompt": self.bg_prompt,
            "extra_neg_prompt": self.extra_neg_prompt,
        }


def parse_layout_response(text: str, strict: bool = True, ask=None) -> Layout:
    """Parse a raw LLM response into a `Layout`.

    strict: raise on missing sections instead of asking.
    ask: optional callable(prompt_str) -> str for interactive recovery of
         missing sections (used by the CLI; tests/servers keep strict=True).
    """
    if not text:
        raise ParseError("Empty LLM response")

    if OBJECTS_TEXT in text:
        text = text.split(OBJECTS_TEXT)[1]

    parts = text.split(BG_PROMPT_TEXT)
    if len(parts) == 2:
        boxes_text, rest = parts
    elif len(parts) == 1:
        if strict or ask is None:
            raise ParseError(f"No background prompt in: {text!r}")
        boxes_text = text
        rest = ""
        while not rest:
            rest = ask("Enter the background prompt: ").strip()
        if BG_PROMPT_TEXT in rest:
            rest = rest.split(BG_PROMPT_TEXT)[1]
    else:
        raise ParseError(f"Multiple background prompts in: {text!r}")

    parts = rest.split(NEG_PROMPT_TEXT)
    if len(parts) == 2:
        bg_prompt, neg_prompt = parts
    elif len(parts) == 1:
        bg_prompt, neg_prompt = rest, ""
        if not strict and ask is not None:
            neg_prompt = ask("Enter the negative prompt: ").strip()
            if NEG_PROMPT_TEXT in neg_prompt:
                neg_prompt = neg_prompt.split(NEG_PROMPT_TEXT)[1]
    else:
        raise ParseError(f"Multiple negative prompts in: {text!r}")

    try:
        gen_boxes = ast.literal_eval(boxes_text)
    except (SyntaxError, ValueError) as e:
        # The LLM sometimes answers in plain text for empty layouts.
        if "No objects" in boxes_text or boxes_text.strip() == "":
            gen_boxes = []
        else:
            raise ParseError(f"Cannot parse boxes: {boxes_text!r}") from e

    bg_prompt = bg_prompt.strip()
    neg_prompt = neg_prompt.strip()
    if neg_prompt == "None":  # some LLMs spell out the absence
        neg_prompt = ""

    return Layout(gen_boxes=gen_boxes, bg_prompt=bg_prompt, neg_prompt=neg_prompt)


def _unpack_box(gen_box):
    """Accept both ('name', [x,y,w,h]) tuples and {'name','bounding_box'} dicts."""
    if isinstance(gen_box, dict):
        return gen_box["name"], gen_box["bounding_box"], True
    return gen_box[0], gen_box[1], False


def _pack_box(name, bbox, dict_format):
    if dict_format:
        return {"name": name, "bounding_box": bbox}
    return (name, bbox)


def filter_boxes(gen_boxes, scale_boxes: bool = True, ignore_background: bool = True,
                 max_scale: float = 3):
    """Sanitize LLM boxes: drop degenerate/background boxes; rescale to fit.

    If any box is out of the 512x512 canvas, all boxes are scaled/shifted
    jointly so the layout fits (never upscaled beyond `max_scale`), keeping
    relative placement.
    """
    if not gen_boxes:
        return []

    size_h, size_w = BOX_SCALE
    kept = []
    dict_format = False
    for gen_box in gen_boxes:
        name, bbox, is_dict = _unpack_box(gen_box)
        dict_format = dict_format or is_dict
        if not bbox:
            continue
        x, y, w, h = bbox
        if w <= 0 or h <= 0:
            continue
        if ignore_background:
            # Full-canvas boxes or boxes starting beyond the canvas describe
            # the background, which the bg_prompt already covers.
            if (w >= size_w and h >= size_h) or x > size_w or y > size_h:
                continue
        if x < 0 or y < 0 or x + w > size_w or y + h > size_h:
            scale_boxes = True  # out-of-bounds: force a joint rescale
        kept.append((name, (x, y, w, h), is_dict))

    if not kept:
        return []

    x_lo = min(b[1][0] for b in kept)
    x_hi = max(b[1][0] + b[1][2] for b in kept)
    y_lo = min(b[1][1] for b in kept)
    y_hi = max(b[1][1] + b[1][3] for b in kept)
    if x_hi - x_lo == 0:
        return []

    shift = -x_lo
    scale = min(size_w / (x_hi - x_lo), size_h / (y_hi - y_lo), max_scale)

    out = []
    for name, (x, y, w, h), is_dict in kept:
        if scale_boxes:
            x = (x + shift) * scale
            y = y * scale
            w, h = w * scale, h * scale
            # Move the whole layout back into frame vertically.
            y_off = 0.0
            if y_lo * scale + y_off < 0:
                y_off -= y_lo * scale
            if y_hi * scale + y_off >= size_h:
                y_off -= y_hi * scale - size_h
            y += y_off
            if y < 0:
                y, h = 0, h - y
        name = name.rstrip(".")
        bbox = (int(np.round(x)), int(np.round(y)), int(np.round(w)), int(np.round(h)))
        out.append(_pack_box(name, bbox, is_dict))
    return out


def strip_article(phrase: str) -> str:
    """Remove indefinite articles from a noun phrase ('an angry dog' -> 'angry dog')."""
    return phrase.replace("an ", "").replace("a ", "")


@dataclass
class ConvertedSpec:
    """Stage-2-ready structures derived from a `Spec`.

    so_prompt_phrase_word_box: one (prompt, phrase, word, box) per object for
        the per-box single-object passes; `word` is the token whose
        cross-attention drives mask extraction.
    overall_prompt: the composed scene prompt for the final pass.
    overall_phrases_words_bboxes: deduplicated (phrase, word, [boxes]) with
        pluralized counted phrases ('two apples').
    """

    so_prompt_phrase_word_box: list = field(default_factory=list)
    overall_prompt: str = ""
    overall_phrases_words_bboxes: list = field(default_factory=list)


def convert_spec(spec, height: int, width: int, include_counts: bool = True) -> ConvertedSpec:
    """Derive per-box and overall prompts/phrases/boxes from a layout spec.

    Boxes are sorted by object name so that the flattened overall box list
    corresponds exactly to the per-object list (duplicate-name objects stay
    adjacent).
    """
    if isinstance(spec, Spec):
        spec = spec.as_dict()
    gen_boxes, bg_prompt = spec["gen_boxes"], spec.get("bg_prompt", "")

    # Accept both ('name', box) tuples and {'name','bounding_box'} dicts
    # (stage-1 helpers emit the dict format, reference utils/llm.py:113-140).
    gen_boxes = [(_unpack_box(b)[0], _unpack_box(b)[1]) for b in gen_boxes]
    gen_boxes = sorted(gen_boxes, key=lambda b: b[0])
    gen_boxes = [
        (name, boxlib.convert_box_xywh_to_xyxy_norm(box, height=height, width=width))
        for name, box in gen_boxes
    ]

    # The per-object prompt keeps all words of the object name (so "an orange
    # dog" is not read as "an orange"); the guidance word is its last word.
    if bg_prompt:
        so_list = [
            (f"{bg_prompt} with {name}", name, name.split(" ")[-1], box)
            for name, box in gen_boxes
        ]
    else:
        so_list = [(name, name, name.split(" ")[-1], box) for name, box in gen_boxes]

    names = [name for name, _ in gen_boxes]
    unique_names = sorted(set(names))

    overall = []
    total_matched = 0
    for name in unique_names:
        bboxes = [box for n, box in gen_boxes if n == name]
        count = names.count(name)
        if count > 1:
            phrase = english.pluralize(strip_article(name))
            if include_counts:
                phrase = f"{english.number_to_words(count)} {phrase}"
        else:
            phrase = name
        word = phrase.split(" ")[-1]
        total_matched += len(bboxes)
        overall.append((phrase, word, bboxes))
    assert total_matched == len(gen_boxes), f"{total_matched} != {len(gen_boxes)}"

    objects_str = ", ".join(phrase for phrase, _, _ in overall)
    if objects_str:
        overall_prompt = f"{bg_prompt} with {objects_str}" if bg_prompt else objects_str
    else:
        overall_prompt = bg_prompt

    return ConvertedSpec(
        so_prompt_phrase_word_box=so_list,
        overall_prompt=overall_prompt,
        overall_phrases_words_bboxes=overall,
    )
