"""Task predicates and prompt->predicate re-derivation for the benchmark.

A predicate takes `gen_boxes` — a list of {'name': str, 'bounding_box': box}
dicts (boxes from the LLM in stage-1 eval, or from the OWL-ViT detector in
stage-2 eval) — and returns success as bool.

A copy of the JAX package's eval/predicates.py.

Parity: the reference's utils/eval/utils.py (predicates, word-boundary-safe
name matching, center-based spatial checks) and utils/eval/lmd.py:11-96
(regex re-derivation of the eval info from the prompt string).
"""

from __future__ import annotations

import re
from functools import partial

import numpy as np

from ..text import english

word_to_num_mapping = english.WORD_TO_NUM


def _name_matches_boundary(box_name: str, query: str) -> bool:
    """Word-boundary-safe containment: avoids 'car' matching 'carrot'."""
    return (query + " ") in box_name or box_name.endswith(query)


def get_box(gen_boxes, name_include):
    """First box whose name contains any query at a word boundary."""
    match = [
        any(_name_matches_boundary(box["name"], q) for q in name_include)
        for box in gen_boxes
    ]
    if not any(match):
        return None
    return gen_boxes[int(np.min(np.where(match)[0]))]


def count(gen_boxes, name_include) -> int:
    """Number of boxes whose name contains any query (plain substring)."""
    return sum(any(q in box["name"] for q in name_include) for box in gen_boxes)


def predicate_numeracy(query_names, intended_count, gen_boxes, verbose=False) -> bool:
    return count(gen_boxes, query_names) == intended_count


def predicate_numeracy_2obj(query_names1, intended_count1, query_names2, intended_count2,
                            gen_boxes, verbose=False) -> bool:
    return (
        count(gen_boxes, query_names1) == intended_count1
        and count(gen_boxes, query_names2) == intended_count2
    )


def predicate_attribution(query_names1, query_names2, modifier1, modifier2,
                          intended_count1, intended_count2, gen_boxes, verbose=False) -> bool:
    if modifier1:
        query_names1 = [f"{modifier1} {q}" for q in query_names1]
    count1 = count(gen_boxes, query_names1)
    if query_names2 is None:
        return count1 >= intended_count1
    if modifier2:
        query_names2 = [f"{modifier2} {q}" for q in query_names2]
    count2 = count(gen_boxes, query_names2)
    return count1 >= intended_count1 and count2 >= intended_count2


def predicate_spatial(query_names1, query_names2, verify_fn, gen_boxes, verbose=False) -> bool:
    box1 = get_box(gen_boxes, query_names1)
    box2 = get_box(gen_boxes, query_names2)
    if box1 is None or box2 is None:
        return False
    return verify_fn(box1["bounding_box"], box2["bounding_box"])


# Center comparisons over pixel (x, y, w, h) boxes.
LOCATIONS_XYWH = {
    ("left", "right"): lambda b1, b2: b1[0] + b1[2] / 2 < b2[0] + b2[2] / 2,
    ("right", "left"): lambda b1, b2: b1[0] + b1[2] / 2 > b2[0] + b2[2] / 2,
    ("top", "bottom"): lambda b1, b2: b1[1] + b1[3] / 2 < b2[1] + b2[3] / 2,
    ("bottom", "top"): lambda b1, b2: b1[1] + b1[3] / 2 > b2[1] + b2[3] / 2,
}


def get_eval_info_from_prompt(prompt: str):
    """Re-derive (detector query texts, eval info with predicate) from a
    benchmark prompt string. Mirrors utils/eval/lmd.py:11-96 so evaluation
    requires only the generated images and their prompts."""
    if "without" in prompt:
        object_name = english.singularize(re.search(r"without (.+)", prompt).group(1))
        texts = [[f"a photo of {english.a(object_name)}"]]
        predicate = partial(predicate_numeracy, (object_name,), 0)
        return texts, {"type": "negation", "predicate": predicate}

    if any(f"on the {loc}" in prompt for loc in ("left", "right", "top", "bottom")):
        m = re.search(r"with (.+) on the (.+) and (.+) on the (.+)", prompt)
        object_name1, location1, object_name2, location2 = m.groups()
        texts = [[f"a photo of {object_name1}", f"a photo of {object_name2}"]]
        verify_fn = LOCATIONS_XYWH[(location1, location2)]
        predicate = partial(predicate_spatial, (object_name1,), (object_name2,), verify_fn)
        return texts, {
            "type": "spatial", "location1": location1, "location2": location2,
            "predicate": predicate,
        }

    if "and" in prompt:
        if any(w in prompt for w in ("one", "two", "three", "four", "five")):
            # numeracy with two objects (not part of the standard 400 set)
            m = re.search(r"with (.+) (.+) and (.+) (.+)", prompt)
            number1, object_name1 = m.group(1), m.group(2)
            number2, object_name2 = m.group(3), m.group(4)
            number1 = word_to_num_mapping.get(number1, None) or int(number1)
            number2 = word_to_num_mapping.get(number2, None) or int(number2)
            object_name1 = english.singularize(object_name1)
            object_name2 = english.singularize(object_name2)
            texts = [[
                f"a photo of {english.a(object_name1)}",
                f"a photo of {english.a(object_name2)}",
            ]]
            predicate = partial(
                predicate_numeracy_2obj, (object_name1,), number1, (object_name2,), number2
            )
            return texts, {
                "type": "numeracy_2obj",
                "object_name1": object_name1, "number1": number1,
                "object_name2": object_name2, "number2": number2,
                "predicate": predicate,
            }
        # attribution: modifiers stay inside the query names
        m = re.search(r"with (.+) and (.+)", prompt)
        object_name1, object_name2 = m.group(1), m.group(2)
        texts = [[f"a photo of {object_name1}", f"a photo of {object_name2}"]]
        predicate = partial(
            predicate_attribution, (object_name1,), (object_name2,), None, None, 1, 1
        )
        return texts, {
            "type": "attribution",
            "object_name1": object_name1, "object_name2": object_name2,
            "predicate": predicate,
        }

    if "with" in prompt:
        m = re.search(r"with (.+) (.+)", prompt)
        number, object_name = m.group(1), m.group(2)
        number = word_to_num_mapping[number] if number in word_to_num_mapping else int(number)
        object_name = english.singularize(object_name)
        texts = [[f"a photo of {english.a(object_name)}"]]
        predicate = partial(predicate_numeracy, (object_name,), number)
        return texts, {
            "type": "numeracy", "object_name": object_name, "number": number,
            "predicate": predicate,
        }

    raise ValueError(f"Unknown benchmark prompt type: {prompt}")


# ---------------------------------------------------------------------------
# Detection post-processing for stage-2 (OWL-ViT) evaluation.
# Parity: utils/eval/eval.py:11-105 (NMS and class-aware NMS).
# ---------------------------------------------------------------------------

def nms(boxes: np.ndarray, scores: np.ndarray, threshold: float) -> list[int]:
    """Greedy IoU NMS over (N, 4) xyxy boxes; returns kept indices by score."""
    boxes = np.asarray(boxes, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou < threshold]  # strict, matching eval.py:75-76
    return keep


def class_aware_nms(boxes, scores, labels, threshold: float):
    """NMS run independently per label; returns (boxes, scores, labels) kept."""
    boxes = np.asarray(boxes)
    scores = np.asarray(scores)
    labels = np.asarray(labels)
    keep: list[int] = []
    # Output order = the reference's (eval.py:83-104): groups in ascending
    # label order, each group in descending score order. Order is
    # protocol-relevant — the spatial predicate takes the FIRST detection
    # matching a name (utils/eval/utils.py).
    for label in np.unique(labels):
        idx = np.where(labels == label)[0]
        kept_local = nms(boxes[idx], scores[idx], threshold)
        keep.extend(int(idx[k]) for k in kept_local)
    return boxes[keep], scores[keep], labels[keep]


def to_gen_box_format(box, width: float, height: float):
    """Normalized detector xyxy -> benchmark pixel xywh (eval.py:114-118)."""
    x_min, y_min, x_max, y_max = box
    return [x_min * width, y_min * height, (x_max - x_min) * width, (y_max - y_min) * height]
