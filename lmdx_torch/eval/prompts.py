"""The 400-prompt grounded-generation benchmark (negation / numeracy /
attribution / spatial). A copy of the JAX package's eval/prompts.py.

Prompt strings must match the reference generator byte-for-byte so that the
published LLM layout caches (keyed by prompt) and the published accuracy
numbers carry over. That means reproducing the exact legacy-numpy seeding
scheme: `np.random.seed(ind)` before each attribution/spatial draw and
`np.random.choice` over an object-dtype array (reference:
utils/eval/lmd.py:99-261). Verified by tests/test_eval_prompts.py against the
reference cache fixtures.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ..text import english
from . import predicates as preds

PROMPT_PREFIX = "A realistic photo of a scene"

EVALUATE_CLASSES = [
    "backpack", "book", "bottle", "bowl", "car",
    "cat", "chair", "cup", "dog", "laptop",
]

MODIFIERS = [
    "red", "orange", "yellow", "green", "blue",
    "purple", "pink", "brown", "black", "white", "gray",
]


def _as_query(object_name):
    if isinstance(object_name, tuple):
        return object_name[0], object_name
    return object_name, (object_name,)


def get_prompt_predicates_negation(repeat: int = 10):
    out = []
    for object_name in EVALUATE_CLASSES:
        object_name, query_names = _as_query(object_name)
        prompt = f"{PROMPT_PREFIX} without {english.pluralize(object_name)}".strip()
        out += [(prompt, partial(preds.predicate_numeracy, query_names, 0))] * repeat
    return out


def get_prompt_predicates_numeracy(min_num: int = 1, max_num: int = 5, repeat: int = 2):
    out = []
    for number in range(min_num, max_num + 1):
        for object_name in EVALUATE_CLASSES:
            object_name, query_names = _as_query(object_name)
            noun = english.pluralize(object_name) if number > 1 else object_name
            num_words = english.number_to_words(number) if number < 21 else number
            prompt = f"{PROMPT_PREFIX} with {num_words} {noun}".strip()
            out += [(prompt, partial(preds.predicate_numeracy, query_names, number))] * repeat
    return out


def get_prompt_predicates_attribution(num_prompts: int = 100, repeat: int = 1):
    out = []
    classes_np = np.array(EVALUATE_CLASSES, dtype=object)
    for ind in range(num_prompts):
        np.random.seed(ind)  # legacy global seeding: parity-critical
        modifier1, modifier2 = np.random.choice(MODIFIERS, 2, replace=False)
        object_name1, object_name2 = np.random.choice(classes_np, 2, replace=False)
        object_name1, query_names1 = _as_query(object_name1)
        object_name2, query_names2 = _as_query(object_name2)
        prompt = (
            f"{PROMPT_PREFIX} with {english.a(modifier1)} {object_name1}"
            f" and {english.a(modifier2)} {object_name2}"
        ).strip()
        predicate = partial(
            preds.predicate_attribution,
            query_names1, query_names2, modifier1, modifier2, 1, 1,
        )
        out += [(prompt, predicate)] * repeat
    return out


# (location1, location2, center-comparison on pixel xywh boxes)
SPATIAL_LOCATIONS = [
    ("left", "right", lambda b1, b2: b1[0] + b1[2] / 2 < b2[0] + b2[2] / 2),
    ("right", "left", lambda b1, b2: b1[0] + b1[2] / 2 > b2[0] + b2[2] / 2),
    ("top", "bottom", lambda b1, b2: b1[1] + b1[3] / 2 < b2[1] + b2[3] / 2),
    ("bottom", "top", lambda b1, b2: b1[1] + b1[3] / 2 > b2[1] + b2[3] / 2),
]


def get_prompt_predicates_spatial(num_prompts: int = 25, left_right_only: bool = False):
    out = []
    classes_np = np.array(EVALUATE_CLASSES, dtype=object)
    locations = SPATIAL_LOCATIONS[:2] if left_right_only else SPATIAL_LOCATIONS
    for ind in range(num_prompts):
        np.random.seed(ind)  # one seed per index; consumed across the 4 directions
        for location1, location2, verify_fn in locations:
            object_name1, object_name2 = np.random.choice(classes_np, 2, replace=False)
            object_name1, query_names1 = _as_query(object_name1)
            object_name2, query_names2 = _as_query(object_name2)
            prompt = (
                f"{PROMPT_PREFIX} with {english.a(object_name1)} on the {location1}"
                f" and {english.a(object_name2)} on the {location2}"
            ).strip()
            predicate = partial(preds.predicate_spatial, query_names1, query_names2, verify_fn)
            out.append((prompt, predicate))
    return out


def get_lmd_prompt_predicates(prompt_type: str = "lmd"):
    """(prompt, predicate) pairs for a benchmark split."""
    splits = {
        "lmd_negation": get_prompt_predicates_negation,
        "lmd_numeracy": get_prompt_predicates_numeracy,
        "lmd_attribution": get_prompt_predicates_attribution,
        "lmd_spatial": get_prompt_predicates_spatial,
    }
    if prompt_type == "lmd":
        out = []
        for fn in splits.values():
            out += fn()
        return out
    return splits[prompt_type]()


def get_lmd_prompts() -> dict[str, list[str]]:
    """Prompt lists per split, same keys as the reference (lmd.py:236-261)."""
    prompts = {
        key: [p for p, _ in get_lmd_prompt_predicates(key)]
        for key in ("lmd_negation", "lmd_numeracy", "lmd_attribution", "lmd_spatial")
    }
    prompts["lmd"] = sum(prompts.values(), start=[])
    # Reorder: 'lmd' first to mirror reference dict ordering (cosmetic).
    return {"lmd": prompts.pop("lmd"), **prompts}


# Demo prompts for quick qualitative checks (reference: prompt.py:55-59).
PROMPTS_DEMO = [
    "In an indoor scene, a blue cube directly above a red cube with a vase on the left of them.",
    "A realistic photo of a wooden table without bananas in an indoor scene",
    "A realistic image of a white deer and a gray bear in an empty factory scene",
]

PROMPT_TYPES = ["demo", "lmd_negation", "lmd_numeracy", "lmd_attribution", "lmd_spatial", "lmd"]


def get_prompts(prompt_type: str, model: str = "gpt-4", allow_non_exist: bool = False):
    """Prompt list for a prompt type; `model` keeps demo sets per model family
    (reference: prompt.py:74-103)."""
    if prompt_type.startswith("lmd"):
        return get_lmd_prompts()[prompt_type]
    if prompt_type == "demo":
        if "gpt-4" in model or "all" in model:
            return PROMPTS_DEMO
        return []
    if allow_non_exist:
        return []
    raise KeyError(prompt_type)
