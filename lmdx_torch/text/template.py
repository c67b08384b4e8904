"""In-context layout-generation templates and default negative prompts.

The template instructs the LLM to emit the grammar that `lmdx_torch.text.parser`
consumes:

    Objects: [('name', [x, y, w, h]), ...]
    Background prompt: ...
    Negative prompt: ...

with pixel coordinates on a 512x512 canvas (parity with the reference
response grammar, prompt.py:2-41 and utils/parse.py). The
instruction wording and few-shot examples here are this project's own; the
response *format* is byte-compatible so cached reference responses parse
unchanged.
"""

TEMPLATE_V0_1 = """You are an intelligent bounding box generator. Given a caption for a photo, image, or painting, produce box layouts for each object the caption mentions, plus a background prompt describing the scene. Canvas size is 512x512; the origin [0, 0] is the top-left corner and [512, 512] is the bottom-right corner. Boxes must stay inside the canvas and should not overlap. Write each box as (object name, [top-left x, top-left y, width, height]), one object per box — split groups into individual boxes. The background prompt must not mention the boxed objects, and must not mention excluded or non-existing objects; if the caption gives no background, use "A realistic scene". Make reasonable guesses when details are missing. Follow the format of the examples below exactly.

Caption: A realistic photo of a grassy field with a brown horse grazing on the right of a white goat, under a yellow hot air balloon
Objects: [('a brown horse', [287, 281, 180, 160]), ('a white goat', [66, 301, 145, 141]), ('a yellow hot air balloon', [178, 26, 156, 176])]
Background prompt: A realistic photo of a grassy field
Negative prompt:

Caption: A realistic top-down view of a desk with three pencils lined up beside a notebook
Objects: [('a pencil', [68, 230, 40, 150]), ('a pencil', [128, 230, 40, 150]), ('a pencil', [188, 230, 40, 150]), ('a notebook', [268, 180, 190, 240])]
Background prompt: A realistic top-down view of a desk
Negative prompt:

Caption: An oil painting of a lighthouse on a cliff with two sailboats on the sea
Objects: [('a lighthouse', [303, 72, 116, 240]), ('a sailboat', [46, 334, 120, 110]), ('a sailboat', [205, 355, 106, 97])]
Background prompt: An oil painting of a cliff by the sea
Negative prompt:

Caption: A watercolor of a sleepy cat and a playful puppy without people
Objects: [('a sleepy cat', [51, 197, 202, 192]), ('a playful puppy', [294, 208, 181, 188])]
Background prompt: A watercolor scene
Negative prompt: people

Caption: Two owls perched on a branch at night without stars
Objects: [('an owl', [108, 151, 123, 158]), ('an owl', [286, 143, 127, 165])]
Background prompt: A realistic night scene with a branch
Negative prompt: stars

Caption: A cozy living room without lamps, with a sofa against the wall, a coffee table in front of the sofa, and two cushions on the sofa
Objects: [('a sofa', [64, 251, 384, 186]), ('a coffee table', [145, 380, 222, 96]), ('a cushion', [120, 280, 89, 70]), ('a cushion', [303, 280, 89, 70])]
Background prompt: A cozy living room
Negative prompt: lamps

Caption: {prompt}
Objects:
"""

# Reference-compatible default negative prompts (generation hyperparameters;
# prompt.py:43-44). The per-object pass additionally suppresses
# duplicates/crowds since each pass must render exactly one instance.
DEFAULT_SO_NEGATIVE_PROMPT = (
    "artifacts, blurry, smooth texture, bad quality, distortions, unrealistic, "
    "distorted image, bad proportions, duplicate, two, many, group, occlusion, "
    "occluded, side, border, collate"
)
DEFAULT_OVERALL_NEGATIVE_PROMPT = (
    "artifacts, blurry, smooth texture, bad quality, distortions, unrealistic, "
    "distorted image, bad proportions, duplicate"
)

TEMPLATES = {"v0.1": TEMPLATE_V0_1}
TEMPLATE_VERSIONS = list(TEMPLATES)

# Responses end with a blank line; used as the completion stop sequence.
STOP = "\n\n"


def get_full_prompt(template: str, prompt: str, suffix: str | None = None) -> str:
    full = template.format(prompt=prompt)
    if suffix:
        full += suffix
    return full
