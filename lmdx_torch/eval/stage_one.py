"""Stage-1 evaluation: score the LLM's layout boxes directly with the task
predicates (no image generation or detection involved). A copy of the JAX
package's eval/stage_one.py; nothing here touches a device.

Parity: the reference's scripts/eval_stage_one.py. Given cached layouts this
is fully deterministic and reproduces the published stage-1 numbers
(99.0% GPT-3.5 / 100.0% GPT-4, README.md:148-151).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..text.llm_client import LLMConfig, get_parsed_layout
from .predicates import get_eval_info_from_prompt
from .prompts import get_prompts


@dataclass
class EvalReport:
    success_counts: dict[str, int] = field(default_factory=dict)
    total_counts: dict[str, int] = field(default_factory=dict)

    def record(self, eval_type: str, success: bool) -> None:
        self.success_counts[eval_type] = self.success_counts.get(eval_type, 0) + int(success)
        self.total_counts[eval_type] = self.total_counts.get(eval_type, 0) + 1

    @property
    def overall_rate(self) -> float:
        total = sum(self.total_counts.values())
        return sum(self.success_counts.values()) / total if total else 0.0

    def rate(self, eval_type: str) -> float:
        return self.success_counts[eval_type] / self.total_counts[eval_type]

    def summary(self) -> str:
        lines = []
        for k in self.total_counts:
            lines.append(
                f"Eval type: {k}, success: {self.success_counts[k]}/{self.total_counts[k]}, "
                f"rate: {self.rate(k):.2f}"
            )
        total = sum(self.total_counts.values())
        lines.append(
            f"Overall: success: {sum(self.success_counts.values())}/{total}, "
            f"rate: {self.overall_rate:.2f}"
        )
        return "\n".join(lines)


def eval_layout(prompt: str, gen_boxes) -> tuple[str, bool]:
    """Evaluate one prompt's layout boxes; returns (eval_type, success)."""
    _, eval_info = get_eval_info_from_prompt(prompt)
    return eval_info["type"], bool(eval_info["predicate"](gen_boxes))


def evaluate_stage_one(
    prompt_type: str,
    config: LLMConfig,
    cache,
    skip_first_prompts: int = 0,
    num_prompts: int | None = None,
    verbose: bool = False,
) -> EvalReport:
    """Run stage-1 eval over a benchmark split, pulling layouts from the
    cache (querying the LLM on miss)."""
    prompts = get_prompts(prompt_type, model=config.model)
    report = EvalReport()
    for ind, prompt in enumerate(prompts):
        if isinstance(prompt, list):
            prompt = prompt[0]
        prompt = prompt.strip().rstrip(".")
        if ind < skip_first_prompts:
            continue
        if num_prompts is not None and ind >= skip_first_prompts + num_prompts:
            continue
        layout = get_parsed_layout(prompt, config, cache=cache)
        eval_type, success = eval_layout(prompt, layout.gen_boxes)
        if verbose:
            print(f"[{ind}] {eval_type}: {success} ({prompt})")
        report.record(eval_type, success)
    return report
