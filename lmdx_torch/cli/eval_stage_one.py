"""Stage-1 evaluation CLI: score cached LLM layouts with the task predicates.

The port's copy of the JAX package's cli/eval_stage_one.py, with the same
flags. Parity: reference scripts/eval_stage_one.py. Fully offline given a
layout cache; reproduces the published stage-1 numbers (README.md:148-151).

Example:
    python -m lmdx_torch.cli.eval_stage_one --model gpt-4 \
        --cache cache/cache_lmd_v0.1_gpt-4.json
"""

from __future__ import annotations

import argparse

from ..eval.stage_one import evaluate_stage_one
from ..text.cache import LayoutCache, cache_filename
from ..text.llm_client import get_llm_config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--prompt-type", default="lmd")
    parser.add_argument("--model", default="gpt-4")
    parser.add_argument("--template_version", default="v0.1")
    parser.add_argument("--cache", default=None, help="layout cache JSON path")
    parser.add_argument("--cache-dir", default="cache")
    parser.add_argument("--skip_first_prompts", default=0, type=int)
    parser.add_argument("--num_prompts", default=None, type=int)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="accepted as the JAX CLI accepts it; stage 1 runs "
                             "nothing on a device")
    args = parser.parse_args(argv)

    path = args.cache or cache_filename(args.prompt_type, args.template_version,
                                        args.model, args.cache_dir)
    cache = LayoutCache(path, allow_nonexist=False)
    config = get_llm_config(args.model, template_version=args.template_version)

    report = evaluate_stage_one(
        args.prompt_type, config, cache,
        skip_first_prompts=args.skip_first_prompts,
        num_prompts=args.num_prompts,
        verbose=args.verbose,
    )
    print(report.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
