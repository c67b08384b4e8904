"""Stage-1 batch tool: query the LLM for layouts over a prompt set and cache
responses.

Parity: reference prompt_batch.py — per prompt: cache lookup, LLM query on
miss (or template printout for manual copy-paste when no endpoint), parse
with bounded retries, write-through cache save.

The port's copy of the JAX package's cli/prompt_batch.py, with the same
flags.

Example (offline template printout):
    python -m lmdx_torch.cli.prompt_batch --prompt-type demo --model gpt-4 --show-template
"""

from __future__ import annotations

import argparse
import time

from ..eval.prompts import get_prompts
from ..text.cache import LayoutCache, cache_filename
from ..text.llm_client import get_llm_config, query_layout
from ..text.parser import ParseError, filter_boxes, parse_layout_response
from ..text.template import TEMPLATES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--prompt-type", default="demo")
    parser.add_argument("--model", default="gpt-4")
    parser.add_argument("--template_version", default="v0.1")
    parser.add_argument("--auto-query", action="store_true",
                        help="query the LLM endpoint instead of printing the template")
    parser.add_argument("--interactive", action="store_true",
                        help="on cache miss, print the full template prompt "
                             "and read a manually pasted response from stdin "
                             "(the reference's default no-endpoint flow, "
                             "prompt_batch.py:62-105; opt-in here so batch "
                             "jobs never block on a tty)")
    parser.add_argument("--always-save", action="store_true",
                        help="with --interactive: save parsed layouts "
                             "without the Save (y/n)? confirmation "
                             "(reference prompt_batch.py:25)")
    parser.add_argument("--show-template", action="store_true")
    parser.add_argument("--skip_first_prompts", default=0, type=int)
    parser.add_argument("--num_prompts", default=None, type=int)
    parser.add_argument("--cache-dir", default="cache")
    parser.add_argument("--max-retries", default=3, type=int)
    parser.add_argument("--api-base", default="",
                        help="override the LLM endpoint base URL (e.g. a "
                             "self-hosted OpenAI-compatible server)")
    parser.add_argument("--api-key", default="")
    parser.add_argument("--cpu", action="store_true",
                        help="accepted as the JAX CLI accepts it; stage 1 runs "
                             "nothing on a device")
    parser.add_argument("--no-visualize", action="store_true",
                        help="skip boxes_{ind}.png layout renderings "
                             "(reference prompt_batch.py:26)")
    parser.add_argument("--visualize-cache-hit", action="store_true",
                        help="also render layouts for cache hits "
                             "(reference prompt_batch.py:109-116)")
    args = parser.parse_args(argv)

    template = TEMPLATES[args.template_version]
    if args.show_template:
        print(template.format(prompt="<your caption here>"))
        if not args.auto_query:
            return 0

    config = get_llm_config(args.model, template_version=args.template_version,
                            api_base=args.api_base, api_key=args.api_key)
    cache = LayoutCache(cache_filename(args.prompt_type, args.template_version,
                                       args.model, args.cache_dir))
    prompts = get_prompts(args.prompt_type, model=args.model)

    # Layout renderings (reference prompt_batch.py:38-41 img_dir convention).
    vis_dir = (f"img_generations/imgs_{args.prompt_type}"
               f"_template{args.template_version}")

    def read_manual_response() -> str:
        """Assemble a response pasted line by line, mirroring the
        reference's interactive flow (utils/parse.py:28-124: the objects
        line first, then background / negative prompts if missing)."""
        text = input("Enter the response: ").strip()
        if "Objects:" in text:
            text = text.split("Objects:", 1)[1].strip()
        if "Background prompt:" not in text:
            bg = ""
            while not bg:
                bg = input("Enter the background prompt: ").strip()
            if "Background prompt:" in bg:
                bg = bg.split("Background prompt:", 1)[1].strip()
            text += f"\nBackground prompt: {bg}"
        if "Negative prompt:" not in text:
            neg = input("Enter the negative prompt (can be empty): ").strip()
            if "Negative prompt:" in neg:
                neg = neg.split("Negative prompt:", 1)[1].strip()
            text += f"\nNegative prompt: {neg}"
        return text

    def visualize(ind: int, resp: str) -> None:
        if args.no_visualize:
            return
        import os

        from ..utils import vis

        try:
            layout = parse_layout_response(resp)
        except ParseError as e:
            print(f"[{ind}] cannot visualize (parse error): {e}")
            return
        boxes = filter_boxes(layout.gen_boxes)
        os.makedirs(vis_dir, exist_ok=True)
        vis.draw_boxes(boxes, bg_prompt=layout.bg_prompt,
                       neg_prompt=layout.neg_prompt).save(
            f"{vis_dir}/boxes_{ind}.png")

    for ind, prompt in enumerate(prompts):
        if isinstance(prompt, list):
            prompt = prompt[0]
        prompt = prompt.strip().rstrip(".")
        if ind < args.skip_first_prompts:
            continue
        if args.num_prompts is not None and ind >= args.skip_first_prompts + args.num_prompts:
            continue

        if prompt in cache:
            print(f"[{ind}] cached: {prompt}")
            if args.visualize_cache_hit:
                visualize(ind, cache.get(prompt))
            continue
        if not args.auto_query:
            if not args.interactive:
                print(f"[{ind}] NOT cached (run with --auto-query or "
                      f"--interactive to paste manually): {prompt}")
                continue
            # Manual flow: print the filled template, read a pasted
            # response, confirm, save (reference prompt_batch.py:62-105).
            print("#########")
            print(template.format(prompt=prompt))
            print("#########")
            for attempt in range(args.max_retries):
                try:
                    resp = read_manual_response()
                    layout = parse_layout_response(resp)
                    filter_boxes(layout.gen_boxes)
                except (ParseError, EOFError) as e:
                    print(f"[{ind}] invalid response (attempt "
                          f"{attempt + 1}): {e}")
                    continue
                visualize(ind, resp)
                if not args.always_save:
                    save = input("Save (y/n)? ").strip()
                    if save not in ("y", "Y"):
                        print("Not saved; asking again.")
                        continue
                cache.add(prompt, resp)
                print(f"[{ind}] saved layout for: {prompt}")
                break
            else:
                print(f"[{ind}] giving up after {args.max_retries} attempts")
            continue

        for attempt in range(args.max_retries):
            resp = query_layout(prompt, config)
            try:
                layout = parse_layout_response(resp)
                filter_boxes(layout.gen_boxes)
            except ParseError as e:
                print(f"[{ind}] parse failed (attempt {attempt + 1}): {e}")
                time.sleep(10)
                continue
            cache.add(prompt, resp)
            print(f"[{ind}] saved layout for: {prompt}")
            visualize(ind, resp)
            break
        else:
            print(f"[{ind}] giving up after {args.max_retries} attempts: {prompt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
