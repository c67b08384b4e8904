"""Stage-2 evaluation CLI: detect objects in generated images and score the
benchmark predicates (port of the JAX package's cli/owl_vit_eval.py, with
every flag of it).

Parity: reference scripts/owl_vit_eval.py (OWL-ViT base-patch32, score
threshold 0.15, class-aware NMS 0.15: README.md:191). Runs on the card
unless --cpu is passed.

Example:
    python -m lmdx_torch.cli.owl_vit_eval \
        --run_base_path img_generations/templatev0.1_lmd_plus_lmd/run0 \
        --owlvit-checkpoint /path/to/owlvit-base-patch32
"""

from __future__ import annotations

import argparse

from ..eval.owl_vit import OwlViTDetector, evaluate_run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run_base_path", required=True)
    parser.add_argument("--prompt-type", default="lmd")
    parser.add_argument("--model", default="gpt-4")
    parser.add_argument("--owlvit-checkpoint", default=None,
                        help="transformers OwlViT checkpoint dir; random "
                             "weights are useless for scoring, so this is "
                             "required unless --detector-random is passed")
    parser.add_argument("--detector-random", action="store_true",
                        help="random weights from a seeded generator (seed 0): "
                             "a smoke run")
    parser.add_argument("--detection_score_threshold", default=0.15, type=float)
    parser.add_argument("--nms_threshold", default=0.15, type=float)
    parser.add_argument("--no-class-aware-nms", action="store_true")
    parser.add_argument("--class-aware-nms", action="store_true",
                        help="accepted for reference-CLI compatibility "
                             "(owl_vit_eval.py:29; there it is opt-in; "
                             "here class-aware NMS is already the default, "
                             "matching the published protocol)")
    parser.add_argument("--skip_first_prompts", default=0, type=int)
    parser.add_argument("--run_start_ind", default=0, type=int,
                        help="directory-index offset vs prompt index "
                             "(reference owl_vit_eval.py:22)")
    parser.add_argument("--num_prompts", default=None, type=int)
    parser.add_argument("--repeats", default=1, type=int)
    parser.add_argument("--eval-batch-size", default=8, type=int,
                        help="images per batched detector forward (1 = the "
                             "reference's one-image-at-a-time evaluation "
                             "loop). Batched chunks resize on the device "
                             "(<=2 LSB off PIL on <1%% of pixels); pass 1 "
                             "for the reference protocol's preprocessing on "
                             "runs used for published numbers, or check "
                             "that the two reports agree")
    parser.add_argument("--top-k-pre-nms", default=0, type=int,
                        help="score-sorted detection cap before NMS (0 = "
                             "uncapped, the literal reference protocol, the "
                             "default). Not report-equivalent when active")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="run the detector on the CPU")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None

    if args.owlvit_checkpoint:
        detector = OwlViTDetector.from_checkpoint(args.owlvit_checkpoint, device=device)
    elif args.detector_random:
        from ..nn import owlvit as owlvit_lib

        detector = OwlViTDetector(config=owlvit_lib.owlvit_base_patch32(), device=device,
                                  seed=0)
    else:
        parser.error("pass --owlvit-checkpoint (or --detector-random for a smoke run)")

    report = evaluate_run(
        args.run_base_path, detector,
        prompt_type=args.prompt_type, model=args.model,
        skip_first_prompts=args.skip_first_prompts,
        num_prompts=args.num_prompts, repeats=args.repeats,
        run_start_ind=args.run_start_ind,
        eval_batch=args.eval_batch_size,
        score_threshold=args.detection_score_threshold,
        nms_threshold=args.nms_threshold,
        use_class_aware_nms=not args.no_class_aware_nms,
        top_k_pre_nms=args.top_k_pre_nms or None,
        verbose=args.verbose,
    )
    print(report.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
