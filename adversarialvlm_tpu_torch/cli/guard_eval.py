"""Guard/ASR evaluation CLI, on the port: cli/guard_eval.py's surface (the reference's
guard_eval_gemma.py: a positional SafeBench results path, the judge configurable).

    python -m adversarialvlm_tpu_torch.cli.guard_eval <tests_path>/<exp>_<N>/<suf> \\
        --judge_model google/gemma-3-4b-it --checkpoint_root <root>

Writes results_gemma.csv, mean_result_gemma.txt and guard_gemma.csv there (eval/guard_eval.py)
and prints ``mean ASR: <x>``. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Adversarial Model Testing")
    parser.add_argument("path", type=str, help="Experiment SB results dir")
    parser.add_argument("--judge_model", type=str, default="google/gemma-3-4b-it")
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--int8_weights", action="store_true",
                        help="weight-only int8 judge (models/quant.py), quantized as it loads")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--judge_thoughts", action="store_true",
                        help="use the CoT thoughts+is_safe judge schema")
    parser.add_argument("--categories", type=str, default="1-23",
                        help="SafeBench category ids, e.g. '1-23' or '1,5'")
    parser.add_argument("--judge_npz", type=str, default=None,
                        help="pretrained tiny-judge LM weights; overrides --judge_model")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.cli.judge_common import build_checker
    from adversarialvlm_tpu_torch.cli.safebench_test import parse_categories
    from adversarialvlm_tpu_torch.eval.guard_eval import run_guard_eval

    categories = parse_categories(args.categories)
    checker = build_checker(args.judge_model, args.checkpoint_root, args.batch_size,
                            use_thoughts=args.judge_thoughts, int8_weights=args.int8_weights or None,
                            judge_npz=args.judge_npz, device=args.device)
    mean = run_guard_eval(checker, args.path, max_tokens=96 if args.judge_thoughts else 10,
                          categories=categories)
    print("mean ASR:", mean)
    return mean


if __name__ == "__main__":
    main()
