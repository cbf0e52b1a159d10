"""Best-iteration finder CLI, on the port: cli/find_best_iter.py's flags and printed lines.

    python -m adversarialvlm_tpu_torch.cli.find_best_iter --exps <exp> --runs_path runs \\
        --judge_model google/gemma-3-4b-it --checkpoint_root <root>

Judges every test_results_iter_<N>.csv of each experiment (eval/find_best_iter.py) and prints
``EXPERIMENT <exp>, BEST ITER <N>``. Runs on the card unless ``--device cpu``; ``--judge_model
tiny:`` builds a random tiny judge.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Find best attack iteration by judged ASR")
    parser.add_argument("--exps", type=str, nargs="+", required=True)
    parser.add_argument("--runs_path", type=str, default="./runs")
    parser.add_argument("--judge_model", type=str, default="google/gemma-3-4b-it")
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--int8_weights", action="store_true",
                        help="weight-only int8 judge (models/quant.py), quantized as it loads")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--judge_thoughts", action="store_true",
                        help="use the CoT thoughts+is_safe judge schema")
    parser.add_argument("--judge_npz", type=str, default=None,
                        help="pretrained tiny-judge LM weights; overrides --judge_model")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.cli.judge_common import build_checker
    from adversarialvlm_tpu_torch.eval.find_best_iter import find_best_iterations

    checker = build_checker(args.judge_model, args.checkpoint_root, args.batch_size,
                            use_thoughts=args.judge_thoughts, int8_weights=args.int8_weights or None,
                            judge_npz=args.judge_npz, device=args.device)
    best = find_best_iterations(
        checker, args.exps, args.runs_path,
        judge_model_name=args.judge_model, batch_size=args.batch_size,
        max_tokens=96 if args.judge_thoughts else 10,
    )
    for exp, it in best.items():
        print(f"EXPERIMENT {exp}, BEST ITER {it}")
    return best


if __name__ == "__main__":
    main()
