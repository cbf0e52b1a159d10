"""Post-hoc re-tester CLI, on the port: cli/test_post.py's flags (src/test_post.py:232-293's
surface). The test harness runs again over a run's saved images with a question file of one's
choice.

    python -m adversarialvlm_tpu_torch.cli.test_post --exp <exp> --model_name Qwen/Qwen2-VL-2B-Instruct \\
        --checkpoint_root <root> [--iterations 1 5] [--questions_file q.csv] [--question_set_name s]

Writes ``<runs_path>/<exp>/post_test_results/<set>/test_results_iter_<N>.csv`` and summary.csv,
and prints ``generate_programs: configs=<n> programs=<n>``. ``--iterations`` are image indices
(optimized_image_iter_<N>.png); the default is every saved image. ``--model_name`` is an HF name
of processors.MODEL_MAP or a ``random:*`` / ``tiny:*`` name (cli/attack_model.py). Runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os


def read_questions(path: str) -> list[str]:
    """One question a line (no CSV parsing: a question may hold a comma), blank lines dropped and
    a header row of ``question``, ``text`` or ``0`` tolerated."""
    with open(path, encoding="utf-8") as f:
        questions = [ln.strip() for ln in f if ln.strip()]
    if questions and questions[0].lower() in ("question", "text", "0"):
        questions = questions[1:]
    if not questions:
        raise SystemExit(f"no questions in {path}")
    return questions


def main(argv=None):
    parser = argparse.ArgumentParser(description="Re-test saved adversarial images")
    parser.add_argument("--exp", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="llava-hf/llava-1.5-7b-hf")
    parser.add_argument("--questions_file", type=str, default=None,
                        help="one question per line (default: the 50 held-out questions)")
    parser.add_argument("--question_set_name", type=str, default="custom")
    parser.add_argument("--iterations", type=int, nargs="*", default=None,
                        help="image indices (optimized_image_iter_<N>.png); default: every saved image")
    parser.add_argument("--runs_path", type=str, default="./runs")
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--int8_weights", action="store_true",
                        help="weight-only int8 victim (models/quant.py), quantized as it loads")
    parser.add_argument("--max_new_tokens", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.cli.attack_model import build_victim, victim_family
    from adversarialvlm_tpu_torch.data import corpora
    from adversarialvlm_tpu_torch.eval.experiment_tracker import ExperimentTracker
    from adversarialvlm_tpu_torch.eval.test_post import test_adversarial_images
    from adversarialvlm_tpu_torch.utils.device import resolve_device
    from adversarialvlm_tpu_torch.utils.images import read_rgb

    victim_family(args.model_name)  # a family the port does not run fails before any file is read
    questions = read_questions(args.questions_file) if args.questions_file else corpora.not_safe_questions_test
    iterations = args.iterations or ExperimentTracker(args.runs_path).get_checkpoint_iterations(args.exp)
    if not iterations:
        raise SystemExit(f"no checkpoint iterations found for experiment {args.exp!r} under "
                         f"{args.runs_path!r} (and none passed via --iterations)")
    # the first requested image that exists sets the victim's plan; the re-tester skips the missing
    first = next((p for it in iterations
                  if os.path.exists(p := os.path.join(args.runs_path, args.exp,
                                                      f"optimized_image_iter_{it}.png"))), None)
    if first is None:
        raise SystemExit(f"none of the requested iterations {iterations} has an "
                         f"optimized_image_iter_<N>.png under {os.path.join(args.runs_path, args.exp)}")
    in_hw = tuple(read_rgb(first).shape[:2])
    device = resolve_device(args.device)
    victim = build_victim(args.model_name, AttackConfig(exp_name=args.exp), in_hw, device, args.checkpoint_root,
                          int8_weights=args.int8_weights or None)
    out = test_adversarial_images([victim], args.exp, iterations, questions,
                                  question_set_name=args.question_set_name, runs_path=args.runs_path,
                                  max_new_tokens=args.max_new_tokens)
    configs, programs = victim.bundle.generate_program_counts()
    print(f"generate_programs: configs={configs} programs={programs}")
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
