"""Baseline evaluation CLI, on the port: cli/baseline_tests.py's flags and its model map. The
text-only SafeBench modes (``reference``, ``shii``, ``gcg``; the reference's benchmarkign.py),
MM-SafetyBench (MM_SafetyBench_baseline.py) and FigStep (FigStep_baseline.py) behind one entry.

    python -m adversarialvlm_tpu_torch.cli.baseline_tests --model llava --mode mm_safetybench \\
        --dataset_root datasets --tests_path tests_out --checkpoint_root <root>

Writes ``<tests_path>/<mode>/<model>/{i}.csv``, ``<tests_path>/MM-SafetyBench_<type>/<model>/`` or
``<tests_path>/FigStep_baseline/<model>/``, and prints ``generate_programs: configs=<n>
programs=<n>``: both the distinct (batch, total length, cache dtype) decode configurations the
victim ran (the port compiles nothing; a count that grows with the images says the bucketing
regressed). ``--model`` is a key of MODELS or a ``tiny:<family>`` / ``random:*`` name; the
victim is built at the canonical 448² plan; ``--int8_weights`` or ``ADVLM_INT8_WEIGHTS=1``
quantizes its linears as they load. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

MODELS = {
    "llama": "alpindale/Llama-3.2-11B-Vision-Instruct",
    "qwen": "Qwen/Qwen2-VL-2B-Instruct",
    "phi35": "microsoft/Phi-3.5-vision-instruct",
    "llava": "llava-hf/llava-1.5-7b-hf",
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True, help=f"one of {list(MODELS)} or tiny:<family>")
    parser.add_argument("--mode", required=True, choices=["reference", "shii", "gcg", "mm_safetybench", "figstep"])
    parser.add_argument("--sfb_path", type=str, default="./SafeBench_Text")
    parser.add_argument("--dataset_root", type=str, default="./datasets")
    parser.add_argument("--tests_path", type=str, default="./tests")
    parser.add_argument("--image_type", type=str, default="SD_TYPO", choices=["SD", "TYPO", "SD_TYPO"])
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--int8_weights", action="store_true",
                        help="weight-only int8 victim (models/quant.py), quantized as it loads")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--categories", type=str, default="1-23",
                        help="SafeBench category ids for the text-only modes, e.g. '1-23' or '1,5'")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.cli.attack_model import build_victim, victim_family
    from adversarialvlm_tpu_torch.cli.safebench_test import parse_categories
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    model_name = MODELS.get(args.model, args.model)
    # a typo'd category spec or a family the port does not run fails before the victim build
    categories = parse_categories(args.categories)
    victim_family(model_name)
    device = resolve_device(args.device)
    cfg = AttackConfig(exp_name="baseline", batch_size=args.batch_size)
    victim = build_victim(model_name, cfg, (448, 448), device, args.checkpoint_root,
                          int8_weights=args.int8_weights or None)
    print(f"victim {model_name}: images at 448x448, {victim.adv_inputs.num_image_tokens} image tokens a row")

    if args.mode in ("reference", "shii", "gcg"):
        from adversarialvlm_tpu_torch.eval.benchmarking import run_text_baseline

        out = os.path.join(args.tests_path, args.mode, args.model)
        run_text_baseline(victim, args.mode, args.sfb_path, out, batch_size=args.batch_size,
                          categories=categories)
    elif args.mode == "mm_safetybench":
        from adversarialvlm_tpu_torch.eval.mm_safetybench import run_mm_safetybench

        out = os.path.join(args.tests_path, f"MM-SafetyBench_{args.image_type}", args.model)
        run_mm_safetybench(victim, os.path.join(args.dataset_root, "MM_SafetyBench"), out,
                           image_type=args.image_type, batch_size=args.batch_size)
    else:
        from adversarialvlm_tpu_torch.eval.figstep import run_figstep

        out = os.path.join(args.tests_path, "FigStep_baseline", args.model)
        run_figstep(victim, os.path.join(args.dataset_root, "FigStep", "images"), out,
                    batch_size=args.batch_size)
    configs, programs = victim.bundle.generate_program_counts()
    print(f"generate_programs: configs={configs} programs={programs}")
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
