"""SafeBench evaluation CLI, on the port: cli/safebench_test.py's flags (the reference's
SafeBench_universal.py --exp/--iter/--model_suf, with the dataset and roots as flags).

    python -m adversarialvlm_tpu_torch.cli.safebench_test --exp <exp> --iter <N> \\
        --model_suf llava-hf --sfb_path SafeBench_Text --runs_path runs --tests_path tests_out \\
        --checkpoint_root <root>

Reads runs/<exp>/optimized_image_iter_<N+1>.png and writes <tests_path>/<exp>_<N>/<suf>/{i}.csv
(eval/safebench.py). ``--model_suf`` is a key of DICT_SUF_MODELNAME or a ``tiny:<family>`` name.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def parse_categories(spec: str) -> list[int]:
    """'1-23' | '1,5,7' | '1-3,9' -> sorted category ids. Raises on a spec that parses to nothing
    (e.g. a reversed range): an empty list would silently mean all 23 categories."""
    out: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            if int(lo) > int(hi):
                raise ValueError(f"reversed category range {part!r} in {spec!r}")
            out.update(range(int(lo), int(hi) + 1))
        elif part:
            out.add(int(part))
    if not out:
        raise ValueError(f"no categories parsed from {spec!r}")
    return sorted(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Adversarial Model Testing")
    parser.add_argument("--exp", type=str, required=True, help="Experiment name")
    parser.add_argument("--iter", type=int, required=True, help="Iteration number")
    parser.add_argument("--model_suf", type=str, required=True)
    parser.add_argument("--sfb_path", type=str, default="./SafeBench_Text")
    parser.add_argument("--runs_path", type=str, default="./runs")
    parser.add_argument("--tests_path", type=str, default="./tests")
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--int8_weights", action="store_true",
                        help="weight-only int8 victim (models/quant.py), quantized as it loads")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument(
        "--categories", type=str, default="1-23",
        help="SafeBench category ids, e.g. '1-23' or '1,5,7' "
        "(the reference hardcodes the 1..23 loop, SafeBench_universal.py:45)",
    )
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.cli.attack_model import build_victim
    from adversarialvlm_tpu_torch.eval.safebench import (
        DICT_SUF_MODELNAME,
        optimized_image_path,
        run_safebench,
    )
    from adversarialvlm_tpu_torch.utils.device import resolve_device
    from adversarialvlm_tpu_torch.utils.png import read_png

    assert args.model_suf in DICT_SUF_MODELNAME or args.model_suf.startswith("tiny:"), (
        "Model suffix not found. Shall be one of: " + ", ".join(DICT_SUF_MODELNAME)
    )
    model_name = DICT_SUF_MODELNAME.get(args.model_suf, args.model_suf)
    # fail a typo'd category spec before the victim build
    categories = parse_categories(args.categories)
    device = resolve_device(args.device)
    in_hw = read_png(optimized_image_path(args.runs_path, args.exp, args.iter)).shape[:2]

    cfg = AttackConfig(exp_name=args.exp, batch_size=args.batch_size)
    victim = build_victim(model_name, cfg, in_hw, device, args.checkpoint_root,
                          int8_weights=args.int8_weights or None)
    out = run_safebench(
        victim, args.exp, args.iter, args.sfb_path,
        runs_root=args.runs_path, tests_root=args.tests_path,
        model_suf=args.model_suf, batch_size=args.batch_size,
        categories=categories,
    )
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
