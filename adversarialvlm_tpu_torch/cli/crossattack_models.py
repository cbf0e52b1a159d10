"""Cross-model universal attack CLI with the flags of cli/crossattack_models.py, on the port: one
image optimized against every victim of ``--model_names`` at once, all resident on one card.

    python -m adversarialvlm_tpu_torch.cli.crossattack_models \\
        --model_names llava-hf/llava-1.5-7b-hf,google/gemma-3-4b-it --checkpoint_root <root> \\
        --img_orig gray.png --prompt list --target_text_random --batch_size 1

Model names are those of cli/attack_model.py (HF names under ``--checkpoint_root``,
``random:*``, ``tiny:*``), comma-separated. ``--model_weights`` weighs each victim's loss (default
1.0 each); ε defaults to 0.4 when ``--epsilon`` is not given, as the reference's cross attack
does. ``--DPO_flag --refuse_prob P`` trains, with probability P a step, each victim's own refusal
text (families without a refusal corpus, Gemma-3 among them, raise before any file is read).
Runs on the card unless ``--device cpu``; every save boundary decodes the 50 held-out questions
with every victim. ``--mesh_model``/``--mesh_data`` shard every victim over a (data × model) mesh
of spawned ranks, as cli/attack_model.py does.
"""

from __future__ import annotations

import argparse
from datetime import datetime

from adversarialvlm_tpu_torch.cli.attack_model import (
    add_attack_flags,
    attack_config_from_args,
    build_rank_victim,
    build_victim,
    mesh_from_args,
    victim_family,
)


def parse_model_names(s: str) -> list[str]:
    # tolerate a space after each comma: ' google/...' would miss its checkpoint directory
    return [p.strip() for p in s.split(",") if p.strip()]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train image attack model.")
    add_attack_flags(parser)
    parser.add_argument("--model_names", type=parse_model_names, default=["llava-hf/llava-1.5-7b-hf"])
    parser.add_argument("--model_weights", type=float, nargs="+", default=None,
                        help="Loss weights per model (default 1.0 each).")
    # None marks "--epsilon not given" in any spelling argparse accepts (--eps 0.5 included)
    parser.set_defaults(epsilon=None)
    args = parser.parse_args(argv)
    if args.epsilon is None:
        args.epsilon = 0.4  # the cross attack's default (crossattack_models.py:553)

    from adversarialvlm_tpu_torch.attack.engine import train
    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.setup import refuse_texts
    from adversarialvlm_tpu_torch.processors.prompts import spec_for_family
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    cfg = attack_config_from_args(
        args, exp_name=f"{args.exp_name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}",
        model_weights=args.model_weights,
    )
    if cfg.model_weights is not None and len(cfg.model_weights) != len(args.model_names):
        raise ValueError("The length of model_weights must match the number of model_names.")
    for name in args.model_names:  # every family, and its refusal corpus under DPO, before any build
        refuse_texts(cfg, spec_for_family(victim_family(name)))
    device = resolve_device(args.device)
    print("params:", args.__dict__)
    x0 = load_image_chw(args.img_orig)
    in_hw = (x0.shape[1], x0.shape[2])
    print("Original image size:", (in_hw[1], in_hw[0]))
    shape = mesh_from_args(args, device)
    if shape is not None:
        from adversarialvlm_tpu_torch.parallel.mesh import launch

        return launch(_cross_rank, *shape, device=device, args=(args, cfg, x0))
    victims = [build_victim(name, cfg, in_hw, device, args.checkpoint_root, int8_weights=args.int8_weights or None,
                            remat_policy=args.remat_policy)
               for name in args.model_names]
    return train(cfg, victims, x0, base_path=args.runs_path, cross=True, device=device, use_wandb=not args.no_wandb)


def _cross_rank(mesh, args, cfg, x0):
    """One rank of the mesh run of :func:`main`: every victim's shards on the rank's device."""
    from adversarialvlm_tpu_torch.attack.engine import train

    in_hw = (x0.shape[1], x0.shape[2])
    victims = [build_rank_victim(name, cfg, in_hw, mesh, args.checkpoint_root, args.int8_weights or None,
                                 args.remat_policy)
               for name in args.model_names]
    return train(cfg, victims, x0, base_path=args.runs_path, cross=True, device=mesh.device, mesh=mesh,
                 use_wandb=not args.no_wandb)


if __name__ == "__main__":
    main()
