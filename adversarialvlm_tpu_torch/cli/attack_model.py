"""Single-model attack CLI with the flags of cli/attack_model.py, on the port.

    python -m adversarialvlm_tpu_torch.cli.attack_model --model_name random:llava-1.5-7b \\
        --img_orig gray.png

Model names: an HF name of processors.MODEL_MAP (``llava-hf/llava-1.5-7b-hf``,
``google/gemma-3-4b-it``, ``google/gemma-3-12b-it``, ``Qwen/Qwen2-VL-2B-Instruct``,
``Qwen/Qwen2-VL-7B-Instruct``, ``microsoft/Phi-3.5-vision-instruct``,
``alpindale/Llama-3.2-11B-Vision-Instruct``, ``alpindale/Llama-3.2-11B-Vision``,
``SinclairSchneider/Llama-Guard-3-11B-Vision``) loads its local checkpoint directory,
``<root>/<org>/<name>`` or ``<root>/<name>`` under ``--checkpoint_root`` or
``$ADVLM_CHECKPOINTS`` (bf16 on the card, f32 on the CPU; ``cli/fabricate_ckpt.py`` writes such a
directory from random weights; ``--int8_weights`` or ``ADVLM_INT8_WEIGHTS=1`` quantizes its
linears as they load, models/quant.py); ``random:llava-1.5-7b`` (full-size LLaVA-1.5-7B) and
``random:gemma-3-4b-it`` (full-size Gemma-3-4B-it, its SigLIP tower at 4096 patches) and
``random:qwen2vl-2b`` (full-size Qwen2-VL-2B, its grid from the source image's size), all with
random bf16 weights, and ``tiny:llava``, ``tiny:gemma3``, ``tiny:qwen2vl``, ``tiny:phi3v`` and
``tiny:mllama`` (tiny random models, f32) take the byte tokenizer. ``--resume_state
runs/<exp>/attack_state_latest.pt`` continues a run where its state was saved; ``--profile_dir``
traces the second chunk. Runs on the card
unless ``--device cpu``, at the default ``--batch_size 4`` or any other. As the JAX CLI does, every
save boundary decodes the 50 held-out questions on the saved image and writes
test_results_iter_<N>.csv.

``--remat_policy`` recomputes each decoder layer in the backward, keeping the policy's save set
(models/remat.py); ``--no_wandb`` keeps the metrics to metrics.jsonl (utils/logging.py).
``--mesh_model M`` and ``--mesh_data D`` run the attack on a (data × model) mesh
(parallel/mesh.py): one process a rank, spawned here, the decoder tensor-parallel over M ranks
and the batch split over D, on card ``rank % device_count`` (ranks may share a card) or, with
``--device cpu``, on the CPU. The run's files are rank 0's and those of the one-rank run.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from adversarialvlm_tpu_torch.models.configs import gemma3_4b_it, llava_1_5_7b
from adversarialvlm_tpu_torch.models.qwen2vl import qwen2vl_2b
from adversarialvlm_tpu_torch.utils.device import env_flag


def add_attack_flags(parser):
    """The reference's attack CLI surface (attack_model.py:483-519) plus the JAX package's
    extras, flag for flag."""
    parser.add_argument("--exp_name", type=str, default="oxford-to-msu")
    parser.add_argument("--img_orig", type=str, default="gray.png")
    parser.add_argument("--prompt", type=str, default="list")
    parser.add_argument("--target_text", type=str, default="sure, here it is!")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--num_iterations", type=int, default=1000)
    parser.add_argument("--save_steps", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--grad_accum_steps", type=int, default=1)
    parser.add_argument("--scheduler_step_size", type=int, default=100)
    parser.add_argument("--scheduler_gamma", type=float, default=1.0)
    parser.add_argument("--restart_num", type=int, default=0)
    parser.add_argument("--mask_type", type=str, default=None,
                        choices=["corner", "bottom_lines", "random_square"])
    parser.add_argument("--mask_size", type=int, default=None)
    parser.add_argument("--clamp_method", type=str, default="tanh", choices=["clamp", "tanh", "none"])
    parser.add_argument("--start_from_white", action="store_true")
    parser.add_argument("--target_text_random", action="store_true")
    parser.add_argument("--DPO_flag", action="store_true")
    parser.add_argument("--refuse_prob", type=float, default=0.0)
    parser.add_argument("--epsilon", type=float, default=0.5)
    parser.add_argument("--sigma", type=float, default=0.001)
    parser.add_argument("--use_gaussian_blur", action="store_true")
    parser.add_argument("--gblur_kernel_size", type=int, default=5)
    parser.add_argument("--gblur_sigma", type=float, default=7)
    parser.add_argument("--use_local_crop", action="store_true")
    parser.add_argument("--crop_scale_min", type=float, default=0.6)
    parser.add_argument("--crop_scale_max", type=float, default=1.0)
    parser.add_argument("--crop_ratio_min", type=float, default=0.75)
    parser.add_argument("--crop_ratio_max", type=float, default=1.33)
    parser.add_argument("--transform_prob", type=float, default=1.0)
    parser.add_argument("--checkpoint_root", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no_wandb", action="store_true",
                        help="log to metrics.jsonl only (default: wandb too, where it is installed and a key is set)")
    parser.add_argument("--runs_path", type=str, default="./runs")
    parser.add_argument("--resume_state", type=str, default=None)
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--mesh_model", type=int, default=None)
    parser.add_argument("--mesh_data", type=int, default=None)
    parser.add_argument("--int8_weights", action="store_true")
    parser.add_argument("--remat_policy", type=str, default=None,
                        choices=["dgrad_mid", "dgrad_lean", "gate", "gate_up", "dots", "dgrad", "none"],
                        help="recompute each decoder layer in the backward, keeping this save set (models/remat.py); "
                        "'none' or no flag: recompute nothing")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")


_CONFIG_FIELDS = (
    "exp_name img_orig prompt target_text lr num_iterations save_steps batch_size "
    "grad_accum_steps scheduler_step_size scheduler_gamma restart_num mask_type mask_size "
    "clamp_method epsilon sigma start_from_white target_text_random DPO_flag refuse_prob "
    "use_gaussian_blur gblur_kernel_size gblur_sigma use_local_crop crop_scale_min "
    "crop_scale_max crop_ratio_min crop_ratio_max transform_prob seed resume_state profile_dir"
).split()


def attack_config_from_args(args, **overrides):
    from adversarialvlm_tpu_torch.attack.config import AttackConfig

    fields = {k: getattr(args, k) for k in _CONFIG_FIELDS}
    fields.update(overrides)
    return AttackConfig(**fields)


# the random-weight victims with the byte tokenizer: name -> (family, its full-size config; None
# for the tiny model)
RANDOM_VICTIMS = {
    "random:llava-1.5-7b": ("llava", llava_1_5_7b),
    "random:gemma-3-4b-it": ("gemma3", gemma3_4b_it),
    "random:qwen2vl-2b": ("qwen2vl", qwen2vl_2b),
    "tiny:llava": ("llava", None),
    "tiny:gemma3": ("gemma3", None),
    "tiny:qwen2vl": ("qwen2vl", None),
    "tiny:phi3v": ("phi3v", None),
    "tiny:mllama": ("mllama", None),
}


def resolve_checkpoint(model_name: str, checkpoint_root: str | None) -> str:
    """The local directory of an HF model name: ``<root>/<org>/<name>`` or ``<root>/<name>``
    under ``--checkpoint_root``, else ``$ADVLM_CHECKPOINTS``, else ``./checkpoints``."""
    root = checkpoint_root or os.environ.get("ADVLM_CHECKPOINTS", "./checkpoints")
    for cand in (os.path.join(root, model_name), os.path.join(root, model_name.split("/")[-1])):
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(f"no local checkpoint for {model_name} under {root} "
                            "(set --checkpoint_root or $ADVLM_CHECKPOINTS)")


def victim_family(model_name: str) -> str:
    """The family of a model name (``random:*``, ``tiny:*`` or an HF name of
    processors.MODEL_MAP), before any file is read; other names raise."""
    from adversarialvlm_tpu_torch.processors import family_of

    if model_name in RANDOM_VICTIMS:
        return RANDOM_VICTIMS[model_name][0]
    if ":" in model_name:
        raise ValueError(f"model {model_name!r}: use an HF name or one of " + ", ".join(RANDOM_VICTIMS))
    return family_of(model_name)


def build_victim(model_name: str, cfg, in_hw, device, checkpoint_root: str | None = None,
                 int8_weights: bool | None = None, remat_policy: str | None = None):
    """``random:*`` and ``tiny:*`` names build random-weight victims with the byte tokenizer;
    an HF name (processors.MODEL_MAP) loads its checkpoint directory. ``int8_weights`` (None:
    ``ADVLM_INT8_WEIGHTS``) quantizes the linears (models/quant.py): the random victims after
    their draw, a checkpoint's as it loads. ``remat_policy`` (``--remat_policy``,
    models/remat.py) is forced on the victim's decoder."""
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim, build_victim_from_checkpoint

    family = victim_family(model_name)  # names a family the port does not run before any file is read
    int8 = env_flag("ADVLM_INT8_WEIGHTS") if int8_weights is None else int8_weights
    if model_name in RANDOM_VICTIMS:
        full_size = RANDOM_VICTIMS[model_name][1]
        if full_size is not None:
            return build_tiny_victim(model_name, cfg, in_hw, vlm_cfg=full_size(), seed=cfg.seed,
                                     dtype=torch.bfloat16, device=device, int8_weights=int8,
                                     remat_policy=remat_policy)
        return build_tiny_victim(model_name, cfg, in_hw, seed=cfg.seed, device=device, family=family,
                                 int8_weights=int8, remat_policy=remat_policy)
    dtype = torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return build_victim_from_checkpoint(model_name, resolve_checkpoint(model_name, checkpoint_root),
                                        cfg, in_hw, dtype=dtype, device=device, int8_weights=int8,
                                        remat_policy=remat_policy)


def mesh_from_args(args, device) -> tuple[int, int] | None:
    """(data, model) of ``--mesh_data``/``--mesh_model`` (cli/common.py::mesh_from_args), or None
    without them. The JAX rule derives the axis not given from the devices; the port's ranks may
    share a card, so it counts as many devices as the axes given ask for when the cards are
    fewer: ``--mesh_model 2`` on one card is two ranks on it."""
    if getattr(args, "mesh_model", None) is None and getattr(args, "mesh_data", None) is None:
        return None
    from adversarialvlm_tpu_torch.parallel.mesh import mesh_shape

    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    asked = (args.mesh_data or 1) * (args.mesh_model or 1)
    return mesh_shape(max(cards, asked), args.mesh_data, args.mesh_model)


def build_rank_victim(model_name: str, cfg, in_hw, mesh, checkpoint_root=None, int8_weights=None,
                      remat_policy=None):
    """This mesh rank's victim on its device: a checkpoint directory's decoder loads as the
    rank's shards; a random victim is drawn whole and cut (attack/engine.py::shard_victim), one
    rank at a time, so that ranks sharing a card never hold two whole models at once."""
    import torch.distributed as dist

    from adversarialvlm_tpu_torch.attack.engine import shard_victim

    if model_name not in RANDOM_VICTIMS or mesh.size == 1:
        return build_victim(model_name, cfg, in_hw, mesh.device, checkpoint_root, int8_weights, remat_policy)
    victim = None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            victim = build_victim(model_name, cfg, in_hw, mesh.device, checkpoint_root, int8_weights, remat_policy)
            shard_victim(victim, mesh)
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return victim


def _attack_rank(mesh, args, cfg, x0):
    """One rank of the mesh run of :func:`main`."""
    from adversarialvlm_tpu_torch.attack.engine import train

    victim = build_rank_victim(args.model_name, cfg, (x0.shape[1], x0.shape[2]), mesh, args.checkpoint_root,
                               args.int8_weights or None, args.remat_policy)
    return train(cfg, [victim], x0, base_path=args.runs_path, cross=False, device=mesh.device, mesh=mesh,
                 use_wandb=not args.no_wandb)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train image attack model.")
    add_attack_flags(parser)
    parser.add_argument("--model_name", type=str, default="random:llava-1.5-7b")
    args = parser.parse_args(argv)

    from adversarialvlm_tpu_torch.attack.engine import train
    from adversarialvlm_tpu_torch.attack.io import load_image_chw
    from adversarialvlm_tpu_torch.attack.step import check_dpo_mode
    from adversarialvlm_tpu_torch.utils.device import resolve_device

    cfg = attack_config_from_args(
        args, exp_name=f"{args.exp_name}_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    )
    check_dpo_mode(cfg, cross=False)  # before the victim build
    device = resolve_device(args.device)
    print("params:", args.__dict__)
    x0 = load_image_chw(args.img_orig)
    in_hw = (x0.shape[1], x0.shape[2])
    print("Original image size:", (in_hw[1], in_hw[0]))
    shape = mesh_from_args(args, device)
    if shape is not None:
        from adversarialvlm_tpu_torch.parallel.mesh import launch

        victim_family(args.model_name)  # a name the port does not run raises before any rank starts
        return launch(_attack_rank, *shape, device=device, args=(args, cfg, x0))
    victim = build_victim(args.model_name, cfg, in_hw, device, args.checkpoint_root,
                          int8_weights=args.int8_weights or None, remat_policy=args.remat_policy)
    return train(cfg, [victim], x0, base_path=args.runs_path, cross=False, device=device,
                 use_wandb=not args.no_wandb)


if __name__ == "__main__":
    main()
