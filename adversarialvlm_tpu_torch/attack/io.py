"""Run-directory artifacts, the reference's layout: runs/<exp>/optimized_image_iter_<N>.png|.bin,
mask.pt|png, config.json, and the attack state of true resume, attack_state_iter_<N>.pt and
attack_state_latest.pt. Counterpart of adversarialvlm_tpu/attack/io.py."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from adversarialvlm_tpu_torch.ops.image import from_pil_array, to_pil_array
from adversarialvlm_tpu_torch.utils.images import read_rgb
from adversarialvlm_tpu_torch.utils.png import write_png


def create_directory(exp_name: str, base_path: str = "./runs") -> str:
    exp_path = os.path.join(base_path, exp_name)
    os.makedirs(exp_path, exist_ok=True)
    return exp_path


def save_checkpoint(tensor_chw: np.ndarray, path: str, iteration) -> str:
    """The current image as clamped, truncated uint8 PNG and as raw float32 .bin."""
    png_path = os.path.join(path, f"optimized_image_iter_{iteration}.png")
    write_png(png_path, to_pil_array(tensor_chw))
    np.asarray(tensor_chw, np.float32).tofile(
        os.path.join(path, f"optimized_image_iter_{iteration}.bin")
    )
    return png_path


def save_mask(mask_chw: np.ndarray, exp_path: str) -> None:
    """mask.pt (a torch tensor, as the reference saves it) and mask.png."""
    mask = np.asarray(mask_chw, np.float32)
    torch.save(torch.from_numpy(mask), os.path.join(exp_path, "mask.pt"))
    write_png(os.path.join(exp_path, "mask.png"), (mask.transpose(1, 2, 0) * 255).astype(np.uint8))


def save_config(args_dict: dict, exp_path: str) -> None:
    with open(os.path.join(exp_path, "config.json"), "w") as f:
        json.dump(args_dict, f, indent=4, default=str)


STATE_MISMATCH = ("attack state structure mismatch — was the config (optimizer/schedule) changed "
                  "since the checkpoint was written?")


def save_attack_state(state: dict, generators: dict, exp_path: str, iteration) -> str:
    """The whole attack state for true resume (an upgrade over the reference, which restarts from
    the saved PNG with fresh AdamW moments): p, the AdamW and StepLR state_dicts, σ_resave, the
    accumulated loss, the gradient buffer when there is one, in cross mode with the blur the last
    step's σ (a float, or None before the first step), the counters and the states of the run's
    generators (``generators``: name -> torch.Generator), so a resumed run draws the same
    questions, crops, coins, squares and noise. Written as attack_state_iter_<iteration>.pt and
    attack_state_latest.pt, each through a .tmp file and os.replace. A torch file, where the JAX
    package writes npz: the two formats do not read each other."""
    payload = {
        "p": state["p"].detach().cpu(),
        "optimizer": state["optimizer"].state_dict(),
        "scheduler": state["scheduler"].state_dict(),
        "resave_std": state["resave_std"].detach().cpu(),
        "accum_loss": state["accum_loss"].detach().cpu(),
        "iteration": int(state["iteration"]),
        "global_iteration": int(state["global_iteration"]),
        "generators": {name: g.get_state() for name, g in generators.items()},
    }
    if "grad_buf" in state:
        payload["grad_buf"] = state["grad_buf"].detach().cpu()
    if "last_sigma" in state:
        payload["last_sigma"] = state["last_sigma"]
    path = os.path.join(exp_path, f"attack_state_iter_{iteration}.pt")
    for target in (path, os.path.join(exp_path, "attack_state_latest.pt")):
        tmp = target + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)
    return path


def load_attack_state(path: str, state: dict, generators: dict) -> dict:
    """Restore a state written by :func:`save_attack_state` into ``state`` (from init_state with
    the same config; its tensors keep their devices) and ``generators``, in place. The gradient
    buffer migrates as in the JAX package: a saved buffer the config does not accumulate into is
    dropped (and a nonzero one reported), a missing one starts at zeros. A state of another
    structure raises."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    keys = {"p", "optimizer", "scheduler", "resave_std", "accum_loss", "iteration",
            "global_iteration", "generators"}
    if not (keys <= set(saved) <= keys | {"grad_buf", "last_sigma"}) or saved["p"].shape != state["p"].shape \
            or set(saved["generators"]) != set(generators):
        raise ValueError(STATE_MISMATCH)
    try:
        state["optimizer"].load_state_dict(saved["optimizer"])
        state["scheduler"].load_state_dict(saved["scheduler"])
    except (KeyError, ValueError) as e:
        raise ValueError(STATE_MISMATCH) from e
    with torch.no_grad():
        state["p"].copy_(saved["p"])
    for key in ("resave_std", "accum_loss"):
        state[key] = saved[key].to(state[key].device)
    state["iteration"], state["global_iteration"] = saved["iteration"], saved["global_iteration"]
    if "last_sigma" in saved:  # saved with the σ stream, which the generators' check matched
        state["last_sigma"] = saved["last_sigma"]
    for name, g in generators.items():
        g.set_state(saved["generators"][name])
    if "grad_buf" in state:
        # saved without a buffer: accumulation starts at zeros
        buf = saved.get("grad_buf")
        state["grad_buf"] = (torch.zeros_like(state["p"]) if buf is None
                             else buf.to(state["p"].device)).detach()
    elif "grad_buf" in saved and float(saved["grad_buf"].abs().max()) > 0:
        # saved mid-accumulation window by a config that accumulated: this one does not, so that
        # partial gradient cannot be applied
        print("[attack] WARNING: resumed checkpoint carried a nonzero accumulated-gradient buffer "
              "(saved mid-accumulation window); the new config does not accumulate, so that "
              "partial gradient is discarded")
    return state


def load_image_chw(path: str, images_dir: str = "./images") -> np.ndarray:
    """CHW float32 [0, 1] from the PNG or JPEG image at ``path`` or ``images_dir/path``
    (attack_model.py:163-168), the pixels PIL's ``convert("RGB")`` gives (utils/images.py)."""
    for cand in (path, os.path.join(images_dir, path)):
        if os.path.exists(cand):
            return from_pil_array(read_rgb(cand))
    raise FileNotFoundError(f"Cannot find {path}")
