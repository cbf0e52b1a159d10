"""Run-directory artifacts, the reference's layout: runs/<exp>/optimized_image_iter_<N>.png|.bin,
mask.pt|png, config.json. Counterpart of adversarialvlm_tpu/attack/io.py."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from adversarialvlm_tpu_torch.ops.image import from_pil_array, to_pil_array
from adversarialvlm_tpu_torch.utils.png import read_png, write_png


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


def _read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8: PIL's ``convert("RGB")`` where PIL imports (any format it reads), else
    utils/png.py's reader, which gives the same pixels for PNGs and names any other format."""
    try:
        from PIL import Image
    except ImportError:
        return read_png(path)
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def load_image_chw(path: str, images_dir: str = "./images") -> np.ndarray:
    """CHW float32 [0, 1] from the image at ``path`` or ``images_dir/path`` (attack_model.py:
    163-168)."""
    for cand in (path, os.path.join(images_dir, path)):
        if os.path.exists(cand):
            return from_pil_array(_read_rgb(cand))
    raise FileNotFoundError(f"Cannot find {path}")
