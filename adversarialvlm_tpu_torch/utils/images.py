"""Host image files for the attack and the benchmarks, without an imaging package (the card's
machine has none): ``read_rgb`` dispatches on the file's magic bytes to the PNG reader
(utils/png.py) or the JPEG decoder (utils/jpeg.py), and ``resize_bilinear`` is PIL's
``Image.resize(size, BILINEAR)`` on uint8 RGB, bit for bit."""

from __future__ import annotations

import math

import numpy as np

from adversarialvlm_tpu_torch.utils.jpeg import decode_jpeg, is_jpeg
from adversarialvlm_tpu_torch.utils.png import read_png

_MAGIC = (  # formats named in the error for a file neither reader takes
    (b"GIF8", "GIF"), (b"BM", "BMP"), (b"RIFF", "WebP/RIFF"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
)
PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c, 8 bits a sample


def read_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG or JPEG file, the pixels PIL's ``convert("RGB")`` gives;
    any other format raises ValueError naming it."""
    with open(path, "rb") as f:
        head = f.read(8)
        data = head + f.read() if is_jpeg(head) else None
    if head.startswith(b"\x89PNG"):
        return read_png(path)
    if data is not None:
        try:
            return decode_jpeg(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    kind = next((name for magic, name in _MAGIC if head.startswith(magic)), "an unknown format")
    raise ValueError(f"{path}: {kind} image; only PNG and baseline JPEG files can be read")


def _coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs for the bilinear (triangle) filter, then normalize_coeffs_8bpc:
    per output pixel its first input pixel and (out, ksize) int32 weights in 2^22 units. The
    arithmetic is Pillow's, in doubles, in its order."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ws, ww = [], 0.0
        for x in range(xmax):
            w = abs((x + xmin - center + 0.5) * ss)
            w = 1.0 - w if w < 1.0 else 0.0
            ws.append(w)
            ww += w
        for x, w in enumerate(ws):
            k = w / ww if ww != 0.0 else w
            kk[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else int(0.5 + k * (1 << PRECISION_BITS))
        xmins[xx] = xmin
    return xmins, kk


def _pass(arr: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One of Pillow's 8-bit passes along ``axis`` (1 horizontal, 0 vertical): a sum from
    1 << 21 of samples times weights, >> 22, clipped to 0-255, in int32 as Pillow sums (the
    weights of a pixel add to about 2^22, so 255 of them stay below 2^31)."""
    in_size = arr.shape[axis]
    xmins, kk = _coeffs(in_size, out_size)
    kk = kk.astype(np.int32)
    shape = [1] * arr.ndim
    shape[axis] = out_size
    acc = np.full(arr.shape[:axis] + (out_size,) + arr.shape[axis + 1:], 1 << (PRECISION_BITS - 1), np.int32)
    for j in range(kk.shape[1]):
        idx = np.minimum(xmins + j, in_size - 1)  # a zero weight where the window ends
        acc += np.take(arr, idx, axis=axis).astype(np.int32) * kk[:, j].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(arr: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(arr).resize((w, h), Image.Resampling.BILINEAR)`` of an (H, W, 3) uint8
    array, bit for bit: Pillow's two passes, horizontal then vertical through a uint8
    intermediate (a pass whose size stays is skipped, as Pillow skips it), with its 8-bit
    fixed-point weights (PRECISION_BITS 22, support scaled by the downscale factor)."""
    h, w = hw
    out = np.asarray(arr, np.uint8)
    if out.shape[1] != w:
        out = _pass(out, w, 1)
    if out.shape[0] != h:
        out = _pass(out, h, 0)
    return out
