"""PNG files with the standard library (zlib + struct): the attack's x₀ is read and its
checkpoints written without an imaging package (the card's machine has none)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W) uint8 array, unfiltered, as RGB or grayscale."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        colour = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        line = np.frombuffer(data, np.uint8, stride, pos + 1).astype(np.int32)
        pos += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    pred = _paeth(a, prev[x], prev[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered scanlines (H, stride) uint8 -> (H, W, ch) samples at their bit depth."""
    h = rows.shape[0]
    if depth == 16:
        return rows.reshape(h, -1).view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per_byte = 8 // depth  # sub-byte depths: gray and palette only, so ch == 1
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, rows.shape[1] * per_byte)[:, :w, None]


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced PNG as (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives it:
    gray, RGB, gray+alpha and RGBA at 8 or 16 bits, gray at 1, 2 or 4 bits, and palette images
    (PLTE) at 1-8 bits. Alpha and tRNS are dropped; a 16-bit sample keeps its high byte, except
    16-bit gray, which PIL reads as 32-bit integers and clips to 255; a sub-byte gray sample is
    scaled to 0-255. Raises ValueError on anything else, naming it (utils/images.py::read_rgb
    reads JPEGs too)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} is not valid")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if colour == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[colour]
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, max(1, ch * depth // 8))
    px = _samples(rows, w, ch, depth)
    if colour == 3:
        # indices past the palette read as black
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        return lut[px[:, :, 0]]
    if depth == 16:
        px = np.minimum(px, 255) if colour == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if ch in (1, 2):
        px = np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])
