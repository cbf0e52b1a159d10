"""Baseline JPEG files read on the host by ``csrc/jpeg_decode.cpp`` (g++-built at first use,
utils/native.py): the pixels libjpeg-turbo's default decode gives, which PIL's
``Image.open(f).convert("RGB")`` returns (islow IDCT, fancy upsampling, its fixed-point YCbCr
conversion). Baseline sequential Huffman, 8 bits, gray or YCbCr at 4:4:4, 4:2:2 or 4:2:0, restart
markers; any other kind (progressive, arithmetic, 12-bit, CMYK, RGB-coded) raises ValueError
naming it."""

from __future__ import annotations

import ctypes

import numpy as np

_ERR = 256


def _lib():
    from adversarialvlm_tpu_torch.utils.native import host_library

    lib = host_library("jpeg_decode.cpp")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_header.argtypes = [u8p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_decode_rgb.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_char_p, ctypes.c_int]
    lib.jpeg_header.restype = lib.jpeg_decode_rgb.restype = ctypes.c_int
    return lib


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def decode_jpeg(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file's bytes (a gray file repeated into the three channels,
    as ``convert("RGB")`` gives it)."""
    lib = _lib()
    buf = np.frombuffer(data, np.uint8)
    ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERR)
    info = (ctypes.c_int * 3)()
    if lib.jpeg_header(ptr, len(buf), info, err, _ERR):
        raise ValueError(err.value.decode())
    out = np.empty((info[0], info[1], 3), np.uint8)
    if lib.jpeg_decode_rgb(ptr, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err, _ERR):
        raise ValueError(err.value.decode())
    return out


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
