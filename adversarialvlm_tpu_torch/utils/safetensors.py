"""The safetensors format, read and written by the port itself: an 8-byte little-endian header
length, a JSON header ({name: {"dtype", "shape", "data_offsets"}, "__metadata__": {...}}) and the
tensors' raw little-endian bytes. The machine with the card has no ``safetensors`` package.

Reading memory-maps each shard and hands out one tensor at a time as a view of the map, so a
caller that moves each tensor to its device before taking the next never holds a second copy of
the model on the host.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys

import numpy as np
import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "F64": torch.float64,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}
INDEX = "model.safetensors.index.json"

if sys.byteorder != "little":  # the format's bytes are little-endian and are mapped as they are
    raise ImportError("utils/safetensors.py reads and writes on little-endian hosts only")


def iter_file(path: str):
    """(name, tensor) for each tensor of one file, in the header's order; each tensor is a view of
    the file's memory map (copy-on-write, so the file is never written)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    start = 8 + n
    header.pop("__metadata__", None)
    size = os.path.getsize(path) - start
    mm = np.memmap(path, dtype=np.uint8, mode="c", offset=start, shape=(size,)) if size else None
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, which the port "
                             f"does not read (known: {', '.join(DTYPES)})")
        dtype, (a, b) = DTYPES[info["dtype"]], info["data_offsets"]
        shape = tuple(info["shape"])
        nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        if b - a != nbytes or b > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes {a}-{b}, not {nbytes} bytes of "
                             f"{info['dtype']} {list(shape)} within the {size}-byte data")
        raw = torch.from_numpy(mm[a:b]) if nbytes else torch.empty((0,), dtype=torch.uint8)
        yield name, raw.view(dtype).reshape(shape)


def read_dir(path: str):
    """(name, tensor) for every tensor of a checkpoint directory: each ``*.safetensors`` shard in
    name order, or else each ``pytorch_model*.bin`` through ``torch.load(weights_only=True)``
    (the JAX package's models/loading.py::load_state_dict_dir). Raises FileNotFoundError when the
    directory holds neither."""
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if shards:
        for f in shards:
            yield from iter_file(f)
        return
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no checkpoint shards found in {path}")
    for f in bins:
        yield from torch.load(f, map_location="cpu", weights_only=True).items()


def _header(tensors: list[tuple[str, torch.Tensor]], metadata: dict | None) -> bytes:
    header, offset = {}, 0
    for name, t in tensors:
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    return struct.pack("<Q", len(raw)) + raw


def _ordered(tensors) -> list[tuple[str, torch.Tensor]]:
    # widest elements first, as the reference writer orders them, so every tensor stays aligned
    items = list(tensors.items()) if isinstance(tensors, dict) else list(tensors)
    return sorted(items, key=lambda kv: (-kv[1].element_size(), kv[0]))


def write_file(tensors, path: str, metadata: dict | None = None) -> None:
    """Write ``tensors`` (a dict or (name, tensor) pairs, on any device) to one file, copying each
    to the host in turn."""
    items = _ordered(tensors)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_header(items, metadata))
        for _, t in items:
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)


def write_sharded(tensors, out_dir: str, max_shard_bytes: int = 5_000_000_000) -> list[str]:
    """Write ``tensors`` as ``model-0000i-of-0000n.safetensors`` shards of at most
    ``max_shard_bytes`` each (a larger tensor gets a shard of its own) with
    ``model.safetensors.index.json``, or as one ``model.safetensors`` when they fit one shard.
    Returns the shard paths."""
    items = _ordered(tensors)
    shards, size = [[]], 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append((name, t))
        size += nbytes
    os.makedirs(out_dir, exist_ok=True)
    if len(shards) == 1:
        names = ["model.safetensors"]
    else:
        names = [f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors" for i in range(len(shards))]
    weight_map, total = {}, 0
    for fname, shard in zip(names, shards):
        write_file(shard, os.path.join(out_dir, fname), {"format": "pt"})
        for name, t in shard:
            weight_map[name] = fname
            total += t.numel() * t.element_size()
    if len(shards) > 1:
        with open(os.path.join(out_dir, INDEX), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": dict(sorted(weight_map.items()))},
                      f, indent=2)
    return [os.path.join(out_dir, n) for n in names]
