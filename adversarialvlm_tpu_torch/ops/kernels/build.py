"""Build the CUDA sources with nvcc at first use and bind them through ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so`` (the hash is of the source and of the
headers of ``csrc/`` it includes, so an edited source or header never loads a stale library, and a
header edit rebuilds only the libraries that include it) with a plain C interface. All missing libraries are compiled at once, one nvcc process per source. Nothing
here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("dgrad", "flash_full", "causal_fwd", "causal_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_BOUND: dict[str, set] = {}  # per library, the C functions whose argtypes are set
_LOCK = threading.Lock()


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output, including ptxas's register/spill/shared-memory lines


def local_headers(name: str) -> list[str]:
    """The headers of ``csrc/`` that ``csrc/<name>.cu`` includes (``#include "..."``; no header there
    includes another)."""
    text = (CSRC / f"{name}.cu").read_text()
    return [h for h in re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M) if (CSRC / h).is_file()]


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in local_headers(name):
        h.update(header.encode())
        h.update((CSRC / header).read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return cand


def build_all(names=SOURCES) -> dict[str, BuildResult]:
    """Compile every library of ``names`` that is not built yet, in parallel. Raises with
    nvcc's output if any compile fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            results[name] = BuildResult(name, path, 0.0, "")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path, time.perf_counter())
    failed = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        results[name] = BuildResult(name, path, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed, with ``argtypes`` set from
    ``signatures`` ({C function: argtypes}); every function returns an int error code. Several
    wrapper modules may bind their own entry points of one library. A library already loaded with
    these entries bound returns at once: the wrappers call this at every launch."""
    lib = _LIBS.get(name)
    if lib is not None and _BOUND[name].issuperset(signatures):
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name].path))
            _BOUND[name] = set()
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _BOUND[name].update(signatures)
        _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current stream on ``t``'s device, as a Python int for ctypes. Read through
    the raw accessor PyTorch's own kernel launchers use, which builds no ``torch.cuda.Stream``
    object: every launch pays this on the host."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device_of(t: torch.Tensor):
    """Make ``t``'s card the current device: autograd runs a backward on its own worker thread,
    where a launch must not rely on whatever device that thread had current."""
    return torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext()


def check_cuda_operands(what: str, dtype: torch.dtype, *tensors: torch.Tensor, device=None) -> None:
    """Raise unless every tensor is a contiguous ``dtype`` CUDA tensor on ``device`` (default:
    the first tensor's) whose data start on a 16-byte boundary (the kernels copy 16 bytes at a
    time)."""
    dev = device if device is not None else tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: all operands must be CUDA tensors on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must be contiguous and 16-byte aligned")
