"""Host C++ libraries of the port (``csrc/*.cpp``): compiled with ``g++ -O3 -shared -fPIC`` at
first use into the git-ignored ``build/``, each named by the hash of its source, and loaded through
ctypes. A failed compile raises with the compiler's output."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def library_path(source: str):
    """``build/lib<stem>-<hash>.so`` of ``csrc/<source>``."""
    from adversarialvlm_tpu_torch.ops.kernels.build import BUILD, CSRC

    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:16]
    return BUILD / f"lib{source.rsplit('.', 1)[0]}-{digest}.so"


def host_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use in this checkout."""
    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC

    with _LOCK:
        if source not in _LIBS:
            path = library_path(source)
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(CSRC / source)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {source} (exit {proc.returncode}):\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, path)  # atomic against a concurrent build
            _LIBS[source] = ctypes.CDLL(str(path))
    return _LIBS[source]
