"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their wrappers and plain versions.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches its kernel, and
nowhere else, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

LAUNCHES: dict[str, int] = {
    "dgrad": 0,
    "attention_fwd": 0,
    "attention_bwd_dq": 0,
    "attention_bwd_dkdv": 0,
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkdv": 0,
    "flash_full_fwd": 0,
    "flash_full_bwd_dq": 0,
    "flash_full_bwd_dkdv": 0,
    "fused_fwd": 0,
    "fused_bwd_dq": 0,
    "fused_bwd_dkdv": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)
