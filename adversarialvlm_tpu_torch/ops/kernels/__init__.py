"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), their wrappers and plain versions.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches its kernel, and
nowhere else, so a run can show which kernels its main path went through. The attention wrappers,
whose entries dispatch on the head dim, also count each launch under that head dim in
:data:`LAUNCHES_BY_HEAD_DIM`, so a run that mixes head dims shows each instantiation's share.
"""

from __future__ import annotations

from collections import Counter

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
#: ``"<name>_d<head dim>"`` -> launches, for the attention wrappers
LAUNCHES_BY_HEAD_DIM: Counter[str] = Counter()


def count_launch(name: str, head_dim: int) -> None:
    """One launch of ``name``'s kernel at ``head_dim``."""
    LAUNCHES[name] += 1
    LAUNCHES_BY_HEAD_DIM[f"{name}_d{head_dim}"] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_HEAD_DIM.clear()


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def launch_counts_by_head_dim() -> dict[str, int]:
    return dict(LAUNCHES_BY_HEAD_DIM)
