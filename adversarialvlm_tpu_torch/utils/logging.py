"""Run metrics as runs/<exp>/metrics.jsonl. Counterpart of adversarialvlm_tpu/utils/logging.py
without the wandb sink."""

from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np


class RunLogger:
    def __init__(self, exp_path: str, config: dict):
        self.exp_path = exp_path
        self._jsonl = open(os.path.join(exp_path, "metrics.jsonl"), "a")
        self._jsonl.write(json.dumps({"_config": _jsonable(config)}) + "\n")

    def log(self, data: dict[str, Any]):
        self._jsonl.write(json.dumps(_jsonable(data)) + "\n")

    def log_image(self, key: str, png_path: str, iteration: int):
        self.log({"iteration": iteration, key: os.path.basename(png_path)})

    def log_table(self, key: str, columns: list[str], rows: list[list], iteration: int):
        """A generated-text table (the reference's wandb table, attack_model.py:48-64)."""
        self.log({"iteration": iteration, key: {"columns": columns, "rows": rows}})

    def flush(self):
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):  # numpy values and tensors
        return _jsonable(np.asarray(x).tolist())
    if isinstance(x, float) and not math.isfinite(x):
        return None  # NaN/Inf have no JSON literal
    if isinstance(x, (int, float, str, bool)) or x is None:
        return x
    return str(x)
