"""Run metrics: runs/<exp>/metrics.jsonl always, and wandb where it is installed and a key is set.
Counterpart of adversarialvlm_tpu/utils/logging.py: project ``image_attack_optimization``, the
run's config at ``wandb.init``, the per-iteration scalars, the checkpoint image as a
``wandb.Image`` and the generated-text table as a ``wandb.Table``, and ``finish``."""

from __future__ import annotations

import json
import math
import os
from typing import Any

import numpy as np


def _wandb_key_available() -> bool:
    """Whether wandb can authenticate: ``WANDB_API_KEY``, or a ``wandb login`` (netrc) credential;
    False when the module is absent."""
    if os.environ.get("WANDB_API_KEY"):
        return True
    try:
        import wandb

        return bool(getattr(getattr(wandb, "api", None), "api_key", None))
    except Exception:
        return False


class RunLogger:
    def __init__(self, exp_name: str, exp_path: str, config: dict, use_wandb: bool = True):
        self.exp_path = exp_path
        self._jsonl = open(os.path.join(exp_path, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb and _wandb_key_available():
            try:
                import wandb

                self._wandb = wandb.init(project="image_attack_optimization", name=exp_name, config=config,
                                         tags=["image-attack", "training", "transformers"])
            except Exception:
                self._wandb = None
        self._jsonl.write(json.dumps({"_config": _jsonable(config)}) + "\n")

    def log(self, data: dict[str, Any]):
        self._jsonl.write(json.dumps(_jsonable(data)) + "\n")
        if self._wandb is not None:
            self._wandb.log(data)

    def log_image(self, key: str, png_path: str, iteration: int):
        """The checkpoint image (attack_model.py:453-457): its file name in metrics.jsonl, the
        image itself in wandb."""
        self._jsonl.write(json.dumps({"iteration": iteration, key: os.path.basename(png_path)}) + "\n")
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: wandb.Image(png_path)}, commit=False)

    def log_table(self, key: str, columns: list[str], rows: list[list], iteration: int):
        """A generated-text table (the reference's wandb table, attack_model.py:48-64)."""
        self._jsonl.write(json.dumps({"iteration": iteration, key: {"columns": columns, "rows": _jsonable(rows)}})
                          + "\n")
        if self._wandb is not None:
            import wandb

            self._wandb.log({key: wandb.Table(columns=columns, data=rows)}, commit=False)

    def flush(self):
        self._jsonl.flush()

    def finish(self):
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


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
