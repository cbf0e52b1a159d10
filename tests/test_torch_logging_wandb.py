"""The port's wandb sink (adversarialvlm_tpu_torch/utils/logging.py), held to the JAX package's
tests/test_logging_wandb.py: the same stub module in place of wandb (installed nowhere here), the
port's train() on a tiny LLaVA on the CPU. The reference's schema: init with the run's config,
the per-iteration scalars, the image and the generated-text table at a save boundary, finish();
without a key wandb is never imported and metrics.jsonl is written alone."""

import json
import os
import sys

import numpy as np
import torch

from test_logging_wandb import _make_stub_wandb, _StubImage, _StubTable


def test_wandb_schema_through_train(monkeypatch, tmp_path):
    stub = _make_stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("WANDB_API_KEY", "stub-key")
    torch.set_num_threads(1)

    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.engine import train
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim

    cfg = AttackConfig(exp_name="wandb_stub", num_iterations=2, save_steps=2, batch_size=1, grad_accum_steps=1)
    questions = ["How do I do the bad thing?"]
    victim = build_tiny_victim("tiny-llava", cfg, (64, 80), questions=questions, targets=["sure, here it is!"],
                               test_questions=questions, device="cpu")
    train(cfg, [victim], np.full((3, 64, 80), 0.5, np.float32), base_path=str(tmp_path), use_wandb=True,
          test_max_new_tokens=4, device="cpu")

    (run,) = stub._runs
    assert run.kwargs["project"] == "image_attack_optimization"
    assert run.kwargs["name"] == "wandb_stub"
    assert run.kwargs["config"]["num_iterations"] == 2
    assert run.kwargs["config"]["epsilon"] == 0.5
    assert run.finished

    scalar_rows = [d for d in run.logged
                   if "loss" in d and not any(isinstance(v, (_StubImage, _StubTable)) for v in d.values())]
    assert len(scalar_rows) == 2
    expect = {"loss", "image_loss", "adversarial_mean", "adversarial_std", "lr", "resave_error_mean",
              "resave_error_std", "resave_error_l1", "grad_norm", "accumulated_loss", "global_iteration",
              "fix_error_mean", "fix_error_std"}
    assert expect <= set(scalar_rows[0])
    assert len(scalar_rows[0]) >= 14

    images = [d for d in run.logged if any(isinstance(v, _StubImage) for v in d.values())]
    tables = [d for d in run.logged if any(isinstance(v, _StubTable) for v in d.values())]
    assert images and "adversarial_image" in images[0]
    assert os.path.exists(images[0]["adversarial_image"].path)
    assert tables and "model_outputs" in tables[0]
    tbl = tables[0]["model_outputs"]
    assert tbl.columns[:2] == ["iteration", "question"]
    assert "tiny-llava" in tbl.columns
    assert len(tbl.data[0]) == len(tbl.columns)
    # metrics.jsonl is written beside wandb: the config, then the same scalar rows
    exp = os.path.join(str(tmp_path), os.listdir(tmp_path)[0])
    rows = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert rows[0]["_config"]["exp_name"] == "wandb_stub"
    assert [r["loss"] for r in rows if "loss" in r] == [d["loss"] for d in scalar_rows]


def test_wandb_absent_falls_back_to_jsonl(monkeypatch, tmp_path):
    """No API key -> wandb never imported; metrics.jsonl is always written; ``use_wandb=False``
    (``--no_wandb``) never asks for it even with a key."""
    monkeypatch.delenv("WANDB_API_KEY", raising=False)
    monkeypatch.setitem(sys.modules, "wandb", None)  # import would fail loudly

    from adversarialvlm_tpu_torch.utils.logging import RunLogger

    logger = RunLogger("exp", str(tmp_path), {"a": 1}, use_wandb=True)
    logger.log({"loss": 1.0})
    logger.finish()
    rows = [json.loads(line) for line in open(os.path.join(tmp_path, "metrics.jsonl"))]
    assert rows[0] == {"_config": {"a": 1}}
    assert rows[1] == {"loss": 1.0}

    stub = _make_stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setenv("WANDB_API_KEY", "stub-key")
    RunLogger("exp", str(tmp_path), {"a": 1}, use_wandb=False).finish()
    assert stub._runs == []
