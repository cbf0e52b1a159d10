"""The system under test for one configuration: the program's model bundle over weights drawn on the
device from the run's seed, its differentiable processor, its prompt pools tokenized by the
family's tokenizer, which the benchmark writes into TMPDIR."""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from port_bench.harness import loader, tokenizer_files

CORPORA = tokenizer_files.CORPORA


def corpora() -> dict:
    with open(CORPORA, encoding="utf-8") as f:
        return json.load(f)


def attack_questions() -> list[str]:
    """The attack's prompt pool (``--prompt list``): the unsafe questions, then the benign ones."""
    c = corpora()
    return c["not_safe_questions"] + c["questions"]


def test_questions() -> list[str]:
    """The 50 held-out questions of the test decode."""
    return corpora()["not_safe_questions_test"]


def tokenizer(config: dict, family) -> object:
    """The program's reader over the family-style tokenizer files the benchmark writes."""
    from adversarialvlm_tpu_torch.utils.tokenization import HFTokenizer

    style = config["program"]["tokenizer_style"]
    directory = os.path.join(tempfile.gettempdir(), "port_bench_tokenizers", f"{style}-{family.pad_token_id(config)}")
    tokenizer_files.write(style, family.pad_token_id(config), directory)
    return HFTokenizer.from_pretrained(directory)


def build(config: dict, in_hw, batch_size: int, seed: int, device, questions, target: str,
          split: dict | None = None):
    """The program's victim (``attack/engine.py::VictimSetup``) of ``config`` for sources of ``in_hw``:
    weights from a generator on ``device`` seeded with ``seed``, prompt pools of ``questions`` and
    the one ``target``, in the configuration's ``torch_dtype``. ``split`` collects the seconds of
    each part of the set-up."""
    from adversarialvlm_tpu_torch.attack.engine import VictimSetup
    from adversarialvlm_tpu_torch.models.registry import make_bundle
    from adversarialvlm_tpu_torch.processors import grid_hw_for
    from adversarialvlm_tpu_torch.processors.adv_inputs import AdvInputs
    from adversarialvlm_tpu_torch.processors.prompts import spec_for_family

    split = split if split is not None else {}
    dtype = getattr(torch, config["torch_dtype"])
    family = loader.family_module(config["family"])
    vlm_cfg = family.vlm_config(config)
    t0 = time.perf_counter()
    tok = tokenizer(config, family)
    proc = family.image_processor(config, in_hw, device)
    spec = spec_for_family(vlm_cfg.family)
    n_img = proc.num_image_tokens(in_hw)
    inputs = AdvInputs(spec=spec, tokenizer=tok, questions=questions, test_questions=test_questions(),
                       batch_size=batch_size, target_texts=[target], num_image_tokens=n_img,
                       image_token_id=vlm_cfg.image_token_id, pad_token_id=family.pad_token_id(config))
    split["tokenizer_and_inputs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = make_bundle(config["name"], vlm_cfg.family, vlm_cfg, device, seed=seed, dtype=dtype,
                         grid_hw=grid_hw_for(vlm_cfg.family, proc, in_hw, vlm_cfg))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    split["weights_s"] = time.perf_counter() - t0
    return VictimSetup(name=config["name"], bundle=bundle, adv_processor=proc, adv_inputs=inputs,
                       compute_dtype=dtype)
