"""Prompt and answer corpora of the attack and its evaluation (the port's own copy of
``corpora.json``). Counterpart of adversarialvlm_tpu/data/corpora.py."""

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))

with open(os.path.join(_HERE, "corpora.json"), "r", encoding="utf-8") as _f:
    _DATA = json.load(_f)

#: 50 unsafe questions held out for in-training testing.
not_safe_questions_test: list[str] = _DATA["not_safe_questions_test"]
#: 43 unsafe questions used for training.
not_safe_questions: list[str] = _DATA["not_safe_questions"]
#: 106 benign questions mixed into the training pool.
questions: list[str] = _DATA["questions"]
#: 39 compliance-style target answers.
answers: list[str] = _DATA["answers"]
#: 15 adversarial target answers.
adv_answers: list[str] = _DATA["adv_answers"]


def train_question_pool(prompt: str = "list") -> list[str]:
    """The full unsafe + benign pool for ``prompt == "list"``, else that single prompt."""
    if prompt != "list":
        return [prompt]
    return not_safe_questions + questions


def target_text_pool(target_text: str, target_text_random: bool) -> list[str]:
    """Target texts: the 54-answer pool in multi-answer mode, else the one target."""
    if target_text_random:
        return answers + adv_answers
    return [target_text]
