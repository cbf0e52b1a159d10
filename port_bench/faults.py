"""Faults planted underneath a run, for the tests that must see ``correct`` come out false and for
the fault readings of ``control.py --fault``. Each takes what the harness's ``plant`` hook gives:
the attack step."""

from __future__ import annotations


class Unchanged:
    """A step that computes its loss and returns its state unchanged."""

    def __init__(self, step):
        self.step = step

    def __call__(self, state, xs):
        loss, *_ = self.step.loss_and_grad(state["p"], xs, state["resave_std"])
        return state, {"loss": loss}


def unchanged(step):
    return Unchanged(step)


def half_batch(step):
    """The step over the first half of each batch's rows, its mean taken over them alone."""
    ce = step.victim_ce

    def victim_ce(i, arg_img, t_idx, ids, lens, resave_std=None, noise=None):
        h = ids.shape[0] // 2
        return ce(i, arg_img, t_idx, ids[:h], lens[:h], resave_std, None if noise is None else noise[:h])

    step.victim_ce = victim_ce
    return step


ATTACK = {"unchanged": unchanged, "half_batch": half_batch}
