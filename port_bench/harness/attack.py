"""Attack cells: the program's attack step (``attack/step.py::build_attack_step``) driven as
``attack/engine.py::train`` drives it, one step after the other in a closed loop, each step
starting once the last one was enqueued.

Set-up builds the victim and the step, and runs the first ``checked_steps`` steps through the same
call and feed as the window: they warm up every shape (the rows of every step are padded to the
pool's one length, so every step has the same shapes), and their readings are what the check
holds against the plain reference once the window has closed."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import victim as victim_mod


class Feed:
    """The steps' rows: the pool's questions in an order drawn from the seed, ``batch`` a step,
    every question once before any comes again, in the step's input format (``xs``)."""

    def __init__(self, adv_inputs, batch: int, seed: int):
        self.pool, self.lengths = adv_inputs.prompt_pool[0], adv_inputs.prompt_lengths[0]
        self.rng = np.random.default_rng(seed)
        self.batch, self.order = batch, []

    def next(self) -> dict:
        while len(self.order) < self.batch:
            self.order.extend(self.rng.permutation(len(self.pool)).tolist())
        q, self.order = self.order[: self.batch], self.order[self.batch:]
        return {"t_idx": 0, "rows": [torch.from_numpy(self.pool[q])], "lens": [torch.from_numpy(self.lengths[q])]}


def _readings(state: dict, losses: list, first_grad) -> dict:
    grad = first_grad if first_grad is not None else torch.zeros_like(state["p"])
    return {"loss": [float(x) for x in losses], "grad": grad.detach().float(),
            "grad_norm": float(torch.linalg.vector_norm(grad)),
            "change_norm": float(torch.linalg.vector_norm(state["p"].detach()))}


def _scored(ai) -> tuple:
    """(a, b, tokens): the CE's window [T - a, T - b) of each row and the target's tokens scored
    there, as the target encodes alone (``AdvInputs``' target pool, right-aligned)."""
    a, b, s = int(ai.suffix_lengths[0]), int(ai.shift), int(ai.target_width)
    return a, b, torch.as_tensor(ai.target_pool[0][s - a:s - b])


def setup(cell, seed: int, device, split: dict, plant=None) -> dict:
    """The victim, the step and its state after the checked steps, and their readings. ``plant``
    (tests) wraps the step to break it."""
    tr = cell.traffic
    victim = victim_mod.build(cell.config, tuple(tr["source_hw"]), tr["batch_size"], seed, device,
                              victim_mod.attack_questions(), tr["target_text"], split)
    t0 = time.perf_counter()
    s = checked_steps(cell, victim, seed, device, plant)
    split["warm_up_s"] = time.perf_counter() - t0
    return s


def checked_steps(cell, victim, seed: int, device, plant=None) -> dict:
    """The step over ``victim`` and its state after the first ``checked_steps`` steps of the feed,
    with their readings: each step's loss, the first gradient's norm (Adam's first moment after one
    step is (1 - β₁)·g) and the norm of p after the last."""
    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.step import build_attack_step, init_state

    tr = cell.traffic
    acfg = AttackConfig(exp_name=cell.name, batch_size=tr["batch_size"], lr=tr["lr"], epsilon=tr["epsilon"],
                        target_text=tr["target_text"], seed=seed)
    x0 = torch.full((3, *tr["source_hw"]), tr["x0"], dtype=torch.float32, device=device)
    step = build_attack_step([victim.handles()], acfg, x0, torch.ones_like(x0))
    if plant is not None:
        step = plant(step)
    state = init_state(acfg, x0)
    feed = Feed(victim.adv_inputs, tr["batch_size"], seed)
    checked, losses, first_grad = [], [], None
    for k in range(tr["checked_steps"]):
        xs = feed.next()
        state, metrics = step(state, xs)
        checked.append(xs)
        losses.append(metrics["loss"])
        if k == 0:
            moment = state["optimizer"].state.get(state["p"], {}).get("exp_avg")
            first_grad = None if moment is None else moment / (1 - 0.9)
    readings = _readings(state, losses, first_grad)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ai = victim.adv_inputs
    return {"victim": victim, "step": step, "state": state, "feed": feed, "x0": x0, "acfg": acfg,
            "checked": checked, "readings": readings, "scored": _scored(ai), "t": int(ai.max_len),
            "head": int(ai.target_width) + 1}


def window(s: dict, seconds: float, device) -> dict:
    """Steps until ``seconds`` have passed, then a synchronization: the rate over all of them."""
    step, feed = s["step"], s["feed"]
    state = s["state"]
    enqueue, lens = [], []
    t0 = time.perf_counter()
    while True:
        xs = feed.next()
        a = time.perf_counter()
        state, _ = step(state, xs)
        enqueue.append(time.perf_counter() - a)
        lens.append(xs["lens"][0].tolist())
        if time.perf_counter() - t0 >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - t0
    s["state"] = state
    return {"window_s": window_s, "units": len(enqueue), "enqueue_s": enqueue, "lens": lens, "t": s["t"],
            "head": s["head"]}


def traced_window(s: dict, steps: int, device):
    from port_bench.harness import trace

    lens = []

    def run():  # once for each traced window; the last run's rows are the host window's
        lens.clear()
        state = s["state"]
        for _ in range(steps):
            xs = s["feed"].next()
            state, _ = s["step"](state, xs)
            lens.append(xs["lens"][0].tolist())
        s["state"] = state

    tr = trace.traced(run, steps, device)
    tr.lens = lens
    return tr


def reference(cell, s: dict, weights, seed: int, device) -> dict:
    """The plain reference's readings of the checked steps of ``s``, on the same inputs."""
    from port_bench.harness import loader
    from port_bench.reference import attack as ref_attack

    fam = loader.reference_module(cell.config["family"])
    feed = [{"rows": xs["rows"][0].to(device), "lens": xs["lens"][0].to(device)} for xs in s["checked"]]
    gen = torch.Generator(device=device).manual_seed(seed)
    a, b, tokens = s["scored"]
    return ref_attack.run(fam, cell.config, weights, s["x0"], feed, gen, lr=cell.traffic["lr"],
                          epsilon=cell.traffic["epsilon"], sigma=s["acfg"].sigma, scored=(a, b, tokens.to(device)))


def row_err(grad: torch.Tensor, ref: dict) -> float:
    """The first gradient's error within the directions in which the rows' own gradients part from
    their mean, across the mean's direction: the error that counting a row twice, or leaving it out,
    makes. Over the reference's gradient's norm. Rounding spreads over every direction of p, so
    little of it falls into these few."""
    g_ref = ref["grad"].flatten()
    u = g_ref / torch.linalg.vector_norm(g_ref)
    d = ref["rows_grad"].flatten(1) - g_ref
    d = d - (d @ u)[:, None] * u
    q, r = torch.linalg.qr(d.T)
    q = q[:, r.diagonal().abs() > 1e-6 * r.diagonal().abs().max()]
    return float(torch.linalg.vector_norm(q.T @ (grad.flatten() - g_ref)) / ref["grad_norm"])


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the largest relative gap of a step's loss; the relative gaps of the
    first gradient's norm and of the norm of p's change over the checked steps; the first
    gradient's error, the norm of its difference from the reference's over the reference's norm;
    and that error within the rows' own directions (``row_err``)."""
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    grad = prog["grad"].to(ref["grad"].device)
    return {"loss_gap": max(rel(a, b) for a, b in zip(prog["loss"], ref["loss"])),
            "grad_gap": rel(prog["grad_norm"], ref["grad_norm"]),
            "change_gap": rel(prog["change_norm"], ref["change_norm"]),
            "grad_err": float(torch.linalg.vector_norm(grad - ref["grad"]) / ref["grad_norm"]),
            "row_err": row_err(grad, ref)}


def check(cell, s: dict, seed: int, device) -> dict:
    """The checked steps' readings against the reference's; the program's state is freed first,
    its weights (the benchmark's inputs) kept."""
    weights = s["victim"].bundle.params
    for key in ("step", "state", "feed", "victim"):
        s.pop(key)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return gaps(s["readings"], reference(cell, s, weights, seed, device))
