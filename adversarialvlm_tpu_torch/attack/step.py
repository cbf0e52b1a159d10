"""The single-victim attack step, the hot loop of the port. Counterpart of
adversarialvlm_tpu/attack/step.py.

One step: x = ε·tanh(p) → differentiable preprocess → repeat to the batch → + EoT noise →
forward → suffix CE + range penalty → gradient w.r.t. p → gradient mask → optional gradient
accumulation → AdamW + StepLR → on-device uint8 round trip that updates σ_resave.

Random draws: the (target, question) indices are drawn on the host by :func:`sample_chunk_xs`
from a CPU ``torch.Generator``; the EoT noise is drawn on the victim's device from the step's own
generator, or taken from ``xs["noise"]`` (tests inject the JAX package's draws there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.ops.image import uint8_roundtrip
from adversarialvlm_tpu_torch.ops.losses import (
    image_fit_loss,
    perturbation_clamp,
    suffix_cross_entropy,
)


@dataclasses.dataclass
class VictimHandles:
    """Per-victim data of the step: params and target pools on the victim's device, prompt pools
    on the host (rows are gathered per step)."""

    name: str
    forward: Callable
    params: dict
    process: Callable
    prompt_pool: np.ndarray        # (N_t, N_q, L) left-padded
    prompt_lengths: np.ndarray     # (N_t, N_q) true row lengths
    target_pool: torch.Tensor      # (N_t, S) right-aligned
    target_mask_pool: torch.Tensor
    suffix_lengths: torch.Tensor   # (N_t,)
    shift: int
    pad_token_id: int
    device: torch.device
    compute_dtype: torch.dtype = torch.float32


def unported_features(cfg: AttackConfig, cross: bool = False) -> list[str]:
    """Attack options the port does not run yet, each with its ROADMAP item."""
    waits = {
        "cross-model attack (ROADMAP modules item 9)": cross,
        "DPO_flag (ROADMAP modules item 9)": cfg.DPO_flag,
        "use_gaussian_blur (ROADMAP modules item 1: ops/blur.py)": cfg.use_gaussian_blur,
        "use_local_crop (ROADMAP modules item 1: ops/crop.py)": cfg.use_local_crop,
        "mask_type (ROADMAP modules item 1: ops/masks.py)": cfg.mask_type is not None,
        "resume_state (ROADMAP modules item 5)": cfg.resume_state is not None,
        "profile_dir (ROADMAP modules item 5)": cfg.profile_dir is not None,
    }
    return [name for name, asked in waits.items() if asked]


def make_optimizer(cfg: AttackConfig, p: torch.Tensor):
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01) with StepLR, as torch defaults the
    reference uses (attack_model.py:184,216)."""
    opt = torch.optim.AdamW([p], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=cfg.scheduler_step_size, gamma=cfg.scheduler_gamma
    )
    return opt, sched


def init_state(cfg: AttackConfig, x0: torch.Tensor) -> dict:
    p = torch.zeros_like(x0, requires_grad=True)
    opt, sched = make_optimizer(cfg, p)
    state = {
        "p": p,
        "optimizer": opt,
        "scheduler": sched,
        "resave_std": torch.tensor(cfg.sigma, dtype=torch.float32, device=x0.device),
        "accum_loss": torch.zeros((), dtype=torch.float32, device=x0.device),
        "iteration": 0,
        "global_iteration": 0,
    }
    if cfg.grad_accum_steps > 1:
        state["grad_buf"] = torch.zeros_like(x0)
    return state


def _std_unbiased(x: torch.Tensor) -> torch.Tensor:
    # torch .std() uses ddof=1, as the reference (attack_model.py:373)
    return x.float().std()


def _length_mask(ids: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Attention mask of left-padded rows from their true lengths (never from pad-id values)."""
    L = ids.shape[-1]
    return (torch.arange(L, device=ids.device)[None, :] >= L - lens[:, None]).to(torch.int32)


def sample_chunk_xs(generator: torch.Generator, n: int, cfg: AttackConfig, victims) -> list[dict]:
    """Host draws for the next ``n`` steps from a CPU generator: per step, the target index and
    the batch's question rows gathered from the host pool, with their lengths."""
    v = victims[0]
    n_targets, n_q = v.prompt_pool.shape[:2]
    out = []
    for _ in range(n):
        t = (
            int(torch.randint(0, n_targets, (), generator=generator))
            if cfg.target_text_random
            else 0
        )
        q = torch.randint(0, n_q, (cfg.batch_size,), generator=generator).numpy()
        out.append({
            "t_idx": t,
            "rows": [torch.from_numpy(v.prompt_pool[t, q])],
            "lens": [torch.from_numpy(v.prompt_lengths[t, q])],
        })
    return out


class AttackStep:
    """``step(state, xs) -> (state, metrics)`` for one victim; ``state`` comes from
    :func:`init_state` and is updated in place (p and the optimizer moments)."""

    def __init__(self, victims: list[VictimHandles], cfg: AttackConfig, x0: torch.Tensor,
                 grad_mask: torch.Tensor, cross: bool = False):
        waiting = unported_features(cfg, cross or len(victims) != 1)
        if waiting:
            raise NotImplementedError("not ported yet: " + ", ".join(waiting))
        self.victim = victims[0]
        self.cfg = cfg
        self.x0 = x0
        self.grad_mask = grad_mask
        self.noise_gen = torch.Generator(device=self.victim.device).manual_seed(cfg.seed)

    def victim_ce(self, arg_img, t_idx, ids, lens, resave_std=None, noise=None) -> torch.Tensor:
        """Suffix CE of the victim on ``arg_img``; EoT noise of std ``resave_std`` is added to
        the pixel batch unless ``resave_std`` is None (the monitor's clean forward)."""
        v = self.victim
        ids = ids.to(v.device)
        am = _length_mask(ids, lens.to(v.device))
        b = ids.shape[0]
        pv = v.process(arg_img)["pixel_values"]
        pv = pv.expand(b, *pv.shape[1:]).to(v.compute_dtype)
        if resave_std is not None:
            if noise is None:
                noise = torch.randn(pv.shape, generator=self.noise_gen, device=v.device)
            pv = pv + (noise.to(v.device) * resave_std).to(pv.dtype)
        # only the last target_width + 1 positions are scored by the suffix CE
        k = v.target_pool.shape[1] + 1
        logits = v.forward(v.params, ids, am, {"pixel_values": pv}, logits_last_k=k)
        return suffix_cross_entropy(
            logits[:, :-1, :],
            v.target_pool[t_idx][None, :].expand(b, -1),
            v.suffix_lengths[t_idx],
            v.shift,
            target_mask=v.target_mask_pool[t_idx][None, :],
        )

    def loss_and_grad(self, p: torch.Tensor, xs: dict, resave_std: torch.Tensor):
        """(total loss, image loss, CE, x, d total / d p) at ``p`` for the draws ``xs``."""
        cfg = self.cfg
        p = p.detach().requires_grad_(True)
        x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
        img_loss = image_fit_loss(self.x0, x)
        noise = xs["noise"][0] if "noise" in xs else None
        ce = self.victim_ce(
            self.x0 + x, xs["t_idx"], xs["rows"][0], xs["lens"][0], resave_std, noise
        )
        total = (ce + img_loss) / cfg.grad_accum_steps
        (grad,) = torch.autograd.grad(total, p)
        return total.detach(), img_loss.detach(), ce.detach(), x.detach(), grad

    def __call__(self, state: dict, xs: dict):
        cfg = self.cfg
        p = state["p"]
        loss, img_loss, ce, x, grad = self.loss_and_grad(p, xs, state["resave_std"])
        g = grad * self.grad_mask
        grad_norm = torch.linalg.vector_norm(g)
        accum_loss = state["accum_loss"] + loss
        # the lr the optimizer applies in this step (schedule count = applies before it)
        lr_now = cfg.lr * cfg.scheduler_gamma ** (state["global_iteration"] // cfg.scheduler_step_size)

        if cfg.grad_accum_steps > 1:
            state["grad_buf"] += g
            do_step = (state["iteration"] + 1) % cfg.grad_accum_steps == 0
            update = state["grad_buf"]
        else:
            do_step, update = True, g
        if do_step:
            p.grad = update.clone()
            state["optimizer"].step()
            state["scheduler"].step()
            p.grad = None
            state["global_iteration"] += 1
            if "grad_buf" in state:
                state["grad_buf"].zero_()

        # resave monitoring on the pre-update image: the on-device uint8 round trip
        x_mod = self.x0 + x
        x_resaved = uint8_roundtrip(x_mod)
        resave_abs = torch.abs(x_resaved - x_mod)
        resave_std_new = _std_unbiased(resave_abs)
        fix_err = torch.abs((x_resaved - self.x0) - x)

        metrics = {
            "loss": loss,
            "image_loss": img_loss,
            "adversarial_mean": x.mean(),
            "adversarial_std": _std_unbiased(x),
            "lr": lr_now,
            "resave_error_mean": resave_abs.mean(),
            "resave_error_std": resave_std_new,
            "resave_error_l1": resave_abs.sum(),
            "grad_norm": grad_norm,
            "accumulated_loss": accum_loss if do_step else math.nan,
            "global_iteration": state["global_iteration"],
            "fix_error_mean": fix_err.mean(),
            "fix_error_std": _std_unbiased(fix_err),
            "target_idx": xs["t_idx"],
            "loss_0": ce,
        }
        state["resave_std"] = resave_std_new
        state["accum_loss"] = torch.zeros_like(accum_loss) if do_step else accum_loss
        state["iteration"] += 1
        return state, metrics


def build_attack_step(victims, cfg: AttackConfig, x0: torch.Tensor, grad_mask: torch.Tensor,
                      cross: bool = False) -> AttackStep:
    """The step for one victim; cross-model attacks are not ported yet and raise."""
    return AttackStep(victims, cfg, x0, grad_mask, cross)


def build_resaved_loss_fn(victims, cfg: AttackConfig, x0: torch.Tensor):
    """The resaved-loss monitor: mean clean CE on the uint8-round-tripped image over a fresh
    question batch drawn from ``generator``. Pure logging, run at checkpoint boundaries."""
    v = victims[0]
    step = AttackStep(victims, cfg, x0, torch.ones_like(x0))

    @torch.no_grad()
    def resaved_loss(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
        x_resaved = uint8_roundtrip(x0 + x)
        xs = sample_chunk_xs(generator, 1, cfg, [v])[0]
        return step.victim_ce(x_resaved, xs["t_idx"], xs["rows"][0], xs["lens"][0])

    return resaved_loss
