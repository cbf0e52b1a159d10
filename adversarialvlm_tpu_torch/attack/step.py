"""The single-victim attack step, the hot loop of the port. Counterpart of
adversarialvlm_tpu/attack/step.py.

One step: x = ε·tanh(p) → [blur] → [random-resized crop of x₀ + x] → differentiable preprocess
→ repeat to the batch → + EoT noise → forward → suffix CE + range penalty → gradient w.r.t. p →
gradient mask (optionally a random square moved every step) → optional gradient accumulation →
AdamW + StepLR → on-device uint8 round trip that updates σ_resave.

Random draws: the (target, question) indices are drawn on the host by :func:`sample_chunk_xs`
from a CPU ``torch.Generator``; so are the transforms' draws (the crop box, the two
``transform_prob`` coins and the moving square's position), each from a CPU generator of its own
(:class:`TransformDraws`), as the JAX step folds a key of its own for each, so switching a
transform on never shifts the question draws. The EoT noise is drawn on the victim's device from
the step's own generator, or taken from ``xs["noise"]``. Tests inject the JAX package's draws
through ``xs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.ops.blur import gaussian_blur
from adversarialvlm_tpu_torch.ops.crop import crop_resize, sample_crop_box
from adversarialvlm_tpu_torch.ops.image import uint8_roundtrip
from adversarialvlm_tpu_torch.ops.losses import (
    image_fit_loss,
    perturbation_clamp,
    suffix_cross_entropy,
)
from adversarialvlm_tpu_torch.ops.masks import random_square_mask, square_position


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
        "cross-model attack (ROADMAP modules: cross attack and DPO)": cross,
        "DPO_flag (ROADMAP modules: cross attack and DPO)": cfg.DPO_flag,
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


def moving_square(cfg: AttackConfig) -> bool:
    """Whether the random-square mask moves every step (the JAX step's condition)."""
    return bool(cfg.mask_refresh_random_square) and cfg.mask_type == "random_square"


def coins_drawn(cfg: AttackConfig) -> bool:
    """Whether the step flips the transform_prob coins (the JAX step's condition)."""
    return cfg.transform_prob < 1.0 and bool(cfg.use_gaussian_blur or cfg.use_local_crop)


def host_generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one kind of host draw of a run seeded with ``seed``: stream 0 is the
    initial random-square mask, streams 1-3 the transforms' draws. None of them is the
    (target, question) generator, which is seeded with ``seed`` itself."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class TransformDraws:
    """The transforms' host draws of each step, each kind from a CPU generator of its own seeded
    from ``seed``: the crop box (when ``use_local_crop``), the blur and crop coins (when
    :func:`coins_drawn`; each fires with probability ``transform_prob``) and the moving square's
    position (when :func:`moving_square`). ``draw()`` gives the keys the step reads from ``xs``:
    ``crop_box`` (top, left, h, w), ``coins`` (blur, crop) and ``mask_pos`` (i, j)."""

    KINDS = ("crop", "coins", "mask")

    def __init__(self, cfg: AttackConfig, image_shape, seed: int):
        self.cfg, self.shape = cfg, tuple(image_shape)
        self.gens = {kind: host_generator(seed, 1 + i) for i, kind in enumerate(self.KINDS)}

    def draw(self) -> dict:
        cfg, out = self.cfg, {}
        if cfg.use_local_crop:
            out["crop_box"] = sample_crop_box(
                self.gens["crop"], self.shape[1], self.shape[2],
                (cfg.crop_scale_min, cfg.crop_scale_max), (cfg.crop_ratio_min, cfg.crop_ratio_max))
        if coins_drawn(cfg):
            u = torch.rand((2,), generator=self.gens["coins"])
            out["coins"] = (bool(u[0] < cfg.transform_prob), bool(u[1] < cfg.transform_prob))
        if moving_square(cfg):
            out["mask_pos"] = square_position(self.gens["mask"], self.shape, int(cfg.mask_size))
        return out


def sample_chunk_xs(generator: torch.Generator, n: int, cfg: AttackConfig, victims,
                    transforms: TransformDraws | None = None) -> list[dict]:
    """Host draws for the next ``n`` steps from a CPU generator: per step, the target index and
    the batch's question rows gathered from the host pool, with their lengths, and, with
    ``transforms``, that step's transform draws from their own generators."""
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
            **(transforms.draw() if transforms is not None else {}),
        })
    return out


def _drawn(xs: dict, key: str, why: str):
    if key not in xs:
        raise ValueError(f"the step's draws lack {key!r}, which {why} needs: sample them with "
                         "sample_chunk_xs(..., transforms=TransformDraws(...)) or inject them")
    return xs[key]


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
        """(total loss, image loss, CE, x, d total / d p) at ``p`` for the draws ``xs``. x is the
        perturbation after the blur (when it fires), as the JAX step reassigns it: the x of the
        range penalty and of every metric; the crop applies to x₀ + x for the victim alone. x is
        a tensor of its own, never p's storage, which the update then overwrites."""
        cfg = self.cfg
        p = p.detach().requires_grad_(True)
        coins = _drawn(xs, "coins", "transform_prob < 1") if coins_drawn(cfg) else (True, True)
        x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
        if cfg.use_gaussian_blur and coins[0]:
            x = gaussian_blur(x, cfg.gblur_kernel_size, cfg.gblur_sigma)
        arg = self.x0 + x
        if cfg.use_local_crop and coins[1]:
            arg = crop_resize(arg, *_drawn(xs, "crop_box", "use_local_crop"))
        img_loss = image_fit_loss(self.x0, x)
        noise = xs["noise"][0] if "noise" in xs else None
        ce = self.victim_ce(arg, xs["t_idx"], xs["rows"][0], xs["lens"][0], resave_std, noise)
        total = (ce + img_loss) / cfg.grad_accum_steps
        (grad,) = torch.autograd.grad(total, p)
        # clamp_method "none" without a blur makes x p itself
        x = x.detach().clone() if x.data_ptr() == p.data_ptr() else x.detach()
        return total.detach(), img_loss.detach(), ce.detach(), x, grad

    def __call__(self, state: dict, xs: dict):
        cfg = self.cfg
        p = state["p"]
        loss, img_loss, ce, x, grad = self.loss_and_grad(p, xs, state["resave_std"])
        mask = self.grad_mask
        if moving_square(cfg):
            mask = random_square_mask(self.x0.shape, int(cfg.mask_size),
                                      position=_drawn(xs, "mask_pos", "the moving square"),
                                      device=self.x0.device)
        g = grad * mask
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


def saved_perturbation(cfg: AttackConfig, p: torch.Tensor) -> torch.Tensor:
    """The perturbation the run saves and monitors: ε·tanh(p), blurred at the fixed σ when
    ``use_gaussian_blur`` and ``transform_prob >= 1`` (the reference reassigns x to the blurred
    value before saving, attack_model.py:302; at ``transform_prob < 1`` the attack also trained
    the untransformed image, which is then the deliverable; JAX engine.py:252-271,
    step.py:556-560)."""
    x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
    if cfg.use_gaussian_blur and cfg.transform_prob >= 1.0:
        x = gaussian_blur(x, cfg.gblur_kernel_size, cfg.gblur_sigma)
    return x


def build_resaved_loss_fn(victims, cfg: AttackConfig, x0: torch.Tensor):
    """The resaved-loss monitor: mean clean CE on the uint8-round-tripped saved image over a fresh
    question batch drawn from ``generator``. Pure logging, run at checkpoint boundaries."""
    v = victims[0]
    step = AttackStep(victims, cfg, x0, torch.ones_like(x0))

    @torch.no_grad()
    def resaved_loss(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        x_resaved = uint8_roundtrip(x0 + saved_perturbation(cfg, p))
        xs = sample_chunk_xs(generator, 1, cfg, [v])[0]
        return step.victim_ce(x_resaved, xs["t_idx"], xs["rows"][0], xs["lens"][0])

    return resaved_loss
