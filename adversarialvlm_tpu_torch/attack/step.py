"""The attack step, the hot loop of the port, for one victim or several (the cross-model universal
attack, with its DPO mode). Counterpart of adversarialvlm_tpu/attack/step.py.

One step: x = ε·tanh(p) → [blur] → [random-resized crop of x₀ + x] → differentiable preprocess
→ repeat to the batch → + EoT noise → forward → suffix CE + range penalty → gradient w.r.t. p →
gradient mask (optionally a random square moved every step) → optional gradient accumulation →
AdamW + StepLR → on-device uint8 round trip that updates σ_resave. Several victims share the
prefix up to the crop; each runs its forward and backward in turn into the gradient of the shared
image, which then flows back through the prefix once (the reference's serial per-victim backward,
crossattack_models.py:352-391), so the step holds one victim's activations at a time.

Random draws: the (target, question) indices are drawn on the host by :func:`sample_chunk_xs`
from a CPU ``torch.Generator``, in a fixed order per step: the target (when
``target_text_random``), under DPO the refusal coin and one refusal row per victim, then each
victim's question rows. The transforms' draws (the crop box, the two ``transform_prob`` coins,
the moving square's position and the cross-mode blur σ) come each from a CPU generator of its own
(:class:`TransformDraws`), as the JAX step folds a key of its own for each, so switching a
transform on never shifts the question draws. The EoT noise is drawn on the victims' device from
the step's own generator, victim by victim, or taken from ``xs["noise"]``. Tests inject the JAX
package's draws through ``xs``.

Under a mesh with a data axis that divides the batch (parallel/mesh.py::dp_size, JAX's
``_dp_spec``) each data rank takes its contiguous rows of every draw: the question rows and the
EoT noise, which is drawn for the whole batch from the same generator on every rank and then
sliced, so a run sees the noise of the one-rank run. The gradient of the shared image and the
victims' CEs (means over rows) are then summed over the data group in one all-reduce and divided
by its size: the whole batch's mean. An axis that does not divide the batch warns once a step build
and runs without data parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.ops.blur import draw_sigma, gaussian_blur, random_sigma_gaussian_blur
from adversarialvlm_tpu_torch.ops.crop import crop_resize, sample_crop_box
from adversarialvlm_tpu_torch.ops.image import uint8_roundtrip
from adversarialvlm_tpu_torch.ops.losses import (
    image_fit_loss,
    perturbation_clamp,
    suffix_cross_entropy,
)
from adversarialvlm_tpu_torch.ops.masks import random_square_mask, square_position
from adversarialvlm_tpu_torch.parallel.collectives import all_reduce_data
from adversarialvlm_tpu_torch.parallel.mesh import active_mesh, batch_rows, dp_size
from adversarialvlm_tpu_torch.utils.spans import span


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
    # DPO: the last n_refuse pool rows are this victim's refusal texts; rows
    # [0, N_t - n_refuse) are the shared targets. 0 when DPO is off.
    n_refuse: int = 0


def shared_target_count(victims: list[VictimHandles]) -> int:
    """The number of shared target rows in every victim's pools (the refusal rows sit after
    them), checked across the victims: a victim built with the DPO corpus beside one built
    without it would otherwise gather the wrong rows."""
    shared = {int(v.suffix_lengths.shape[0]) - v.n_refuse for v in victims}
    if len(shared) != 1:
        raise ValueError(
            "victims disagree on the shared target count: "
            f"{[(v.name, int(v.suffix_lengths.shape[0]), v.n_refuse) for v in victims]}"
        )
    return shared.pop()


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
    initial random-square mask, streams 1-4 the transforms' draws. None of them is the
    (target, question) generator, which is seeded with ``seed`` itself."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class TransformDraws:
    """The transforms' host draws of each step, each kind from a CPU generator of its own seeded
    from ``seed``: the crop box (when ``use_local_crop``), the blur and crop coins (when
    :func:`coins_drawn`; each fires with probability ``transform_prob``), the moving square's
    position (when :func:`moving_square`) and, in cross mode with the blur, the blur's σ, drawn
    from U(0.1, 2.0) every step as torchvision's GaussianBlur draws it (crossattack_models.py:187).
    ``draw()`` gives the keys the step reads from ``xs``: ``crop_box`` (top, left, h, w),
    ``coins`` (blur, crop), ``mask_pos`` (i, j) and ``sigma``. The σ generator (stream 4) exists
    only in cross mode with the blur, so the other runs' saved generators are as they were."""

    KINDS = ("crop", "coins", "mask", "sigma")

    def __init__(self, cfg: AttackConfig, image_shape, seed: int, cross: bool = False):
        self.cfg, self.shape = cfg, tuple(image_shape)
        self.gens = {kind: host_generator(seed, 1 + i) for i, kind in enumerate(self.KINDS)
                     if kind != "sigma" or (cross and cfg.use_gaussian_blur)}

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
        if "sigma" in self.gens:
            out["sigma"] = draw_sigma(self.gens["sigma"])
        return out


def sample_chunk_xs(generator: torch.Generator, n: int, cfg: AttackConfig, victims,
                    transforms: TransformDraws | None = None) -> list[dict]:
    """Host draws for the next ``n`` steps from a CPU generator: per step, the shared target
    index ``t_idx``; under DPO the refusal coin ``refuse`` and each victim's target row
    ``t_idxs`` (a refusal row of its own, after the shared ones, when the coin says so, the shared
    target otherwise: the JAX package's fix of the reference's lingering refusal target); each
    victim's question rows from its own pool size, gathered from its host pool at its target row,
    with their lengths; and, with ``transforms``, that step's transform draws from their own
    generators."""
    n_targets = shared_target_count(victims)
    dpo = bool(cfg.DPO_flag)
    out = []
    for _ in range(n):
        t = (
            int(torch.randint(0, n_targets, (), generator=generator))
            if cfg.target_text_random
            else 0
        )
        xs = {"t_idx": t}
        t_list = [t] * len(victims)
        if dpo:
            refuse = bool(torch.rand((), generator=generator) < cfg.refuse_prob)
            rows = [n_targets + int(torch.randint(0, v.n_refuse, (), generator=generator))
                    for v in victims]
            t_list = rows if refuse else t_list
            xs.update(refuse=refuse, t_idxs=t_list)
        qs = [torch.randint(0, v.prompt_pool.shape[1], (cfg.batch_size,), generator=generator).numpy()
              for v in victims]
        xs["rows"] = [torch.from_numpy(v.prompt_pool[ti, q]) for v, ti, q in zip(victims, t_list, qs)]
        xs["lens"] = [torch.from_numpy(v.prompt_lengths[ti, q]) for v, ti, q in zip(victims, t_list, qs)]
        out.append({**xs, **(transforms.draw() if transforms is not None else {})})
    return out


def _drawn(xs: dict, key: str, why: str):
    if key not in xs:
        raise ValueError(f"the step's draws lack {key!r}, which {why} needs: sample them with "
                         "sample_chunk_xs(..., transforms=TransformDraws(...)) or inject them")
    return xs[key]


def check_dpo_mode(cfg: AttackConfig, cross: bool) -> None:
    """DPO runs only in the cross attack (reference parity, attack_model.py:278-279)."""
    if cfg.DPO_flag and not cross:
        raise NotImplementedError("DPO flag is not implemented")


class AttackStep:
    """``step(state, xs) -> (state, metrics)`` for one victim, or for several with ``cross``
    (loss Σᵢ (wᵢ·CEᵢ + image loss), the range penalty counted once per victim as in
    crossattack_models.py:369; DPO only there); ``state`` comes from :func:`init_state` and is
    updated in place (p and the optimizer moments)."""

    def __init__(self, victims: list[VictimHandles], cfg: AttackConfig, x0: torch.Tensor,
                 grad_mask: torch.Tensor, model_weights: list[float] | None = None,
                 cross: bool = False):
        check_dpo_mode(cfg, cross)
        if not cross and len(victims) != 1:
            raise ValueError(f"the single-victim step takes one victim, got {len(victims)}: "
                             "pass cross=True")
        if cfg.DPO_flag:
            # a victim built without the DPO corpus has no refusal rows to draw from
            missing = [v.name for v in victims if v.n_refuse < 1]
            if missing:
                raise ValueError(
                    "DPO_flag requires every victim's adv_inputs to carry refusal target rows; "
                    f"none found for: {missing} (build the victims with a DPO-enabled config so "
                    "the refusal corpus is tokenized into the pools)")
        shared_target_count(victims)
        # the single-victim branch ignores model weights, as the JAX step does
        self.weights = list(model_weights) if cross and model_weights else [1.0] * len(victims)
        if len(self.weights) != len(victims):
            raise ValueError(f"{len(self.weights)} model weights for {len(victims)} victims")
        if len({v.device for v in victims}) != 1:
            raise ValueError(f"the victims must share one device: {[v.device for v in victims]}")
        self.victims = victims
        self.cfg = cfg
        self.cross = cross
        self.x0 = x0
        self.grad_mask = grad_mask
        self.noise_gen = torch.Generator(device=victims[0].device).manual_seed(cfg.seed)
        # the data axis that splits the batch under the active mesh (1: every row on every rank)
        mesh = active_mesh()
        self.dp = dp_size(mesh, cfg.batch_size, warn=mesh is not None and mesh.is_writer)
        self.rows = batch_rows(cfg.batch_size, mesh)

    def victim_ce(self, i, arg_img, t_idx, ids, lens, resave_std=None, noise=None) -> torch.Tensor:
        """Suffix CE of victim ``i`` on ``arg_img`` over this data rank's rows of the batch
        ``ids``; EoT noise of std ``resave_std``, drawn (or given) for the whole batch and sliced
        alike, is added to the pixel batch unless ``resave_std`` is None (the monitor's clean
        forward)."""
        v = self.victims[i]
        full_b = ids.shape[0]
        with span("attack.inputs"):
            ids = ids[self.rows].to(v.device)
            am = _length_mask(ids, lens[self.rows].to(v.device))
        b = ids.shape[0]
        with span("attack.forward"):
            processed = dict(v.process(arg_img))
            pv = processed.pop("pixel_values")
            pv = pv.expand(b, *pv.shape[1:]).to(v.compute_dtype)
            if resave_std is not None:
                if noise is None:
                    noise = torch.randn((full_b, *pv.shape[1:]), generator=self.noise_gen, device=v.device)
                pv = pv + (noise[self.rows].to(v.device) * resave_std).to(pv.dtype)
            # only the last target_width + 1 positions are scored by the suffix CE
            k = v.target_pool.shape[1] + 1
            # the processor's other inputs (mllama's aspect ids and mask) ride at the image's batch
            logits = v.forward(v.params, ids, am, {"pixel_values": pv, **processed}, logits_last_k=k)
            return suffix_cross_entropy(
                logits[:, :-1, :],
                v.target_pool[t_idx][None, :].expand(b, -1),
                v.suffix_lengths[t_idx],
                v.shift,
                target_mask=v.target_mask_pool[t_idx][None, :],
            )

    def loss_and_grad(self, p: torch.Tensor, xs: dict, resave_std: torch.Tensor):
        """(total loss, image loss, each victim's CE, x, d total / d p) at ``p`` for the draws
        ``xs``. x is the perturbation after the blur (when it fires), as the JAX step reassigns
        it: the x of the range penalty and of every metric; the crop applies to x₀ + x for the
        victims alone. The prefix (clamp, blur, crop) is computed once; each victim's forward and
        backward run in turn into the gradient of the shared image, which then flows back through
        the prefix once. x is a tensor of its own, never p's storage, which the update then
        overwrites."""
        cfg, n = self.cfg, len(self.victims)
        with span("attack.prefix"):
            p = p.detach().requires_grad_(True)
            coins = _drawn(xs, "coins", "transform_prob < 1") if coins_drawn(cfg) else (True, True)
            x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
            if cfg.use_gaussian_blur and coins[0]:
                if self.cross:
                    x = random_sigma_gaussian_blur(x, cfg.gblur_kernel_size,
                                                   sigma=_drawn(xs, "sigma", "the cross-mode blur"))
                else:
                    x = gaussian_blur(x, cfg.gblur_kernel_size, cfg.gblur_sigma)
            arg = self.x0 + x
            if cfg.use_local_crop and coins[1]:
                arg = crop_resize(arg, *_drawn(xs, "crop_box", "use_local_crop"))
            img_loss = image_fit_loss(self.x0, x)
        t_list = xs.get("t_idxs", [xs["t_idx"]] * n)
        shared = arg.detach().requires_grad_(True)
        ces, g_arg = [], None
        for i in range(n):
            with span("attack.victim", name=self.victims[i].name):
                noise = xs["noise"][i] if "noise" in xs else None
                ce = self.victim_ce(i, shared, t_list[i], xs["rows"][i], xs["lens"][i], resave_std, noise)
                with span("attack.backward"):
                    (g,) = torch.autograd.grad(self.weights[i] * ce / cfg.grad_accum_steps, shared)
                g_arg = g if g_arg is None else g_arg + g
                ces.append(ce.detach())
        if self.dp > 1:
            with span("attack.data_allreduce"):
                g_arg, ces = self.mean_over_data(g_arg, ces)
        with span("attack.prefix_backward"):
            (grad,) = torch.autograd.grad((arg, img_loss * (n / cfg.grad_accum_steps)), p,
                                          grad_outputs=(g_arg, None))
        img_loss = img_loss.detach()
        if self.cross:
            total = sum(self.weights[i] * ces[i] + img_loss for i in range(n)) / cfg.grad_accum_steps
        else:
            total = (ces[0] + img_loss) / cfg.grad_accum_steps
        # clamp_method "none" without a blur makes x p itself
        x = x.detach().clone() if x.data_ptr() == p.data_ptr() else x.detach()
        return total, img_loss, ces, x, grad

    def mean_over_data(self, g: torch.Tensor | None, ces: list[torch.Tensor]):
        """(g, ces) averaged over the data group with one all-reduce of both."""
        parts = ([] if g is None else [g.reshape(-1).float()]) + [c.reshape(1).float() for c in ces]
        flat = all_reduce_data(torch.cat(parts)) / self.dp
        n = 0 if g is None else g.numel()
        if g is not None:
            g = flat[:n].view_as(g).to(g.dtype)
        return g, [flat[n + j].to(c.dtype) for j, c in enumerate(ces)]

    def __call__(self, state: dict, xs: dict):
        with span("attack.step", step=state["iteration"], victims=len(self.victims), batch=self.cfg.batch_size):
            return self._step(state, xs)

    def _step(self, state: dict, xs: dict):
        cfg = self.cfg
        p = state["p"]
        loss, img_loss, ces, x, grad = self.loss_and_grad(p, xs, state["resave_std"])
        with span("attack.update"):
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

        with span("attack.monitor"):
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
                # -1 on a refusing step: no shared target was trained
                "target_idx": -1 if xs.get("refuse") else xs["t_idx"],
            }
            if cfg.DPO_flag:
                metrics["refuse_flag"] = int(xs["refuse"])
            for i, ce in enumerate(ces):
                metrics[f"loss_{i}"] = self.weights[i] * ce + img_loss if self.cross else ce
        state["resave_std"] = resave_std_new
        state["accum_loss"] = torch.zeros_like(accum_loss) if do_step else accum_loss
        state["iteration"] += 1
        return state, metrics


def build_attack_step(victims, cfg: AttackConfig, x0: torch.Tensor, grad_mask: torch.Tensor,
                      model_weights: list[float] | None = None, cross: bool = False) -> AttackStep:
    """The step for one victim, or with ``cross`` for one or several (each victim's CE weighted
    by ``model_weights``, default 1.0 each; ``cfg.DPO_flag`` only there)."""
    return AttackStep(victims, cfg, x0, grad_mask, model_weights, cross)


def saved_perturbation(cfg: AttackConfig, p: torch.Tensor, cross: bool = False,
                       sigma: float | None = None) -> torch.Tensor:
    """The perturbation the run saves and monitors: ε·tanh(p), blurred when ``use_gaussian_blur``
    and ``transform_prob >= 1`` (the reference reassigns x to the blurred value before saving,
    attack_model.py:302, crossattack_models.py:335,477; at ``transform_prob < 1`` the attack also
    trained the untransformed image, which is then the deliverable; JAX engine.py:252-271,
    step.py:556-560): at the fixed σ, or in cross mode at ``sigma``, the last executed step's
    draw (unblurred while no step has run)."""
    x = perturbation_clamp(p, cfg.epsilon, cfg.clamp_method)
    if cfg.use_gaussian_blur and cfg.transform_prob >= 1.0:
        if not cross:
            x = gaussian_blur(x, cfg.gblur_kernel_size, cfg.gblur_sigma)
        elif sigma is not None:
            x = random_sigma_gaussian_blur(x, cfg.gblur_kernel_size, sigma=sigma)
    return x


def build_resaved_loss_fn(victims, cfg: AttackConfig, x0: torch.Tensor, cross: bool = False):
    """The resaved-loss monitor: the mean over the victims of the clean CE on the
    uint8-round-tripped saved image (blurred at ``sigma``, the last step's draw, in cross mode)
    for one step's draws ``xs`` (:func:`sample_chunk_xs` from a generator of the monitor's own:
    under DPO it draws its own coin and refusal rows). Pure logging, run at checkpoint
    boundaries."""
    step = AttackStep(victims, cfg, x0, torch.ones_like(x0), cross=cross)
    n = len(victims)

    @torch.no_grad()
    def resaved_loss(p: torch.Tensor, xs: dict, sigma: float | None = None) -> torch.Tensor:
        x_resaved = uint8_roundtrip(x0 + saved_perturbation(cfg, p, cross, sigma))
        t_list = xs.get("t_idxs", [xs["t_idx"]] * n)
        ces = [step.victim_ce(i, x_resaved, t_list[i], xs["rows"][i], xs["lens"][i]) for i in range(n)]
        if step.dp > 1:
            _, ces = step.mean_over_data(None, ces)
        return sum(ces) / n

    return resaved_loss
