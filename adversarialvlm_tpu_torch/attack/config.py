"""Attack configuration: the JAX package's AttackConfig field for field, so a config.json
from either package reads in the other. Field names mirror the reference CLI flags
(attack_model.py:483-519). Counterpart of adversarialvlm_tpu/attack/config.py.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class AttackConfig:
    exp_name: str = "exp"
    img_orig: str = "gray.png"
    prompt: str = "list"
    target_text: str = "sure, here it is!"
    lr: float = 1e-2
    num_iterations: int = 1000
    save_steps: int = 10
    batch_size: int = 4
    grad_accum_steps: int = 1
    scheduler_step_size: int = 100
    scheduler_gamma: float = 1.0
    restart_num: int = 0
    mask_type: str | None = None
    mask_size: int | None = None
    clamp_method: str = "tanh"
    epsilon: float = 0.5
    sigma: float = 0.001
    start_from_white: bool = False
    target_text_random: bool = False
    DPO_flag: bool = False
    refuse_prob: float = 0.0  # deprecated in reference as well
    use_gaussian_blur: bool = False
    gblur_kernel_size: int = 5
    gblur_sigma: float = 7.0
    use_local_crop: bool = False
    crop_scale_min: float = 0.6
    crop_scale_max: float = 1.0
    crop_ratio_min: float = 0.75
    crop_ratio_max: float = 1.33
    # transform-sampled EoT (labeled UPGRADE over the reference's always-on
    # blur/crop, attack_model.py:190-202): each step applies the enabled
    # blur+crop transforms with this probability and trains the raw image
    # otherwise, so ONE artifact converges both at identity and under the
    # transform distribution. 1.0 = reference parity (always transformed);
    # when < 1.0 the SAVED artifact is the untransformed image.
    transform_prob: float = 1.0
    # cross-attack extras
    model_weights: list[float] | None = None
    # extras of the JAX package (absent from the reference)
    seed: int = 0
    # resaved-loss monitor cadence: it fires at the first save boundary
    # at/after each multiple of N iterations; 0 disables the monitor forward
    loss_resaved_every: int = 1
    mask_refresh_random_square: bool = False  # moving-patch variant (M-fork)
    # true resume from an attack-state checkpoint (attack_state_*.pt, attack/io.py) and a
    # profiler trace of the second chunk into this directory (attack/engine.py::train)
    resume_state: str | None = None
    profile_dir: str | None = None

    def __post_init__(self):
        if self.clamp_method not in ("tanh", "clamp", "none"):
            # the reference CLI's advertised choices (attack_model.py:499).
            # Its train() raises for anything but tanh at init
            # (attack_model.py:186); here all three work — see
            # ops/losses.py:perturbation_clamp (upgrade)
            raise NotImplementedError(
                f"Unknown clamping method {self.clamp_method!r}"
            )
        if self.DPO_flag and not (0.0 <= self.refuse_prob <= 1.0):
            # only meaningful under DPO (the reference deprecated the flag,
            # attack_model.py:503) — a junk value in an old run's
            # config.json must not break replay/resume of non-DPO runs
            raise ValueError(
                f"refuse_prob must be in [0, 1], got {self.refuse_prob}"
            )
        # DPO mode is cross-engine only, exactly as in the reference:
        # crossattack_models.py:302-310 implements it (target becomes a
        # random per-model refusal with prob refuse_prob), while
        # attack_model.py:278-279 raises — build_attack_step enforces that
        # split (config does not know cross-ness yet).
