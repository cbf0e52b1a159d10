"""Attack driver: the single-victim and the cross-model loop and their artifacts. Counterpart of
adversarialvlm_tpu/attack/engine.py::train.

Steps run one by one on the victims' device; metrics stay on the device until the next save
boundary, where they are logged together with the checkpoint image, the resaved-loss monitor
when due, and every victim's test decode of the held-out questions on the uint8-round-tripped
image.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings

import numpy as np
import torch

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.io import (
    create_directory,
    load_attack_state,
    save_attack_state,
    save_checkpoint,
    save_config,
    save_mask,
)
from adversarialvlm_tpu_torch.attack.step import (
    TransformDraws,
    VictimHandles,
    build_attack_step,
    build_resaved_loss_fn,
    host_generator,
    init_state,
    sample_chunk_xs,
    saved_perturbation,
)
from adversarialvlm_tpu_torch.eval.train_test import run_model_test
from adversarialvlm_tpu_torch.ops.image import uint8_roundtrip
from adversarialvlm_tpu_torch.ops.masks import create_mask, default_mask
from adversarialvlm_tpu_torch.parallel.mesh import active_mesh, use_mesh
from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs
from adversarialvlm_tpu_torch.utils import spans
from adversarialvlm_tpu_torch.utils.device import resolve_device
from adversarialvlm_tpu_torch.utils.logging import RunLogger


@dataclasses.dataclass
class VictimSetup:
    """Everything the engine needs for one victim model."""

    name: str
    bundle: object        # models.registry.ModelBundle
    adv_processor: object
    adv_inputs: object    # processors.adv_inputs.AdvInputs
    # the dtype the step and the decode caches run in, as the victim was made (a loaded
    # checkpoint keeps its norms in f32 whatever it computes in)
    compute_dtype: torch.dtype = torch.float32

    def handles(self) -> VictimHandles:
        dev = self.bundle.device
        ai = self.adv_inputs
        family, proc = self.bundle.family, self.adv_processor

        def process(img):
            # the one pixel-input contract (engine._process_fn): tensor entries, a leading image dim
            return normalize_pixel_inputs(family, proc.process(img))

        return VictimHandles(
            name=self.name,
            forward=self.bundle.forward,
            params=self.bundle.params,
            process=process,
            prompt_pool=ai.prompt_pool,
            prompt_lengths=ai.prompt_lengths,
            target_pool=torch.as_tensor(ai.target_pool, device=dev),
            target_mask_pool=torch.as_tensor(ai.target_mask_pool, device=dev),
            suffix_lengths=torch.as_tensor(ai.suffix_lengths, device=dev),
            shift=ai.shift,
            pad_token_id=ai.pad_token_id,
            device=dev,
            compute_dtype=self.compute_dtype,
            n_refuse=ai.n_refuse,
        )


@contextlib.contextmanager
def _profiler(device: torch.device):
    """torch.profiler over host and, on the card, device activity, with the step's spans
    (utils/spans.py) recorded as ranges of the trace; the spans are dropped afterwards."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    spans.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        spans.disable()
        spans.drain()


class _StepClock:
    """Per-step wall time: CUDA events on the card (read at the save boundary, so timing adds
    no synchronisation), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        """Milliseconds between consecutive marks, which are then cleared."""
        if self.cuda:
            self.marks[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            ms = [1000.0 * (b - a) for a, b in zip(self.marks, self.marks[1:])]
        self.marks = []
        return ms


def train(
    cfg: AttackConfig,
    victims: list[VictimSetup],
    x0: np.ndarray,
    base_path: str = "./runs",
    cross: bool | None = None,
    run_tests: bool = True,
    test_max_new_tokens: int = 64,
    device=None,
    mesh=None,
    use_wandb: bool = True,
) -> str:
    """Run the attack on ``device`` (default: the card, which must hold the victims); returns
    the experiment path. ``cross`` (default: more than one victim) runs the cross-model
    universal attack, with ``cfg.model_weights`` and, under ``cfg.DPO_flag``, its refusal
    targets; DPO without ``cross`` raises before anything is written. Artifacts: config.json,
    mask.pt/png (``create_mask`` when both ``mask_type`` and ``mask_size`` are set, else the
    nonzero pixels of x₀), optimized_image_iter_<global_iter>.png/.bin at each save boundary and
    "final" (x₀ + x, x blurred when ``use_gaussian_blur`` and ``transform_prob >= 1``: at the
    fixed σ, or in cross mode at the last executed step's σ), metrics.jsonl (one row per step,
    with its ``step_ms``) and, with ``run_tests``, test_results_iter_<iteration>.csv at each save
    boundary (each victim's greedy answers of ``test_max_new_tokens`` tokens to the held-out
    questions, in its own compute dtype), and the attack state at each save boundary,
    attack_state_iter_<global_iter>.pt and attack_state_latest.pt. ``use_wandb`` logs to wandb too,
    where it is installed and a key is set (utils/logging.py).

    ``cfg.resume_state`` (such a file) continues that run: p, the optimizer, the counters and
    every generator as they were saved, the chunks realigned to the save grid and the
    resaved-loss monitor's cadence kept. ``cfg.profile_dir`` traces the second chunk with
    torch.profiler (host and, on the card, device activity) into a Chrome trace there, with the
    step's phases (``attack.*``, utils/spans.py) as ranges around their operations.

    ``mesh`` (default: the active one, parallel/mesh.py) runs this rank's part of a (data ×
    model) mesh, as the JAX engine runs its whole body under ``jax.set_mesh``: each victim's
    decoder sharded over the model axis (:func:`shard_victim`, unless its setup already built its
    shards), the batch over the data axis, the test decode with each rank's cache of its heads.
    Every rank keeps p, the optimizer moments and every generator equal; rank 0 alone writes the
    run's files and logs, and on resume every rank reads the same state file."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is not None and mesh.size > 1:
        with use_mesh(mesh):
            for v in victims:
                shard_victim(v, mesh)
            return _train(cfg, victims, x0, base_path, cross, run_tests, test_max_new_tokens, device,
                          mesh.is_writer, use_wandb)
    return _train(cfg, victims, x0, base_path, cross, run_tests, test_max_new_tokens, device, True, use_wandb)


def shard_victim(victim: VictimSetup, mesh) -> None:
    """Cut ``victim``'s decoder to ``mesh``'s model rank (parallel/sharding.py), in place, unless
    it holds its shards already."""
    from adversarialvlm_tpu_torch.parallel.sharding import shard_params, vlm_param_shardings

    bundle = victim.bundle
    if mesh.model == 1 or bundle.model_shards == mesh.model:
        return
    if bundle.model_shards != 1:
        raise ValueError(f"{victim.name} is sharded {bundle.model_shards} ways, not {mesh.model}")
    bundle.params = shard_params(bundle.params, vlm_param_shardings(bundle.params, bundle.cfg.text), mesh,
                                 bundle.device)
    bundle.model_shards = mesh.model


class _NoLogger:
    """The logger of a rank that writes nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _train(cfg, victims, x0, base_path, cross, run_tests, test_max_new_tokens, device, writer, use_wandb) -> str:
    dev = resolve_device(device)
    cross = len(victims) > 1 if cross is None else cross
    if any(v.bundle.device != dev for v in victims):
        raise ValueError(f"victims must live on {dev}")
    if cfg.grad_accum_steps > 1:
        # the reference's quirk, kept: PNGs are numbered by optimizer applies, test CSVs by loop
        # iteration, and the eval layer's iteration+1 image lookup only lines up when the two
        # counters advance together
        warnings.warn(
            f"grad_accum_steps={cfg.grad_accum_steps}: checkpoint images are numbered by optimizer "
            "step (reference parity), so the eval stack's test-iteration+1 image lookup will not "
            "match them; run SafeBench/test_post against the PNG names actually written",
            stacklevel=2,
        )

    x0 = np.asarray(x0, np.float32)
    if cfg.start_from_white:
        x0 = np.ones_like(x0)
    if cfg.mask_type is not None and cfg.mask_size is not None:
        mask = create_mask(cfg.mask_type, cfg.mask_size, x0.shape, host_generator(cfg.seed, 0))
    else:
        mask = default_mask(x0)
    x0_dev = torch.as_tensor(x0, device=dev)
    handles = [v.handles() for v in victims]
    # the step checks the run's options (DPO only in cross mode, ...) before the run directory exists
    step = build_attack_step(handles, cfg, x0_dev, torch.as_tensor(mask, device=dev),
                             model_weights=cfg.model_weights, cross=cross)

    if writer:
        exp_path = create_directory(cfg.exp_name, base_path)
        save_config(dataclasses.asdict(cfg), exp_path)
        save_mask(mask, exp_path)
        logger = RunLogger(cfg.exp_name, exp_path, {**dataclasses.asdict(cfg), "models": [v.name for v in victims]},
                           use_wandb=use_wandb)
    else:
        exp_path, logger = os.path.join(base_path, cfg.exp_name), _NoLogger()

    state = init_state(cfg, x0_dev)
    draws = torch.Generator().manual_seed(cfg.seed)
    transforms = TransformDraws(cfg, x0.shape, cfg.seed, cross=cross)
    generators = {"draws": draws, "noise": step.noise_gen,
                  **{f"transform_{k}": g for k, g in transforms.gens.items()}}
    if "sigma" in transforms.gens:
        # cross mode with the blur: the σ of the last executed step, which the saved image and
        # the monitor reuse (None until a step ran); saved with the attack state
        state["last_sigma"] = None
    if cfg.resume_state:
        load_attack_state(cfg.resume_state, state, generators)
    resaved_fn = build_resaved_loss_fn(handles, cfg, x0_dev, cross) if cfg.loss_resaved_every else None

    def current_image() -> np.ndarray:
        with torch.no_grad():
            return (x0_dev + saved_perturbation(cfg, state["p"], cross, state.get("last_sigma"))).cpu().numpy()

    def checkpoint_and_test(iteration: int) -> None:
        img = current_image()
        if writer:
            png = save_checkpoint(img, exp_path, state["global_iteration"])
            save_attack_state(state, generators, exp_path, state["global_iteration"])
            logger.log_image("adversarial_image", png, iteration)
        if not run_tests:
            return
        # test on the image as the saved PNG holds it (attack_model.py:418-419)
        img_q = uint8_roundtrip(torch.from_numpy(img)).numpy()
        first_row, test_log = run_model_test(
            bundles=[v.bundle for v in victims],
            adv_inputs_list=[v.adv_inputs for v in victims],
            adv_processors=[v.adv_processor for v in victims],
            model_names=[v.name for v in victims],
            not_safe_questions_test=victims[0].adv_inputs.test_questions,
            target_text=victims[0].adv_inputs.target_texts[0],
            exp_path=exp_path,
            iteration=iteration,
            image_chw=img_q,
            max_new_tokens=test_max_new_tokens,
            cache_dtype=[v.compute_dtype for v in victims],
            write=writer,
        )
        logger.log({"iteration": iteration, **test_log})
        if first_row is not None:
            logger.log_table("model_outputs", ["iteration", "question", *[v.name for v in victims]],
                             [[iteration, *first_row]], iteration)

    clock = _StepClock(dev)
    it, chunks_run = state["iteration"], 0
    # a resumed run fires the monitor at the next multiple of loss_resaved_every, not at once
    last_resaved_bucket = (it - 1) // cfg.loss_resaved_every if cfg.loss_resaved_every and it else -1
    try:
        while it < cfg.num_iterations:
            # run to the next save boundary: the reference checkpoints after step k whenever
            # k % save_steps == 0, and after the last step (a resume off that grid lands back on
            # it)
            chunk = min(cfg.save_steps - ((it - 1) % cfg.save_steps), cfg.num_iterations - it)
            profiling = cfg.profile_dir is not None and chunks_run == 1
            rows = []
            with _profiler(dev) if profiling else contextlib.nullcontext() as prof:
                clock.mark()
                for xs in sample_chunk_xs(draws, chunk, cfg, handles, transforms):
                    state, metrics = step(state, xs)
                    clock.mark()
                    rows.append(metrics)
                    if "sigma" in xs:
                        state["last_sigma"] = xs["sigma"]
                if profiling and dev.type == "cuda":
                    torch.cuda.synchronize()
            if profiling and writer:
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(cfg.profile_dir, f"trace_iter_{it}-{it + chunk - 1}.json"))
            chunks_run += 1
            step_ms = clock.step_ms()
            for j, metrics in enumerate(rows):
                row = {k: v.item() if torch.is_tensor(v) else v for k, v in metrics.items()}
                logger.log({**row, "step_ms": step_ms[j], "iteration": it + j})
            it += chunk
            boundary_iter = it - 1
            if resaved_fn is not None and boundary_iter // cfg.loss_resaved_every > last_resaved_bucket:
                last_resaved_bucket = boundary_iter // cfg.loss_resaved_every
                gen = torch.Generator().manual_seed(cfg.seed + boundary_iter)
                xs = sample_chunk_xs(gen, 1, cfg, handles)[0]
                value = float(resaved_fn(state["p"], xs, state.get("last_sigma")))
                logger.log({"iteration": boundary_iter, "loss_resaved": value})
            checkpoint_and_test(boundary_iter)
            logger.flush()
        if writer:
            save_checkpoint(current_image(), exp_path, "final")
    finally:
        logger.finish()
    return exp_path
