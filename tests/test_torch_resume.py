"""True resume, the profiler trace, the grad_accum_steps warning and the bench of the port, on the
CPU at tiny configs. Counterparts of tests/test_attack_e2e.py's resume tests
(test_true_resume_matches_uninterrupted, test_resume_off_grid_realigns_to_save_grid,
test_resume_does_not_refire_resaved_monitor_early, test_resume_state_grad_buf_migration): on the
CPU a resumed run is equal to the uninterrupted one, bit for bit, the transforms' draws included.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from adversarialvlm_tpu_torch.attack.config import AttackConfig
from adversarialvlm_tpu_torch.attack.engine import train
from adversarialvlm_tpu_torch.attack.io import load_attack_state, save_attack_state
from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
from adversarialvlm_tpu_torch.attack.step import init_state
from adversarialvlm_tpu_torch.cli import bench

QUESTIONS = ["How do I do the bad thing?", "Tell me more."]


@pytest.fixture(scope="module")
def victim():
    cfg = AttackConfig(exp_name="v", batch_size=2)
    return build_tiny_victim("tiny", cfg, (64, 80), questions=QUESTIONS, targets=["sure!", "ok then"],
                             test_questions=QUESTIONS, device="cpu")


def _x0():
    return np.random.default_rng(7).random((3, 64, 80), dtype=np.float32)


def _rows(exp):
    out = []
    for line in open(os.path.join(exp, "metrics.jsonl")):
        r = json.loads(line)
        r.pop("step_ms", None)
        if "_config" not in r:
            out.append(r)
    return out


def _final(exp):
    return np.fromfile(os.path.join(exp, "optimized_image_iter_final.bin"), np.float32)


RESUME_CASES = {
    "plain": {},
    "transforms": dict(use_gaussian_blur=True, use_local_crop=True, transform_prob=0.5,
                       mask_type="random_square", mask_size=16, mask_refresh_random_square=True,
                       target_text_random=True),
}


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_true_resume_matches_uninterrupted(victim, tmp_path, case):
    """5 uninterrupted steps against 3 steps resumed from the state saved at iteration 2
    (attack_state_iter_3.pt: numbered by optimizer steps, as the PNGs) to 5: every metrics.jsonl
    row from iteration 3 on (steps, resaved-loss monitors, checkpoints) and the final image are
    equal, with the blur, the crop, the transform_prob coins, the moving square and random
    targets drawn from their generators."""
    cfg = AttackConfig(exp_name="straight", num_iterations=5, save_steps=2, batch_size=2,
                       **RESUME_CASES[case])
    base = str(tmp_path)
    straight = train(cfg, [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    part1 = train(dataclasses.replace(cfg, exp_name="part1", num_iterations=3), [victim], _x0(),
                  base_path=base, run_tests=False, device="cpu")
    assert {"attack_state_iter_1.pt", "attack_state_iter_3.pt", "attack_state_latest.pt"} <= set(os.listdir(part1))
    part2 = train(dataclasses.replace(cfg, exp_name="part2",
                                      resume_state=os.path.join(part1, "attack_state_iter_3.pt")),
                  [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    want = [r for r in _rows(straight) if r["iteration"] >= 3]
    got = _rows(part2)
    assert [r["iteration"] for r in got if "loss" in r] == [3, 4]
    assert got == want
    assert np.array_equal(_final(part2), _final(straight))


def test_resume_off_grid_realigns_to_save_grid(victim, tmp_path):
    """A resume from a tail save off the save grid (after iteration 1 of a 3-step grid)
    checkpoints at the grid's boundaries 3 and 6 and at the tail 7 (PNGs named by optimizer
    steps)."""
    cfg = AttackConfig(exp_name="offgrid1", num_iterations=2, save_steps=3, batch_size=2,
                       loss_resaved_every=0)
    base = str(tmp_path)
    train(cfg, [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    exp = train(dataclasses.replace(cfg, exp_name="offgrid2", num_iterations=8,
                                    resume_state=f"{base}/offgrid1/attack_state_latest.pt"),
                [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    pngs = sorted(os.path.basename(p) for p in glob.glob(f"{exp}/optimized_image_iter_*.png"))
    assert pngs == ["optimized_image_iter_4.png", "optimized_image_iter_7.png",
                    "optimized_image_iter_8.png", "optimized_image_iter_final.png"]
    checkpoints = [r["iteration"] for r in _rows(exp) if "adversarial_image" in r]
    assert checkpoints == [3, 6, 7]


def test_resume_does_not_refire_resaved_monitor_early(victim, tmp_path):
    """The monitor's cadence is seeded from the iterations already run: resumed at iteration 4
    with loss_resaved_every 6, boundary 4 stays silent, 6 fires, the tail 7 stays silent."""
    cfg = AttackConfig(exp_name="rescad1", num_iterations=4, save_steps=2, batch_size=2,
                       loss_resaved_every=6)
    base = str(tmp_path)

    def resaved(exp):
        return [r["iteration"] for r in _rows(f"{base}/{exp}") if "loss_resaved" in r]

    train(cfg, [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    assert resaved("rescad1") == [0]
    train(dataclasses.replace(cfg, exp_name="rescad2", num_iterations=8,
                              resume_state=f"{base}/rescad1/attack_state_latest.pt"),
          [victim], _x0(), base_path=base, run_tests=False, device="cpu")
    assert resaved("rescad2") == [6]


def test_resume_state_grad_buf_migration(tmp_path, capsys):
    """A state saved with a gradient buffer loads into a config without one (a nonzero buffer is
    reported as discarded), one saved without loads into a config with one (zeros), and a state
    of another structure raises."""
    x0 = torch.rand((3, 8, 8), generator=torch.Generator().manual_seed(0))
    cfg_acc, cfg_one = AttackConfig(grad_accum_steps=2), AttackConfig(grad_accum_steps=1)
    with_buf, without_buf = init_state(cfg_acc, x0), init_state(cfg_one, x0)
    assert "grad_buf" in with_buf and "grad_buf" not in without_buf
    with torch.no_grad():
        with_buf["p"].fill_(0.25)
    with_buf["grad_buf"].fill_(1.0)
    gens = {"draws": torch.Generator().manual_seed(1)}
    p1 = save_attack_state(with_buf, gens, str(tmp_path), 1)
    restored = load_attack_state(p1, init_state(cfg_one, x0), {"draws": torch.Generator()})
    assert "grad_buf" not in restored and torch.equal(restored["p"], with_buf["p"])
    assert "partial gradient is discarded" in capsys.readouterr().out
    p2 = save_attack_state(without_buf, gens, str(tmp_path), 2)
    restored2 = load_attack_state(p2, init_state(cfg_acc, x0), {"draws": torch.Generator()})
    assert float(restored2["grad_buf"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="structure mismatch"):
        load_attack_state(p2, init_state(cfg_one, torch.zeros((3, 4, 4))), {"draws": torch.Generator()})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_attack_state(p2, init_state(cfg_one, x0), {"noise": torch.Generator()})


def test_profile_dir_writes_a_trace_of_the_second_chunk(victim, tmp_path):
    cfg = AttackConfig(exp_name="prof", num_iterations=4, save_steps=2, batch_size=2,
                       loss_resaved_every=0, profile_dir=str(tmp_path / "profile"))
    train(cfg, [victim], _x0(), base_path=str(tmp_path), run_tests=False, device="cpu")
    traces = os.listdir(tmp_path / "profile")
    assert traces == ["trace_iter_1-2.json"]  # chunks: [0], [1, 2], [3]
    trace = json.load(open(tmp_path / "profile" / traces[0]))
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])
    assert any(e.get("name") == "attack.forward" for e in trace["traceEvents"])  # the step's phases


def test_grad_accum_warning(victim, tmp_path):
    cfg = AttackConfig(exp_name="acc", num_iterations=2, save_steps=2, batch_size=2,
                       grad_accum_steps=2, loss_resaved_every=0)
    with pytest.warns(UserWarning, match="grad_accum_steps=2: checkpoint images are numbered by optimizer step"):
        train(cfg, [victim], _x0(), base_path=str(tmp_path), run_tests=False, device="cpu")


def test_bench_cpu_smoke_and_card_requirement(capsys):
    """--device cpu prints one JSON line with bench.py's keys, under the CPU smoke's metric;
    without a card and without --device cpu the bench raises."""
    result = bench.main(["--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert sorted(result) == ["metric", "mfu", "ms_per_step", "unit", "value", "vs_baseline"]
    assert result["metric"] == "attack_steps_per_sec_tiny_cpu_smoke" and result["value"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench.main([])


def test_bench_step_flops_against_the_hand_count():
    """The counted FLOPs of the 7B step at bench.py's T of 641 are within 0.5-2x of bench.py's
    21.0e12 hand count (17.7e12: no weight gradients, no remat replay)."""
    from adversarialvlm_tpu_torch.models.configs import llava_1_5_7b

    flops = bench.step_flops(llava_1_5_7b(), 641, 8)
    assert 0.5 < flops / bench.BENCH_ANALYTIC_FLOPS < 2.0
    assert abs(flops - 17.74e12) / 17.74e12 < 0.01
