"""The work counts against hand counts of the published widths."""

import pytest

from port_bench.harness import loader
from port_bench.work import common, phi3v

PHI = loader.read_json(f"{loader.BENCH}/configs/phi35v.json")


def test_phi_batch_4_step():
    """About 64 TFLOP a step at batch 4, T 797 (decoder 46, tower 14, attention 3.5)."""
    w = common.attack_step(phi3v, PHI, 4, 797, [797] * 4, (512, 512), 9)
    assert w["ops"] == pytest.approx(63.3e12, rel=0.02)
    tower = [x for x in w["linears"] if x[3] in ("q", "k", "v", "out", "fc1", "fc2")]
    assert len(tower) == 6 * 23 and tower[0][0] == 4 * 5 * 577  # 5 tiles a row, 23 layers to layer_idx -2
    assert len([x for x in w["linears"] if common.dgrad_eligible(x[1], x[2])]) == 364  # the dgrad launches of a step at these shapes


def test_geometry():
    assert phi3v.tile_grid(PHI, (512, 512)) == (2, 2) and phi3v.image_tokens(PHI, (512, 512)) == 757


def test_causal_pairs_and_roofline_bound():
    assert common.causal_pairs([3, 1]) == 7
    ops, nbytes = common.linear_input_grad(4096, 4096, 4096)
    assert common.least_seconds(ops, nbytes) == pytest.approx(ops / 989e12)
    assert common.least_seconds(2.0, 3.35e12) == pytest.approx(1.0)
