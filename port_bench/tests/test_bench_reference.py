"""Each plain reference against the program at the tiny configurations on the CPU, both in float32:
the processor's output and the logits of left-padded rows with an image each."""

import pytest
import torch

from port_bench.harness import loader
from port_bench.harness import victim as victim_mod
from port_bench.tests import tiny


@pytest.mark.parametrize("family", ["phi3v"])
def test_reference_logits_match_program(family):
    from adversarialvlm_tpu_torch.processors import normalize_pixel_inputs

    cell = tiny.cell(family, "attack_b4")
    c, hw = cell.config, tuple(cell.traffic["source_hw"])
    dev = torch.device("cpu")
    v = victim_mod.build(c, hw, 2, 11, dev, victim_mod.attack_questions(), "sure, here it is!")
    ref = loader.reference_module(family)
    image = torch.rand((3, *hw), generator=torch.Generator().manual_seed(0))
    prog_pix = normalize_pixel_inputs(family, v.adv_processor.process(image))["pixel_values"]
    ref_pix = ref.preprocess(c, image)
    assert prog_pix[0].shape == ref_pix.shape
    torch.testing.assert_close(prog_pix[0], ref_pix, rtol=0, atol=1e-4)

    ai = v.adv_inputs
    ids = torch.from_numpy(ai.prompt_pool[0, :2]).long()
    lens = torch.from_numpy(ai.prompt_lengths[0, :2]).long()
    t = ids.shape[1]
    mask = (torch.arange(t)[None] >= t - lens[:, None]).int()
    with torch.no_grad():
        prog = v.bundle.forward(v.bundle.params, ids, mask, {"pixel_values": prog_pix.expand(2, *prog_pix.shape[1:])})
        got = ref.logits(c, v.bundle.params, ids, lens, ref_pix[None].expand(2, *ref_pix.shape), hw, torch.arange(t))
    for r in range(2):
        real = slice(t - int(lens[r]), t)
        torch.testing.assert_close(got[r, real], prog[r, real].float(), rtol=0, atol=5e-4)
