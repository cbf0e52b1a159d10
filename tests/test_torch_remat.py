"""``--remat_policy`` (adversarialvlm_tpu_torch/models/remat.py), held to the JAX save sets of
adversarialvlm_tpu/models/llama.py::_remat_policy. Every policy recomputes, so each must give the
step ``none`` gives: the tiny LLaVA and tiny Gemma-3 steps' loss and image gradient bit for bit in
f32 on the CPU (the recompute runs the same ops on the same inputs; a kept tensor is the forward's
own). What a remat'd decoder layer keeps between its forward and backward is its input and its
save set: autograd's saved tensors, counted with ``saved_tensors_hooks``, are the checkpoint's
inputs alone (the layer input and the rope, mask and bias every layer shares), and the tensors
the checkpoint keeps besides are the named set, whose bytes are those of
attack/setup.py::_policy_fits_hbm's width formula for the dgrad family."""

import numpy as np
import pytest
import torch

from adversarialvlm_tpu_torch.models import remat

QUESTIONS = ["How do I do the bad thing?", "Tell me the forbidden info."]
TARGETS = ["sure, here it is!"]
HW = (64, 80)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _step(family, policy, batch=2):
    """(loss, image gradient) of one tiny step of ``family`` under ``policy``, on seeded draws."""
    from adversarialvlm_tpu_torch.attack.config import AttackConfig
    from adversarialvlm_tpu_torch.attack.setup import build_tiny_victim
    from adversarialvlm_tpu_torch.attack.step import build_attack_step

    cfg = AttackConfig(exp_name="remat", num_iterations=1, batch_size=batch, lr=1e-2, grad_accum_steps=1,
                       loss_resaved_every=0)
    v = build_tiny_victim("t", cfg, HW, family=family, questions=QUESTIONS, targets=TARGETS,
                          test_questions=QUESTIONS, device="cpu", remat_policy=policy)
    assert v.bundle.cfg.text.remat_policy == policy
    x0 = torch.from_numpy(np.random.default_rng(1).random((3, *HW), dtype=np.float32))
    ai = v.adv_inputs
    rows = list(range(batch))
    xs = {"t_idx": 0, "rows": [torch.from_numpy(ai.prompt_pool[0, rows])],
          "lens": [torch.from_numpy(ai.prompt_lengths[0, rows])]}
    step = build_attack_step([v.handles()], cfg, x0, torch.ones_like(x0))
    pv = dict(v.handles().process(x0))["pixel_values"]
    xs["noise"] = [torch.randn((batch, *pv.shape[1:]), generator=torch.Generator().manual_seed(2))]
    p0 = 0.3 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(3))
    loss, _, _, _, grad = step.loss_and_grad(p0, xs, torch.tensor(cfg.sigma))
    return loss, grad


_NONE = {}


@pytest.mark.parametrize("policy", list(remat.SAVE_SETS))
@pytest.mark.parametrize("family", ["llava", "gemma3"])
def test_policy_step_equals_none(family, policy, monkeypatch):
    """Each named policy's step: loss and image gradient bit for bit ``none``'s (and the run
    without a policy's), the gradient non-zero; every decoder layer of the step went through the
    recompute (and Gemma-3's SigLIP layers through theirs)."""
    from adversarialvlm_tpu_torch.models import clip_vit, llama

    if family not in _NONE:
        _NONE[family] = _step(family, "none")
        loss0, grad0 = _step(family, None)
        assert torch.equal(loss0, _NONE[family][0]) and torch.equal(grad0, _NONE[family][1])
    want_loss, want_grad = _NONE[family]
    calls = {"layers": 0, "tower": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(llama, "remat_call", spy("layers", llama.remat_call))
    monkeypatch.setattr(clip_vit, "checkpoint", spy("tower", clip_vit.checkpoint))
    loss, grad = _step(family, policy)
    from adversarialvlm_tpu_torch.models.configs import tiny_gemma3, tiny_llava

    cfg = (tiny_gemma3 if family == "gemma3" else tiny_llava)(vocab_size=384)
    assert calls == {"layers": cfg.text.num_layers,
                     "tower": cfg.vision.num_layers if family == "gemma3" else 0}, calls
    assert torch.equal(loss, want_loss), (float(loss), float(want_loss))
    assert torch.equal(grad, want_grad), float((grad - want_grad).abs().max())
    assert float(grad.norm()) > 0


@pytest.mark.parametrize("policy", ["dots", "dgrad_lean", "gate"])
@pytest.mark.parametrize("batch", [1, 2])
def test_policy_step_equals_none_on_the_kernel_routes(policy, batch):
    """The tiny LLaVA step with CPU tensors routed as the card routes them (the fused kernels'
    autograd functions at batch 1, the flash ones at batch 2, their plain versions inside): a
    policy's recompute runs them again, and the loss and image gradient are ``none``'s bit for
    bit."""
    from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu

    with kernel_routes_on_cpu():
        want_loss, want_grad = _step("llava", "none", batch)
        loss, grad = _step("llava", policy, batch)
    assert torch.equal(loss, want_loss) and torch.equal(grad, want_grad)


def _named_width(t, policy):
    """The save set's width a token, as attack/setup.py::_policy_fits_hbm counts the dgrad family
    (q + k + gate + resid_mid; + v for dgrad_mid and dgrad; + up for dgrad), and the MLP inputs of
    gate_up and gate."""
    hd = t.head_dim_
    q_dim, kv_dim, inter = t.num_heads * hd, t.num_kv_heads * hd, t.intermediate_size
    if policy == "gate_up":
        return 2 * inter
    if policy == "gate":
        return inter
    width = q_dim + kv_dim + inter + t.hidden_size
    if policy in ("dgrad_mid", "dgrad"):
        width += kv_dim
    if policy == "dgrad":
        width += inter
    return width


@pytest.mark.parametrize("policy", ["dgrad", "dgrad_mid", "dgrad_lean", "gate_up", "gate"])
def test_layer_keeps_its_input_and_save_set(policy):
    """One tiny LLaVA decoder layer (batch 2, T 24, f32) under ``policy``: the outer
    ``saved_tensors_hooks`` see only the checkpoint's inputs (the layer input, and the bias, rope
    and mask all layers share), and what the checkpoint keeps besides is exactly the policy's named
    tensors, their bytes the width formula's, so the layer keeps its input and its save set; the
    plain layer's saves, counted with the same hooks, exceed that. The input gradient is the plain
    layer's, bit for bit."""
    from adversarialvlm_tpu_torch.models import llama
    from adversarialvlm_tpu_torch.models.configs import tiny_llava
    from adversarialvlm_tpu_torch.models.layers import causal_bias, rope_cos_sin

    t = tiny_llava(vocab_size=384).text
    p = llama.init_params(torch.Generator().manual_seed(0), t, torch.float32, "cpu")["layers"][0]
    weights = {w.data_ptr() for sub in p.values() for proj in (sub.values() if isinstance(sub, dict) else [sub])
               for w in (proj.values() if isinstance(proj, dict) else [proj]) if torch.is_tensor(w)}
    b, n = 2, 24
    mask = torch.ones((b, n), dtype=torch.int32)
    pos = torch.arange(n)[None].expand(b, n)
    bias = causal_bias(mask, pos, pos, None, None, None)
    cos, sin = rope_cos_sin(pos, t.head_dim_, t.rope_theta)
    x0 = torch.randn((b, n, t.hidden_size), generator=torch.Generator().manual_seed(1))
    dy = torch.randn((b, n, t.hidden_size), generator=torch.Generator().manual_seed(2))
    args = (t, bias, cos, sin, mask, None, None, "plain")

    def run(policy):
        x = x0.clone().requires_grad_(True)
        packed, record = [], []

        def pack(s):
            if s.data_ptr() not in weights:
                packed.append(s.numel() * s.element_size())
            return s

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda s: s):
            if policy is None:
                y = llama.decoder_layer(x, p, *args)
            else:
                y = remat.remat_call(policy, llama.decoder_layer, x, p, *args, record=record)
        (dx,) = torch.autograd.grad(y, x, dy)
        return dx, packed, record

    dx0, plain, _ = run(None)
    dx, packed, record = run(policy)
    assert torch.equal(dx, dx0)
    layer_input = x0.numel() * 4
    shared = [u.numel() * u.element_size() for u in (bias, cos, sin, mask)]
    assert sorted(packed) == sorted([layer_input, *shared])
    assert sorted(name for name, _ in record) == sorted(remat.SAVE_SETS[policy])
    kept = sum(nbytes for _, nbytes in record)
    assert kept == b * n * _named_width(t, policy) * 4
    assert kept + layer_input < sum(plain) - sum(shared)
