"""The port's fused_sdpa (ops/kernels/fused.py) against the JAX package's Pallas fused_sdpa, on the
CPU, and its A/B harness.

Here the wrappers take their plain versions (the tensors lie on the CPU); the JAX side runs its
Pallas kernels in interpret mode under each ADVLM_FUSED_VARIANT, as tests/test_ops_pallas.py does.
Inputs are made with numpy from a seed and handed to both. The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarialvlm_tpu.ops.pallas import fused_attention as jax_fused
from adversarialvlm_tpu_torch.cli import bench_fused_attention
from adversarialvlm_tpu_torch.ops.kernels import fused as Fu
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches

CASES = {
    "causal_130x64": (1, 2, 130, 64, True, 0),
    "causal_150x96_pads": (1, 2, 150, 96, True, 13),
    "noncausal_150x32": (1, 2, 150, 32, False, 0),
    "noncausal_b2_140x64_pads": (2, 2, 140, 64, False, 11),
}


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_sdpa_matches_pallas_interpret(case, variant, monkeypatch):
    """Forward on real rows and dq/dk/dv everywhere (pad rows' dO zeroed, so every gradient is
    defined by real rows, as in test_fused_sdpa_matches_reference), f32, against the Pallas
    fused_sdpa in interpret mode under each kernel variant: 5e-6, the JAX test's f32 tolerance
    (the same f32 softmax, summed in another order). The JAX entry pads T and D to 128 with
    segment 0; the port pads nothing, so pad rows' forward values may differ and are excluded.
    A second batch row (the last case) has its own pads."""
    monkeypatch.setenv("ADVLM_FUSED_VARIANT", str(variant))
    b, h, t, d, causal, pad = CASES[case]
    rng = np.random.default_rng(t + d)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[:, :pad] = 0
    if b > 1:
        mask[1, : pad + 7] = 0
    real = mask[:, None, :, None].astype(bool)
    do = do * real
    scale = d**-0.5

    out, vjp = jax.vjp(lambda q_, k_, v_: jax_fused.fused_sdpa(
        q_, k_, v_, jnp.asarray(mask), scale, causal, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    reset_launches()
    o = Fu.fused_sdpa(qt, kt, vt, torch.from_numpy(mask), scale, causal)
    o.backward(torch.from_numpy(do))
    assert all(n == 0 for n in launch_counts().values())  # CPU tensors never launch a kernel
    got = [o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()]
    np.testing.assert_allclose(np.where(real, got[0], 0.0), np.where(real, want[0], 0.0),
                               rtol=5e-6, atol=5e-6, err_msg="o")
    for name, g_, w_ in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g_, w_, rtol=5e-6, atol=5e-6, err_msg=name)


def test_fused_plain_residuals_and_bf16():
    """The plain versions on explicit residuals: dq and δ, then dk/dv from that δ, equal the
    Function's gradients (1e-6, f32), the logsumexp is log Σ exp of the allowed scaled scores,
    and bf16 inputs give bf16 outputs within 2e-2 of f32 (bf16 operands and outputs)."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 3, 40, 32)).astype(np.float32))
                   for _ in range(4))
    seg = torch.ones((1, 40), dtype=torch.int32)
    seg[0, :6] = 0
    o, lse = Fu.fused_plain(q, k, v, seg, 0.3, True)
    dq, delta = Fu.fused_bwd_dq_plain(q, k, v, seg, o, lse, do, 0.3, True)
    dk, dv = Fu.fused_bwd_dkdv_plain(q, k, v, seg, lse, delta, do, 0.3, True)
    qt, kt, vt = (x.clone().requires_grad_(True) for x in (q, k, v))
    Fu.fused_sdpa(qt, kt, vt, seg, 0.3, True).backward(do)
    for name, a, b in (("dq", dq, qt.grad), ("dk", dk, kt.grad), ("dv", dv, vt.grad)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
    s = (q @ k.transpose(-1, -2)) * 0.3
    s = s.masked_fill(~Fu.allowed_pairs(seg, True)[:, None], float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)
    ob, _ = Fu.fused_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), seg, 0.3, True)
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(), o.numpy(), rtol=2e-2, atol=2e-2)


def test_fused_eligible_matches_jax():
    """fused_eligible on the four cases of test_fused_sdpa_noncausal_and_eligibility, and around
    its edges, against the JAX function."""
    for b, t, d in ((1, 610, 128), (1, 1024, 96), (1, 1025, 128), (1, 640, 384), (2, 896, 256),
                    (1, 1, 1), (1, 1000, 257)):
        assert Fu.fused_eligible(b, t, d) == jax_fused.fused_eligible(b, t, d), (b, t, d)
    assert Fu.fused_eligible(1, 610, 128) and not Fu.fused_eligible(1, 1025, 128)


def test_fused_wrappers_on_the_card_refuse_what_the_kernels_do_not_take():
    """A CUDA-bound call checks before it builds or launches anything: operands off the card,
    float32 (the card takes bf16 only) and head dims outside the instantiated set raise a
    ValueError naming what is taken; there is no fallback to the plain version."""
    meta = torch.empty(1, 2, 8, 64, device="meta", dtype=torch.bfloat16)
    seg = torch.ones(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        Fu.fused_fwd(meta, meta, meta, seg, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        Fu.fused_bwd_dq(meta, meta, meta, seg, meta, torch.empty(1, 2, 8, device="meta"), meta, 0.1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        Fu.fused_bwd_dkdv(meta, meta, meta, seg, torch.empty(1, 2, 8), torch.empty(1, 2, 8), meta, 0.1)
    reset_launches()
    cpu = torch.randn(1, 2, 8, 48)  # any head dim and f32 on the CPU: the plain version
    o, lse = Fu.fused_fwd(cpu, cpu, cpu, torch.ones(1, 8, dtype=torch.int32), 0.1)
    assert o.shape == cpu.shape and lse.shape == (1, 2, 8) and launch_counts()["fused_fwd"] == 0


def test_fused_head_dims_and_dtype_checks(monkeypatch):
    """The card-side checks themselves, reached with CPU tensors posing as CUDA ones: f32 raises
    naming bfloat16, head_dims 48 and 256 raise naming the instantiated set, no kernel launches,
    and an operand read with another's strides is read in place only when it starts on a 16-byte
    boundary (the kernels load 16 bytes at a time), else copied."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    seg = torch.ones(1, 8, dtype=torch.int32)
    x32 = torch.randn(1, 2, 8, 64)
    x48 = torch.randn(1, 2, 8, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        Fu._operand("fused_fwd", x32)
    with pytest.raises(ValueError, match=r"head_dim in \(32, 64, 96, 128\)"):
        Fu._shapes("fused_fwd", x48, x48, seg)
    x256 = torch.randn(1, 2, 8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head_dim in \(32, 64, 96, 128\)"):
        Fu._shapes("fused_fwd", x256, x256, seg)
    view = torch.randn(1, 8, 2, 64).to(torch.bfloat16).transpose(1, 2)  # (B, H, T, D) of (B, T, H, D)
    assert Fu._operand("fused_fwd", view) is view  # read in place
    assert tuple(Fu._strides(view)) == (8 * 2 * 64, 2 * 64, 64)  # batch, row, head
    like = torch.randn(1, 2, 8, 64).to(torch.bfloat16)
    assert Fu._operand("fused_fwd", like.clone(), like=like).data_ptr() % 16 == 0
    same = torch.randn(1, 2, 8, 64).to(torch.bfloat16)
    assert Fu._operand("fused_fwd", same, like=like) is same  # like's strides, aligned: in place
    shifted = torch.randn(2 * 8 * 64 + 1).to(torch.bfloat16)[1:].view(1, 2, 8, 64)
    assert shifted.stride() == like.stride() and shifted.data_ptr() % 16 != 0
    moved = Fu._operand("fused_fwd", shifted, like=like)  # like's strides, misaligned: a copy
    assert moved.data_ptr() % 16 == 0 and moved.stride() == like.stride() and torch.equal(moved, shifted)


@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_fused_entries_are_bound_in_the_wgmma_sources(d):
    """fused.py binds its three entries in causal_fwd.cu (forward) and causal_bwd.cu (dq, dk/dv),
    each in its library's argtypes table, and each entry's dispatch instantiates head_dim d in both
    mask modes; no other source holds a fused entry."""
    import re

    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC, SOURCES

    assert d in Fu.HEAD_DIMS
    assert Fu.ENTRIES == {"fwd": ("causal_fwd", "fused_fwd_bf16"), "dq": ("causal_bwd", "fused_bwd_dq_bf16"),
                          "dkdv": ("causal_bwd", "fused_bwd_dkdv_bf16")}
    for library, entry in Fu.ENTRIES.values():
        assert library in SOURCES
        table = Fu._FWD_SIGNATURES if library == "causal_fwd" else Fu._BWD_SIGNATURES
        assert entry in table
        text = (CSRC / f"{library}.cu").read_text()
        assert f'extern "C" int {entry}(' in text
        body = text[text.index(f'extern "C" int {entry}('):].split("\n}\n", 1)[0]
        if library == "causal_fwd":
            assert re.search(rf"case {d}: return fused<{d}>", body)
        else:
            assert "FUSED_DISPATCH(CALL)" in body
            assert re.search(rf"case {d}: return causal \? CALL\({d}, CAUSAL_SEG\) : CALL\({d}, SEG\)", text)
    for source in set(SOURCES) - {"causal_fwd", "causal_bwd"}:
        assert 'extern "C" int fused' not in (CSRC / f"{source}.cu").read_text(), source


def test_bench_harness_runs_both_paths_on_the_cpu(capsys):
    """The harness at a tiny shape on the CPU: both paths reach the same chained losses (1e-4
    relative: the same f32 math in another order), the fused path launches no kernel on CPU
    tensors, and without a card the default device raises."""
    out = bench_fused_attention.run(T=48, H=2, D=32, reps=2, windows=1, device="cpu")
    np.testing.assert_allclose(out["fused_check"], out["plain_check"], rtol=1e-4)
    assert out["fused_launches"] == {} and out["device"] == "cpu"
    assert "fused/plain time ratio" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_fused_attention.main(["48", "2", "32", "1", "1"])
