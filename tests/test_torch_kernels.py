"""The port's kernel modules against the JAX package's Pallas kernels, on the CPU.

Here the wrappers take their plain versions (the tensors lie on the CPU); the JAX side runs its
Pallas kernels in interpret mode, as tests/test_ops_pallas.py does. Inputs are made with numpy
from a seed and handed to both. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarialvlm_tpu.models import layers as jax_layers
from adversarialvlm_tpu.ops.pallas.fused_attention import fused_sdpa_bthd
from adversarialvlm_tpu.ops.pallas.matmul import dgrad_matmul
from adversarialvlm_tpu_torch.models import layers
from adversarialvlm_tpu_torch.ops.kernels import attention as A
from adversarialvlm_tpu_torch.ops.kernels import launch_counts, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.dgrad import LinearPdx, dgrad, dgrad_eligible
from adversarialvlm_tpu_torch.ops.kernels.flash import flash_bwd_dq, flash_fwd


def test_dgrad_plain_matches_pallas_interpret():
    """f32, T=130 rows, O=1152 (a ragged tail under the kernel's 1024-deep contraction tile),
    I=256. Tolerance 1e-4: both sum the same f32 products, in another order."""
    rng = np.random.default_rng(0)
    dy = rng.standard_normal((130, 1152)).astype(np.float32)
    w = (rng.standard_normal((1152, 256)) * 0.05).astype(np.float32)
    want = np.asarray(dgrad_matmul(jnp.asarray(dy), jnp.asarray(w)))
    reset_launches()
    got = dgrad(torch.from_numpy(dy), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert launch_counts()["dgrad"] == 0  # CPU tensors never launch the kernel


def test_linear_pdx_matches_jax_custom_vjp_and_refuses_weight_grads():
    """LinearPdx's forward and input gradient against the JAX linear with use_pallas_dgrad
    (the custom VJP of layers.py:329-349, kernel in interpret mode); asking LinearPdx for the
    weight's gradient raises instead of returning a silent zero."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    w = (rng.standard_normal((1152, 1024)) * 0.05).astype(np.float32)
    b = rng.standard_normal((1152,)).astype(np.float32)
    p = {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}

    def jax_loss(x_):
        return jnp.sum(jnp.sin(jax_layers.linear(x_, p)))

    jax_layers.use_pallas_dgrad(True)
    try:
        y_want = np.asarray(jax_layers.linear(jnp.asarray(x), p))
        g_want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    finally:
        jax_layers.use_pallas_dgrad(False)

    xt = torch.from_numpy(x).requires_grad_(True)
    y = LinearPdx.apply(xt, torch.from_numpy(w)) + torch.from_numpy(b)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), g_want, rtol=1e-4, atol=2e-4)

    wt = torch.from_numpy(w).requires_grad_(True)
    out = LinearPdx.apply(torch.from_numpy(x).requires_grad_(True), wt)
    with pytest.raises(RuntimeError, match="no weight gradient"):
        out.sum().backward()


@pytest.mark.parametrize("h,hkv", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_attention_plain_versions_match_fused_sdpa_bthd_interpret(h, hkv):
    """Forward, dq and dk/dv of the plain versions (through the FusedAttention Function on CPU
    tensors) against fused_sdpa_bthd in interpret mode: T=160 with a 20-token left pad, D=128,
    f32, every row (pad rows included: both attend pad keys at or before the row). Tolerance
    1e-4 abs: the same f32 math in another order."""
    t, d, pad = 160, 128, 20
    rng = np.random.default_rng(h * 10 + hkv)
    q = rng.standard_normal((1, t, h, d)).astype(np.float32)
    k = rng.standard_normal((1, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((1, t, hkv, d)).astype(np.float32)
    do = rng.standard_normal((1, t, h, d)).astype(np.float32)
    mask = np.ones((1, t), np.int32)
    mask[0, :pad] = 0
    scale = d**-0.5

    out, vjp = jax.vjp(
        lambda q_, k_, v_: fused_sdpa_bthd(q_, k_, v_, jnp.asarray(mask), scale, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    want = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    reset_launches()
    o = A.fused_attention(qt, kt, vt, torch.from_numpy(mask), scale)
    o.backward(torch.from_numpy(do))
    got = [o.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy()]
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-4, err_msg=name)
    assert launch_counts() == {name: 0 for name in launch_counts()}

    # the plain versions on explicit residuals: dq/δ, then dk/dv from that δ
    seg = torch.from_numpy(mask[0])
    q_, k_, v_, do_ = (torch.from_numpy(a) for a in (q, k, v, do))
    o2, lse = A.attention_plain(q_, k_, v_, seg, scale)
    dq, delta = A.attention_bwd_dq_plain(q_, k_, v_, seg, o2, lse, do_, scale)
    dk, dv = A.attention_bwd_dkdv_plain(q_, k_, v_, seg, lse, delta, do_, scale)
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), (o2, dq, dk, dv), want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4, atol=1e-4, err_msg=name)


def _route_case(case):
    if case == "cuda_batch2_takes_flash":
        assert A.attention_route("cuda", 2, 641, 32, 128, 1) == "flash"
        assert A.attention_route("cuda", 50, 704, 32, 128, 1, cache_index=0) == "flash"
        assert A.attention_route("cuda", 3, 301, 8, 256, 4) == "flash"
    elif case == "cuda_head_dim64_raises":
        with pytest.raises(NotImplementedError, match="flash_sdpa"):
            A.attention_route("cuda", 1, 577, 16, 64, 1)
    elif case == "cuda_head_dim64_batch2_raises":
        with pytest.raises(NotImplementedError, match="ROADMAP modules item 8"):
            A.attention_route("cuda", 2, 641, 16, 64, 1)
    elif case == "cuda_cached_decode_takes_plain":
        assert A.attention_route("cuda", 50, 1, 32, 128, 1, cache_index=704) == "plain"
        assert A.attention_route("cuda", 1, 1, 32, 128, 1, cache_index=641) == "plain"
        with pytest.raises(NotImplementedError, match="filled KV cache"):
            A.attention_route("cuda", 2, 5, 32, 128, 1, cache_index=704)
    elif case == "cuda_batch1_takes_kernel":
        assert A.attention_route("cuda", 1, 641, 32, 128, 1) == "fused"
        assert A.attention_route("cuda", 1, 200, 4, 256, 4) == "fused"
        assert A.attention_route("cuda", 1, 704, 32, 128, 1, cache_index=0) == "fused"
    elif case == "cpu_takes_plain":
        assert A.attention_route("cpu", 2, 641, 32, 128, 1) == "plain"
        assert A.attention_route("cpu", 1, 641, 32, 128, 1) == "plain"
    elif case == "dgrad_eligibility":
        assert dgrad_eligible(torch.empty(4096, 4096))
        assert dgrad_eligible(torch.empty(11008, 4096))
        assert not dgrad_eligible(torch.empty(32064, 4096))  # lm_head: 32064 % 128 != 0
        assert not dgrad_eligible(torch.empty(64, 32))
    elif case == "cpu_linear_stays_plain":
        x = torch.randn(3, 1024, requires_grad=True)
        y = layers.linear(x, {"weight": torch.randn(1024, 1024)})
        assert "LinearPdx" not in type(y.grad_fn).__name__
        reset_launches()
        dx = dgrad(torch.randn(3, 1024, dtype=torch.bfloat16), torch.randn(1024, 1024, dtype=torch.bfloat16))
        assert dx.dtype == torch.bfloat16 and launch_counts()["dgrad"] == 0
    elif case == "wrapper_rejects_non_cuda_device":
        with pytest.raises(ValueError, match="CUDA tensors"):
            A.attention_fwd(torch.empty(1, 8, 2, 128, device="meta"), torch.empty(1, 8, 2, 128),
                            torch.empty(1, 8, 2, 128), torch.ones(8, dtype=torch.int32), 0.1)
    elif case == "flash_wrapper_rejects_non_cuda_device":
        meta = torch.empty(2, 8, 2, 128, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_fwd(meta, meta, meta, torch.ones(2, 8, dtype=torch.int32, device="meta"), 0.1)
        with pytest.raises(ValueError, match="CUDA tensors"):
            flash_bwd_dq(meta, meta, meta, torch.ones(2, 8, dtype=torch.int32, device="meta"),
                         meta, torch.empty(2, 2, 8, device="meta"), meta, 0.1)
        reset_launches()
        cpu = torch.randn(2, 8, 2, 128)
        flash_fwd(cpu, cpu, cpu, torch.ones(2, 8, dtype=torch.int32), 0.1)  # CPU: the plain version
        assert launch_counts()["flash_fwd"] == 0
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "cuda_batch2_takes_flash", "cuda_head_dim64_raises", "cuda_batch1_takes_kernel",
    "cpu_takes_plain", "dgrad_eligibility", "cpu_linear_stays_plain",
    "wrapper_rejects_non_cuda_device", "cuda_head_dim64_batch2_raises",
    "cuda_cached_decode_takes_plain", "flash_wrapper_rejects_non_cuda_device",
])
def test_kernel_routing(case):
    """On the card the decoder attention takes the fused kernel at batch 1, the flash kernel at
    batch >= 2 and the plain sdpa only for a cached decode step, or raises (no fallback); CPU
    tensors take the plain versions and launch nothing."""
    _route_case(case)


def test_linear_pdx_backward_of_plain_linear_agree():
    """Through autograd on the CPU, LinearPdx's dx equals the plain linear's."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((384, 256)).astype(np.float32))
    x1 = x.clone().requires_grad_(True)
    x2 = x.clone().requires_grad_(True)
    (LinearPdx.apply(x1, w) ** 2).sum().backward()
    (F.linear(x2, w) ** 2).sum().backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-5, atol=1e-5)
