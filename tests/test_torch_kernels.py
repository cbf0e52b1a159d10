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
from adversarialvlm_tpu.ops.pallas.attention import flash_sdpa as jax_flash_sdpa
from adversarialvlm_tpu.ops.pallas.attention import flash_sdpa_full as jax_flash_sdpa_full
from adversarialvlm_tpu.ops.pallas.fused_attention import fused_sdpa_bthd
from adversarialvlm_tpu.ops.pallas.matmul import dgrad_matmul
from adversarialvlm_tpu_torch.models import layers
from adversarialvlm_tpu_torch.ops.kernels import attention as A
from adversarialvlm_tpu_torch.ops.kernels.attention import kernel_routes_on_cpu
from adversarialvlm_tpu_torch.ops.kernels import count_launch, launch_counts, launch_counts_by_head_dim, reset_launches
from adversarialvlm_tpu_torch.ops.kernels.dgrad import LinearPdx, dgrad, dgrad_eligible
from adversarialvlm_tpu_torch.ops.kernels import flash as Fl
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


@pytest.mark.parametrize("h,hkv,d", [(2, 2, 128), (4, 2, 128), (4, 2, 256)], ids=["mha", "gqa", "gqa_d256"])
def test_attention_plain_versions_match_fused_sdpa_bthd_interpret(h, hkv, d):
    """Forward, dq and dk/dv of the plain versions (through the FusedAttention Function on CPU
    tensors) against fused_sdpa_bthd in interpret mode: T=160 with a 20-token left pad, D=128 or
    256 (Gemma-3's width), f32, every row (pad rows included: both attend pad keys at or before
    the row). Tolerance 1e-4 abs: the same f32 math in another order."""
    t, pad = 160, 20
    rng = np.random.default_rng(h * 10 + hkv + d)
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
    assert launch_counts_by_head_dim() == {}

    # the plain versions on explicit residuals: dq/δ, then dk/dv from that δ
    seg = torch.from_numpy(mask[0])
    q_, k_, v_, do_ = (torch.from_numpy(a) for a in (q, k, v, do))
    o2, lse = A.attention_plain(q_, k_, v_, seg, scale)
    dq, delta = A.attention_bwd_dq_plain(q_, k_, v_, seg, o2, lse, do_, scale)
    dk, dv = A.attention_bwd_dkdv_plain(q_, k_, v_, seg, lse, delta, do_, scale)
    for name, g_, w_ in zip(("o", "dq", "dk", "dv"), (o2, dq, dk, dv), want):
        np.testing.assert_allclose(g_.numpy(), w_, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def qkv_d256():
    """B=2, H=4, Hkv=2, T=160, D=256 (Gemma-3's head dim, GQA), row 0 left-padded by 20."""
    rng = np.random.default_rng(256)
    b, h, hkv, t, d = 2, 4, 2, 160, 256
    q, do = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, t, d), dtype=np.float32) for _ in range(2))
    mask = np.ones((b, t), np.int32)
    mask[0, :20] = 0
    return q, k, v, do, mask


def _real_rows(x, mask):
    """(B, H, T, D) -> the real rows' (N, H, D)."""
    return np.asarray(x).transpose(0, 2, 1, 3)[mask.astype(bool)]


def _repeat_kv(x, q):
    """(B, Hkv, T, D) -> (B, H, T, D): the JAX flash_sdpa takes k and v at q's heads, as the JAX
    decoder's repeat_kv hands them over."""
    return jnp.asarray(np.repeat(x, q.shape[1] // x.shape[1], axis=1))


@pytest.fixture(scope="module")
def qkv_d96():
    """B=2, H=Hkv=4, T=150, D=96 (Phi-3.5's head dim, MHA as its decoder), row 0 left-padded by 17."""
    rng = np.random.default_rng(96)
    b, h, t, d = 2, 4, 150, 96
    q, k, v, do = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(4))
    mask = np.ones((b, t), np.int32)
    mask[0, :17] = 0
    return q, k, v, do, mask


def test_flash_plain_at_head_dim_256_matches_flash_sdpa_interpret(qkv_d256):
    """The port's flash_sdpa on CPU tensors at head_dim 256 with GQA (its k and v at 2 kv heads)
    against the JAX flash_sdpa in interpret mode (k and v repeated to the 4 q heads), real rows,
    1e-4; the explicit plain forward gives the same o."""
    _flash_plain_case(qkv_d256)


def test_flash_plain_at_head_dim_96_matches_flash_sdpa_interpret(qkv_d96):
    """As at 256, at Phi-3.5's head_dim 96 (which the TPU kernel pads to 128 lanes and the card's
    kernels take as it is), 4 heads with left pads, real rows, 1e-4."""
    _flash_plain_case(qkv_d96)


def _flash_plain_case(qkv):
    q, k, v, _, mask = qkv
    scale = q.shape[-1]**-0.5
    want = jax_flash_sdpa(jnp.asarray(q), _repeat_kv(k, q), _repeat_kv(v, q), jnp.asarray(mask), scale,
                          interpret=True)
    reset_launches()
    got = Fl.flash_sdpa(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask), scale)
    assert got.shape == q.shape
    np.testing.assert_allclose(_real_rows(got, mask), _real_rows(want, mask), rtol=1e-4, atol=1e-4)
    q4, k4, v4 = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    o, _ = Fl.flash_plain(q4, k4, v4, torch.from_numpy(mask), scale)
    np.testing.assert_allclose(_real_rows(o.transpose(1, 2), mask), _real_rows(want, mask), rtol=1e-4, atol=1e-4)
    assert launch_counts()["flash_fwd"] == 0  # CPU tensors never launch the kernel


def test_flash_function_grads_at_head_dim_256_match_flash_sdpa_interpret(qkv_d256):
    """q/k/v gradients through the FlashAttention Function at head_dim 256 with GQA (the plain dq,
    which writes δ, then dk/dv, which sums each kv head's two q heads) against jax.vjp of
    flash_sdpa in interpret mode, whose k and v gradients at the repeated heads are summed per kv
    head; under a cotangent on the real rows, real rows, 1e-4."""
    _flash_grads_case(qkv_d256)


def test_flash_function_grads_at_head_dim_96_match_flash_sdpa_interpret(qkv_d96):
    """As at 256, at Phi-3.5's head_dim 96 (MHA): the plain dq, then dk/dv, against jax.vjp of
    flash_sdpa in interpret mode, real rows, 1e-4."""
    _flash_grads_case(qkv_d96)


def _flash_grads_case(qkv):
    q, k, v, do, mask = qkv
    scale = q.shape[-1]**-0.5
    real = mask.astype(bool)
    cot = do * real[:, None, :, None]
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda q_, k_, v_: jax_flash_sdpa(q_, k_, v_, jnp.asarray(mask), scale, interpret=True),
            jnp.asarray(q), _repeat_kv(k, q), _repeat_kv(v, q),
        )
        dq_w, dk_w, dv_w = (np.asarray(g) for g in vjp(jnp.asarray(cot)))
    b, hkv, t, d = k.shape
    dk_w, dv_w = (g.reshape(b, hkv, -1, t, d).sum(2) for g in (dk_w, dv_w))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    Fl.flash_sdpa(qt, kt, vt, torch.from_numpy(mask), scale).backward(torch.from_numpy(cot))
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), (dq_w, dk_w, dv_w)):
        np.testing.assert_allclose(_real_rows(g, mask), _real_rows(w, mask), rtol=1e-4, atol=1e-4,
                                   err_msg=f"grad {name}")


def _route_case(case):
    if case == "cuda_batch2_takes_flash":
        assert A.attention_route("cuda", 2, 641, 32, 128, 1) == "flash"
        assert A.attention_route("cuda", 50, 704, 32, 128, 1, cache_index=0) == "flash"
        assert A.attention_route("cuda", 3, 301, 8, 256, 4) == "flash"
    elif case == "cuda_phi3_head_dim96_takes_kernels":
        # Phi-3.5's decoder, 32 heads of 96: the attack step at batch 2 (T about 820), the cross
        # step at batch 1, the test decode's 50-row prefill
        assert Fl.HEAD_DIMS == (96, 128, 256)
        assert A.attention_route("cuda", 2, 820, 32, 96, 1) == "flash"
        assert A.attention_route("cuda", 1, 820, 32, 96, 1) == "fused"
        assert A.attention_route("cuda", 50, 790, 32, 96, 1, cache_index=0) == "flash"
        assert A.attention_route("cuda", 50, 1, 32, 96, 1, cache_index=854) == "plain"
    elif case == "cuda_head_dim64_raises":
        with pytest.raises(NotImplementedError, match="flash_sdpa"):
            A.attention_route("cuda", 1, 577, 16, 64, 1)
    elif case == "cuda_head_dim64_batch2_raises":
        with pytest.raises(NotImplementedError, match="ROADMAP modules: other victim families"):
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
    elif case == "cuda_masked_layer_takes_plain":
        # a sliding-window layer or gemma3's bidirectional image block: the plain bias + sdpa
        assert A.attention_route("cuda", 4, 360, 8, 256, 2, masked=True) == "plain"
        assert A.attention_route("cuda", 1, 360, 8, 256, 2, masked=True) == "plain"
        assert A.attention_route("cuda", 50, 384, 8, 256, 2, cache_index=0, masked=True) == "plain"
        assert A.attention_route("cuda", 2, 384, 8, 72, 2, masked=True) == "plain"  # no kernel, no raise
        assert A.attention_route("cuda", 4, 360, 8, 256, 2) == "flash"  # a global text-only layer
        with kernel_routes_on_cpu():
            assert A.attention_route("cpu", 4, 360, 8, 256, 2, masked=True) == "plain"
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
    "cuda_masked_layer_takes_plain", "cuda_phi3_head_dim96_takes_kernels",
])
def test_kernel_routing(case):
    """On the card the decoder attention takes the fused kernel at batch 1, the flash kernel at
    batch >= 2 and the plain sdpa only for a cached decode step or a masked (sliding-window or
    bidirectional-image) layer, or raises (no fallback); CPU tensors take the plain versions and
    launch nothing."""
    _route_case(case)


def _vit_route_case(case):
    if case == "cuda_siglip_takes_flash_full":
        assert A.vit_attention_route("cuda", 4096, 72) == "flash_full"
        assert A.vit_attention_route("cuda", 2048, 72) == "flash_full"
    elif case == "cuda_qwen2vl_tower_takes_flash_full":
        assert A.vit_attention_route("cuda", 4900, 80) == "flash_full"  # a 1024² source, 16 heads of 80
        assert A.vit_attention_route("cuda", 2116, 80) == "flash_full"
        assert A.vit_attention_route("cuda", 1296, 80) == "plain"  # a 512² source
    elif case == "cuda_clip_takes_plain":
        assert A.vit_attention_route("cuda", 577, 64) == "plain"
        assert A.vit_attention_route("cuda", 2047, 72) == "plain"
    elif case == "cuda_head_dim64_raises":
        with pytest.raises(NotImplementedError, match="ROADMAP modules: other victim families"):
            A.vit_attention_route("cuda", 4096, 64)
    elif case == "cpu_takes_plain_unless_kernel_routes":
        assert A.vit_attention_route("cpu", 4096, 72) == "plain"
        with kernel_routes_on_cpu():
            assert A.vit_attention_route("cpu", 4096, 64) == "flash_full"  # head dims unchecked
            assert A.vit_attention_route("cpu", 577, 64) == "plain"
    elif case == "flash_full_wrapper_rejects_other_devices_and_head_dims":
        meta = torch.empty(1, 8, 2, 72, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            Fl.flash_full_fwd(meta, meta, meta, 0.1)
        with pytest.raises(ValueError, match="ROADMAP modules: other victim families"):
            m64 = torch.empty(1, 8, 2, 64, device="meta")
            Fl.flash_full_fwd(m64, m64, m64, 0.1)
        reset_launches()
        cpu = torch.randn(1, 8, 2, 64)
        Fl.flash_full_fwd(cpu, cpu, cpu, 0.1)  # CPU: the plain version, any head dim
        assert launch_counts()["flash_full_fwd"] == 0
    elif case == "flash_full_wrapper_takes_head_dims_72_and_80":
        assert Fl.FULL_HEAD_DIMS == (72, 80)
        for d in (72, 80):  # past the head-dim check, a meta tensor fails only as not on the card
            meta = torch.empty(1, 8, 2, d, device="meta")
            with pytest.raises(ValueError, match="CUDA tensors"):
                Fl.flash_full_fwd(meta, meta, meta, 0.1)
            with pytest.raises(ValueError, match="CUDA tensors"):
                Fl.flash_full_bwd_dkdv(meta, meta, meta, meta[..., 0].transpose(1, 2),
                                       meta[..., 0].transpose(1, 2), meta, 0.1)
    else:
        raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "cuda_siglip_takes_flash_full", "cuda_clip_takes_plain", "cuda_head_dim64_raises",
    "cpu_takes_plain_unless_kernel_routes", "flash_full_wrapper_rejects_other_devices_and_head_dims",
    "cuda_qwen2vl_tower_takes_flash_full", "flash_full_wrapper_takes_head_dims_72_and_80",
])
def test_vit_route(case):
    """The vision tower's attention takes the non-causal flash_full kernels on the card from
    T = 2048 (clip_vit.py:22-30, qwen2vl.py:59-67) at head_dim 72 (SigLIP) and 80 (Qwen2-VL's
    tower), the plain sdpa below (the CLIP tower's 577, Qwen2-VL's 1296 patches at a 512² source),
    raises at any other head dim there (no fallback), and stays plain on the CPU."""
    _vit_route_case(case)


@pytest.mark.parametrize("d, want", [
    (96, ("causal_bwd", "causal_bwd_dq_bf16", "causal_bwd_dkdv_bf16")),
    (128, ("causal_bwd", "causal_bwd_dq_bf16", "causal_bwd_dkdv_bf16")),
    (256, ("causal_bwd", "causal_bwd_dq_bf16", "causal_bwd_dkdv_bf16")),
    (64, None), (72, None), (80, None), (512, None),
])
def test_causal_backward_dispatch_by_head_dim(d, want):
    """The causal backward's head-dim dispatch, read without building anything: D = 96 (Phi-3.5's
    decoder), D = 128 (the decoders' width) and D = 256 (Gemma-3's) go to the wgmma kernels of
    causal_bwd.cu, from the batch-1 wrappers and the batched ones alike; any other head dim raises. Both entries are bound
    in causal_bwd's argtypes table and instantiate D in their C dispatch; at 256 dk/dv is the
    kernel that splits the head dim over two warpgroups."""
    if want is None:
        with pytest.raises(ValueError, match="head_dim"):
            Fl.causal_bwd_entries(d)
        return
    assert Fl.causal_bwd_entries(d) == want
    library, dq_entry, dkdv_entry = want
    assert {dq_entry, dkdv_entry} <= set(Fl._CAUSAL_BWD_SIGNATURES)
    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC

    text = (CSRC / f"{library}.cu").read_text()
    for entry, fn in ((dq_entry, "dq"), (dkdv_entry, "dkdv")):
        body = text[text.index(f'extern "C" int {entry}('):].split("\n}\n", 1)[0]
        assert f"#define CALL(DD) {fn}<DD, CAUSAL_SEG>" in body and f"case {d}: return CALL({d});" in body, entry
    if d == 256:
        dkdv = text[text.index("\nint dkdv("):].split("\n}\n", 1)[0]
        assert "if constexpr (D > 128)" in dkdv and "causal_dkdv_split_kernel<D, MASK>" in dkdv


@pytest.mark.parametrize("d, want", [
    (96, ("causal_fwd", "causal_fwd_bf16")),
    (128, ("causal_fwd", "causal_fwd_bf16")),
    (256, ("causal_fwd", "causal_fwd_bf16")),
    (64, None), (72, None), (80, None), (512, None),
])
def test_causal_forward_dispatch_by_head_dim(d, want):
    """The causal forward's head-dim dispatch, read without building anything: D = 96, 128 and 256
    go to the wgmma kernel of causal_fwd.cu (at 96 the instantiation fused_sdpa's entry shares), from the batch-1 wrapper (B = 1) and the batched one
    alike; any other head dim raises. The entry is bound in causal_fwd's argtypes table and
    instantiates D in its C dispatch."""
    if want is None:
        with pytest.raises(ValueError, match="head_dim"):
            Fl.causal_fwd_entries(d)
        return
    assert Fl.causal_fwd_entries(d) == want
    library, entry = want
    assert entry in Fl._CAUSAL_FWD_SIGNATURES
    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC

    text = (CSRC / f"{library}.cu").read_text()
    body = text[text.index(f'extern "C" int {entry}('):].split("\n}\n", 1)[0]
    assert f"case {d}: return launch<{d}, CAUSAL_SEG>(" in body
    if d == 96:  # the same template instantiation as fused_sdpa's causal head-dim-96 case
        assert "case 96: return fused<96>(" in text and "return launch<D, CAUSAL_SEG>(" in text


def test_sources_are_the_four_wgmma_libraries():
    """build.SOURCES is the four wgmma/TMA libraries, one source each under csrc/; no source or
    header there includes <mma.h> or uses the WMMA API (the port's last WMMA kernels went with
    attention.cu), and every wgmma source names the wgmma instruction it runs."""
    import re

    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC, SOURCES, local_headers

    assert SOURCES == ("dgrad", "flash_full", "causal_fwd", "causal_bwd")
    assert sorted(p.stem for p in CSRC.glob("*.cu")) == sorted(SOURCES)
    for path in [*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]:
        text = path.read_text()
        assert not re.search(r"#include\s*<mma\.h>|\bwmma::|nvcuda", text), path.name
    for name in SOURCES:
        text = "".join((CSRC / h).read_text() for h in [f"{name}.cu", *local_headers(name)])
        assert "wgmma.mma_async" in text, name


SMEM_BYTES = 232_448     # shared memory a block may use on the H100
SM_SMEM_BYTES = 233_472  # shared memory of an SM, 1 KiB of it reserved for each block
MAX_REGISTERS = 255      # registers a thread may hold


def _causal_plan(d: int, t: int) -> dict[str, dict[str, int]]:
    """The causal kernels' plans at head dim ``d`` over rows of ``t`` tokens, a Python mirror of the C
    plans (``csrc/causal_fwd.cu``: ``WGS``, ``STAGES`` and, at 256, ``causal_fwd256_kernel``;
    ``csrc/causal_bwd.cu``: ``DqPlan`` and, at 256, ``causal_dkdv_split_kernel``), read without
    building anything: per kernel ("fwd", "dq", "dkdv") the warpgroups of a block, the blocks an SM
    holds, the query and key rows of its tiles, the K/V tiles it buffers, its shared memory in
    bytes (as the C ``*Smem`` structs count it, with the 1 KiB that aligns the 128-byte-swizzled
    tiles of head dim 256) and the f32 accumulator registers a thread holds (the output's and the
    scores'). At 256 a warpgroup's 64 × 256 f32 output is 128 registers a thread and a 64-row
    tile 32 KiB, which set every plan there."""
    n, wide = Fl.TILE, d > 128
    align = 1024 if wide else 0
    tiles = -(-t // n)  # the forward keeps each tile's segment interval (each half's at 256)

    def tile(rows):
        return rows * d * 2

    if wide:  # one warpgroup, one K and one V buffer loaded in turns, two blocks an SM
        fwd = dict(warpgroups=1, blocks_per_sm=2, query_rows=n, key_rows=n, kv_buffers=2,
                   smem_bytes=3 * tile(n) + n * 4 + 16 * tiles + align, acc_registers=d // 2 + n // 2)
    else:  # three warpgroups sharing a three-stage ring
        fwd = dict(warpgroups=3, blocks_per_sm=1, query_rows=3 * n, key_rows=n, kv_buffers=6,
                   smem_bytes=9 * tile(n) + 3 * n * 4 + 8 * tiles, acc_registers=d // 2 + n // 2)
    dq_wgs, bk = (2, 32) if wide else (1, 64)
    dq = dict(warpgroups=dq_wgs, blocks_per_sm=2 // dq_wgs, query_rows=n * dq_wgs, key_rows=bk, kv_buffers=4,
              smem_bytes=2 * dq_wgs * tile(n) + 4 * tile(bk) + 2 * bk * 4 + align, acc_registers=d // 2 + bk)
    rowvals = 3 * 2 * n * 4  # the ring's lse, δ and segment ids
    if wide:  # two warpgroups split the head dim; Pᵀ and dSᵀ meet in shared memory as bf16
        dkdv = dict(warpgroups=2, blocks_per_sm=1, query_rows=n, key_rows=n, kv_buffers=2,
                    smem_bytes=6 * tile(n) + 2 * n * n * 2 + rowvals + align, acc_registers=d // 2 + n // 2)
    else:
        dkdv = dict(warpgroups=1, blocks_per_sm=2, query_rows=n, key_rows=n, kv_buffers=2,
                    smem_bytes=6 * tile(n) + rowvals, acc_registers=d + n)
    return {"fwd": fwd, "dq": dq, "dkdv": dkdv}


@pytest.mark.parametrize("d", Fl.HEAD_DIMS)
def test_causal_plans_fit_the_card(d):
    """The causal kernels' plans at head dim d (96: Phi-3.5's decoder, 128, 256; _causal_plan, a
    Python mirror of the C plans), at the judge's T of 704 and at the forward's largest T (4096
    tiles of 64): each
    block's shared memory fits the 232,448 bytes a block may use on the H100, the blocks an SM
    holds fit its 228 KiB with 1 KiB reserved each (at 704), each thread's f32 accumulators (output
    and scores) fit the 255 registers a thread may hold and the SM's 65,536 with its blocks'. The
    mirror's shapes are the C sources': at 256 the forward runs one warpgroup with one K and one V
    buffer, two blocks an SM; dq two warpgroups over 32-row key tiles; dk/dv two warpgroups
    splitting the head dim."""
    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC

    for t in (704, 4096 * 64):
        for kernel, p in _causal_plan(d, t).items():
            assert p["smem_bytes"] <= SMEM_BYTES, (kernel, t, p)
            assert p["acc_registers"] <= MAX_REGISTERS, (kernel, p)
            threads = p["blocks_per_sm"] * p["warpgroups"] * 128
            assert threads * p["acc_registers"] <= 65_536, (kernel, p)
            if t == 704:
                assert p["blocks_per_sm"] * (p["smem_bytes"] + 1024) <= SM_SMEM_BYTES, (kernel, p)
    plan = _causal_plan(d, 704)
    fwd = (CSRC / "causal_fwd.cu").read_text()
    bwd = (CSRC / "causal_bwd.cu").read_text()
    assert "constexpr int WGS = 3, STAGES = 3;" in fwd
    assert "__launch_bounds__(128, 2)  // two blocks an SM" in fwd and "struct Fwd256Smem" in fwd
    assert "WGS = D > 128 ? 2 : 1, BK = D > 128 ? 32 : 64;" in bwd
    wide = d > 128
    assert (plan["fwd"]["warpgroups"], plan["fwd"]["blocks_per_sm"]) == ((1, 2) if wide else (3, 1))
    assert (plan["dq"]["warpgroups"], plan["dq"]["key_rows"]) == ((2, 32) if wide else (1, 64))
    assert plan["dkdv"]["warpgroups"] == (2 if wide else 1)
    if wide:  # what forces the plans at 256: one warpgroup's whole dK and dV would not fit
        assert 2 * (d // 2) > MAX_REGISTERS


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "segments"])
def test_causal_fwd_tile_walk_covers_every_allowed_pair(causal):
    """The forward kernel's tile walk (flash.causal_fwd_tiles: the causal limit, minus key tiles
    whose segment interval misses the query tile's) over random segment layouts: every allowed pair
    lies in a walked tile, so a skipped tile holds none, and a tile walked without the per-pair test
    holds only allowed pairs."""
    from hypothesis import given, settings
    from hypothesis import strategies as st

    runs = st.lists(st.tuples(st.integers(0, 3), st.integers(1, 90)), min_size=1, max_size=8)

    @settings(max_examples=60, deadline=None, derandomize=True, database=None)
    @given(runs)
    def check(layout):
        seg = torch.tensor([s for s, n in layout for _ in range(n)], dtype=torch.int32)
        t = seg.shape[0]
        allowed = Fl.allowed_pairs(seg[None], causal)[0]
        walk = Fl.causal_fwd_tiles(seg, causal)
        qi, kj = torch.nonzero(allowed, as_tuple=True)
        tiles = set(zip((qi // Fl.TILE).tolist(), (kj // Fl.TILE).tolist()))
        assert tiles <= set(walk), sorted(tiles - set(walk))
        for (qt, kt), masked in walk.items():
            if not masked:
                block = allowed[qt * Fl.TILE:(qt + 1) * Fl.TILE, kt * Fl.TILE:(kt + 1) * Fl.TILE]
                assert bool(block.all()) and (kt + 1) * Fl.TILE <= t, (qt, kt)

    check()


def test_bench_dgrad_shapes_are_the_steps_launches():
    """cli/bench_dgrad.py times the dgrad kernel at the shapes chip_smoke.py checks: per step the
    config's launches (364 at LLaVA-1.5-7B, batch 1 or 4; 346 at Gemma-3-4B), rows scaled by the
    batch (four CLIP images of 577 tokens, four SigLIP images of 4096 patches). The explicit-plan
    wrapper it times takes CUDA tensors only, and no plan of it runs on the CPU."""
    from adversarialvlm_tpu_torch.cli.bench_dgrad import step_shapes
    from adversarialvlm_tpu_torch.ops.kernels.dgrad import dgrad_with_plan

    sets = step_shapes(641, 677, 360)
    assert {k: sum(n for *_, n in v) for k, v in sets.items()} == {
        "llava batch 1": 364, "llava batch 4": 364, "gemma3 batch 4": 346}
    assert (641, 11008, 4096, 64) in sets["llava batch 1"]
    assert (4 * 677, 4096, 11008, 32) in sets["llava batch 4"]
    assert (4 * 577, 1024, 1024, 92) in sets["llava batch 4"]
    assert (4 * 4096, 1152, 1152, 108) in sets["gemma3 batch 4"]
    assert all(dgrad_eligible(torch.empty(o, i)) for shapes in sets.values() for _, o, i, _ in shapes)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dgrad_with_plan(torch.randn(4, 64, dtype=torch.bfloat16), torch.randn(64, 8, dtype=torch.bfloat16), 1, 1)


@pytest.fixture(scope="module")
def full_qkv():
    """B=2, H=3, T=150, D=24 (a ragged T and a head dim under any lane width), as
    tests/test_ops_pallas.py::test_flash_full_forward_and_grads_match_sdpa."""
    rng = np.random.default_rng(0)
    return [rng.standard_normal((2, 3, 150, 24), dtype=np.float32) for _ in range(4)]


def test_flash_full_plain_forward_matches_flash_sdpa_full_interpret(full_qkv):
    """The port's flash_sdpa_full on CPU tensors (the plain forward) against the JAX
    flash_sdpa_full in interpret mode, 2e-5; the explicit plain forward gives the same o and a
    logsumexp equal to log Σ exp of the scaled scores."""
    q, k, v, _ = full_qkv
    scale = 24**-0.5
    want = np.asarray(jax_flash_sdpa_full(*(jnp.asarray(a) for a in (q, k, v)), scale, interpret=True))
    reset_launches()
    got = Fl.flash_sdpa_full(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    q4, k4, v4 = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    o, lse = Fl.flash_full_plain(q4, k4, v4, scale)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), want, rtol=2e-5, atol=2e-5)
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) * scale
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-5, atol=1e-5)
    assert launch_counts()["flash_full_fwd"] == 0  # CPU tensors never launch the kernel


def test_flash_full_function_grads_match_flash_sdpa_full_interpret(full_qkv):
    """q/k/v gradients through the FlashFullAttention Function (the plain dq, which writes δ,
    then dk/dv) against jax.vjp of flash_sdpa_full in interpret mode, 5e-5
    (test_flash_full_forward_and_grads_match_sdpa)."""
    q, k, v, do = full_qkv
    scale = 24**-0.5
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_sdpa_full(q_, k_, v_, scale, interpret=True),
                         *(jnp.asarray(a) for a in (q, k, v)))
        want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    Fl.flash_sdpa_full(qt, kt, vt, scale).backward(torch.from_numpy(do))
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-5, atol=5e-5, err_msg=f"grad {name}")


def _c_entries(source: str) -> dict[str, list]:
    """{entry: ctypes argtypes} read from the ``extern "C"`` declarations of ``csrc/<source>.cu``:
    every pointer (``void*``, ``const long long*``) is c_void_p, ``int`` c_int, ``float`` c_float."""
    import ctypes
    import re

    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC

    text = (CSRC / f"{source}.cu").read_text()
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for param in params.split(","):
            decl = param.rsplit(None, 1)[0] if "*" not in param else "*"
            types.append(ctypes.c_void_p if "*" in decl else {"int": ctypes.c_int, "float": ctypes.c_float}[decl.strip()])
        entries[name] = types
    return entries


@pytest.mark.parametrize("source", ["dgrad", "flash_full", "causal_fwd", "causal_bwd"])
def test_signature_tables_match_the_c_entries(source):
    """Each library of build.SOURCES is bound entry for entry: the wrappers' argtypes tables (read
    without building or loading anything) name every ``extern "C"`` entry of the source and no
    other, with c_void_p for every pointer and the stream (a pointer passed as a 32-bit int is
    cut) and the C types of the rest. flash_full's entries live in their own source, the causal
    forward's and backward's (head_dim 128 and 256) and fused_sdpa's in theirs; no entry is named
    twice, in one source or across sources."""
    import re

    from adversarialvlm_tpu_torch.ops.kernels import dgrad as Dg
    from adversarialvlm_tpu_torch.ops.kernels import fused as Fu
    from adversarialvlm_tpu_torch.ops.kernels.build import CSRC, SOURCES

    tables = {
        "dgrad": [Dg._SIGNATURES],
        "flash_full": [Fl._FULL_SIGNATURES],
        "causal_fwd": [Fl._CAUSAL_FWD_SIGNATURES, Fu._FWD_SIGNATURES],
        "causal_bwd": [Fl._CAUSAL_BWD_SIGNATURES, Fu._BWD_SIGNATURES],
    }[source]
    bound = {name: argtypes for table in tables for name, argtypes in table.items()}
    assert source in SOURCES
    c = _c_entries(source)
    assert sorted(c) == sorted(bound)
    for name, argtypes in bound.items():
        assert argtypes == c[name], name
    if source == "flash_full":
        assert sorted(c) == ["flash_full_bwd_dkdv_bf16", "flash_full_bwd_dq_bf16", "flash_full_fwd_bf16"]
    if source == "causal_fwd":
        assert sorted(c) == ["causal_fwd_bf16", "fused_fwd_bf16"]
    if source == "causal_bwd":
        assert sorted(c) == ["causal_bwd_dkdv_bf16", "causal_bwd_dq_bf16", "fused_bwd_dkdv_bf16",
                             "fused_bwd_dq_bf16"]
    named = {src: re.findall(r'extern "C" int (\w+)\(', (CSRC / f"{src}.cu").read_text()) for src in SOURCES}
    assert len(named[source]) == len(set(named[source])), named[source]
    others = {n for src, names in named.items() if src != source for n in names}
    assert not others & set(named[source])


@pytest.mark.parametrize("source, headers", [
    ("dgrad", []), ("flash_full", []),
    ("causal_fwd", ["attention_sm90.cuh"]), ("causal_bwd", ["attention_sm90.cuh"]),
], ids=["dgrad-headers0", "flash_full-headers2", "causal_fwd-headers3", "causal_bwd-headers4"])  # fixed test names
def test_library_hash_covers_the_included_headers_only(source, headers, tmp_path, monkeypatch):
    """A library's file name hashes its source and the csrc headers it includes, and no other
    header: editing attention_sm90.cuh renames the two wgmma attention libraries that include it
    (so neither loads stale), and leaves the other two as they were (no needless rebuild). Read on a
    copy of csrc/, without building anything."""
    import shutil

    from adversarialvlm_tpu_torch.ops.kernels import build

    assert build.local_headers(source) == headers
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path(source)
    (csrc / "attention_sm90.cuh").write_text((csrc / "attention_sm90.cuh").read_text() + "\n// edited\n")
    (csrc / "unused.cuh").write_text("// a header no source includes\n")
    assert (build.library_path(source) != before) == bool(headers)


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


def test_launches_are_split_by_head_dim():
    """An attention wrapper's launch counts once under its entry and once under its head dim, so a
    run that mixes head dims (the int8 LLaVA + Phi-3.5 cross step: 128 and 96 on the same batch-1
    entries) shows each instantiation's share; a reset clears both."""
    reset_launches()
    for d in (96, 128, 96):
        count_launch("attention_fwd", d)
    count_launch("flash_full_fwd", 80)
    assert launch_counts()["attention_fwd"] == 3 and launch_counts()["flash_full_fwd"] == 1
    assert launch_counts_by_head_dim() == {"attention_fwd_d96": 2, "attention_fwd_d128": 1, "flash_full_fwd_d80": 1}
    reset_launches()
    assert sum(launch_counts().values()) == 0 and launch_counts_by_head_dim() == {}
