"""Attack losses: pixel-range penalty and teacher-forced suffix cross-entropy.
Counterpart of adversarialvlm_tpu/ops/losses.py."""

from __future__ import annotations

import torch


def tanh_clamp(p: torch.Tensor, epsilon: float) -> torch.Tensor:
    """x = ε · tanh(p), the bounded perturbation parameterization."""
    return epsilon * torch.tanh(p)


def perturbation_clamp(p: torch.Tensor, epsilon: float, method: str = "tanh") -> torch.Tensor:
    """x(p) under --clamp_method: "tanh" (reference), "clamp" (box projection) or "none"."""
    if method == "tanh":
        return tanh_clamp(p, epsilon)
    if method == "clamp":
        return torch.clamp(p, -epsilon, epsilon)
    if method == "none":
        return p
    raise ValueError(f"unknown clamp_method: {method!r}")


def image_fit_loss(x_0: torch.Tensor, x: torch.Tensor, center_force: float = 0.9) -> torch.Tensor:
    """Mean squared hinge penalty keeping x₀+x inside [0, center_force]."""
    s = x_0 + x
    lower = torch.clamp(center_force * 0.0 - s, min=0.0)
    upper = torch.clamp(s - center_force * 1.0, min=0.0)
    return torch.mean(lower**2 + upper**2)


def suffix_cross_entropy(
    logits: torch.Tensor,
    target_tokens: torch.Tensor,
    suffix_length,
    shift,
    target_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """CE over the last ``suffix_length - shift`` positions against the target.

    logits: (B, T, V), already shifted (next-token logits). Without ``target_mask`` the slice
    is static, exactly as the reference takes it; with it, targets sit right-aligned in a
    fixed-width (B, S) buffer and only the masked slots in [S - suffix_length, S - shift) count.
    """
    b, t, v = logits.shape
    s = target_tokens.shape[1]
    if target_mask is None:
        sl, sh = int(suffix_length), int(shift)
        if s not in (sl, sl - sh):
            raise ValueError(
                f"static suffix_cross_entropy needs target width {sl} or {sl - sh}, got {s}; "
                "padded buffers must pass target_mask"
            )
        logit_suffix = logits[:, t - sl : t - sh, :].float()
        tgt = target_tokens[:, : sl - sh] if s != sl - sh else target_tokens
        logp = torch.log_softmax(logit_suffix, dim=-1)
        return -torch.gather(logp, -1, tgt[..., None].long())[..., 0].mean()

    pos = torch.arange(s, device=logits.device)
    scored = (pos >= (s - suffix_length)) & (pos < (s - shift))
    scored = scored & target_mask.bool()
    logp = torch.log_softmax(logits[:, t - s :, :].float(), dim=-1)
    # masked slots may hold ids outside the vocabulary: clip before the gather
    tgt = torch.clamp(target_tokens, 0, v - 1).long()
    picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
    scored_b = torch.broadcast_to(scored if scored.dim() > 1 else scored[None, :], picked.shape)
    denom = torch.clamp(scored_b.float().sum(), min=1.0)
    return -torch.where(scored_b, picked, 0.0).sum() / denom
