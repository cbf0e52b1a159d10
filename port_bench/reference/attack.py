"""The attack step in plain float32, written from the attack's description (attack_model.py of the
attack repository and PyTorch's AdamW): x = ε·tanh(p); the image x₀ + x preprocessed; each row's
copy plus EoT noise of the current σ; the mean cross-entropy of the target suffix of every row plus
the squared-hinge range penalty of x₀ + x in [0, 0.9]; its gradient w.r.t. p; AdamW (β 0.9 and
0.999, eps 1e-8, weight decay 0.01); σ for the next step the unbiased standard deviation of the
uint8 round-trip error |⌊clamp(x₀ + x, 0, 1)·255⌋/255 − (x₀ + x)| of the image before the update.

The first step's gradient is taken row by row: each row's gradient of its own loss, whose mean is
the batch's gradient (every row scores the same number of tokens), so the check can see which rows
a step's gradient counts."""

from __future__ import annotations

import torch

from port_bench.reference import common as C


def _suffix_loss(fam, c, w, image, rows, lengths, noise, sigma, hw, scored) -> torch.Tensor:
    """Mean CE of the target's tokens over the ``scored`` window of every row on ``image`` with
    each row's noise. ``scored`` = (a, b, tokens): the tokens (b - a of them) of the target as it
    encodes alone, predicted at the positions before [T - a, T - b)."""
    start, stop, tokens = scored
    t = rows.shape[1]
    pix = fam.preprocess(c, image)
    pix = pix[None] + noise * sigma
    at = torch.arange(t - start - 1, t - stop - 1, device=rows.device)
    logits = fam.logits(c, w, rows, lengths, pix, hw, at)
    return C.suffix_ce(logits, tokens[None].expand(rows.shape[0], -1))


def run(fam, c: dict, w: dict, x0: torch.Tensor, feed: list, noise_gen: torch.Generator, *, lr: float,
        epsilon: float, sigma: float, scored) -> dict:
    """The reference's readings of the steps of ``feed`` (each {"rows", "lens"} on the device) from
    p = 0: {"loss": [each step's loss], "grad": the first step's gradient, "grad_norm": its norm,
    "change_norm": the norm of p after the last step, "rows_grad": each row's gradient of the first
    step (B, *p.shape)}. ``noise_gen`` draws each step's noise of the rows' pixels'
    shape, in the order the program draws it. ``scored`` = (a, b, tokens): the target window's
    offsets from the end of the rows and the target's tokens there."""
    C.exact_float32()
    p = torch.zeros_like(x0)
    m, v = torch.zeros_like(x0), torch.zeros_like(x0)
    b1, b2, eps_adam, wd = 0.9, 0.999, 1e-8, 0.01
    hw = tuple(x0.shape[-2:])
    out = {"loss": []}
    for k, xs in enumerate(feed, start=1):
        rows, lens = xs["rows"], xs["lens"]
        pq = p.detach().requires_grad_(True)
        x = epsilon * torch.tanh(pq)
        arg = x0 + x
        penalty = (arg.neg().clamp(min=0) ** 2 + (arg - 0.9).clamp(min=0) ** 2).mean()
        with torch.no_grad():
            shape = fam.preprocess(c, x0).shape
        noise = torch.randn((rows.shape[0], *shape), generator=noise_gen, device=x0.device)
        if k == 1:
            losses, grads = [], []
            for r in range(rows.shape[0]):
                row = slice(r, r + 1)
                loss = _suffix_loss(fam, c, w, arg, rows[row], lens[row], noise[row], sigma, hw, scored) + penalty
                (g,) = torch.autograd.grad(loss, pq, retain_graph=r + 1 < rows.shape[0])
                losses.append(float(loss.detach()))
                grads.append(g.detach())
            out["rows_grad"] = torch.stack(grads)
            g = out["rows_grad"].mean(0)
            out["loss"].append(sum(losses) / len(losses))
            out["grad"] = g
            out["grad_norm"] = float(torch.linalg.vector_norm(g))
        else:
            loss = _suffix_loss(fam, c, w, arg, rows, lens, noise, sigma, hw, scored) + penalty
            (g,) = torch.autograd.grad(loss, pq)
            out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            p = p * (1 - lr * wd)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            denom = (v / (1 - b2 ** k)).sqrt() + eps_adam
            p = p - lr * (m / (1 - b1 ** k)) / denom
            x_mod = x0 + x.detach()
            err = (torch.floor(x_mod.clamp(0, 1) * 255.0) / 255.0 - x_mod).abs()
            sigma = err.std()
    out["change_norm"] = float(torch.linalg.vector_norm(p))
    return out

