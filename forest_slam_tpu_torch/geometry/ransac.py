"""RANSAC as a static hypothesis batch (port of geometry/ransac.py).

The random numbers are arguments: callers draw them from a
``torch.Generator`` (:func:`gumbel_noise`), and tests hand the same numbers
to the JAX reference.
"""

from __future__ import annotations

import torch


def gumbel_noise(shape, generator: torch.Generator | None = None, device="cuda") -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def require_draws(generator: torch.Generator | None, gumbel, uniform) -> None:
    """Refuse a call whose draws would come from torch's global generator:
    it takes a seeded ``generator``, or both ``gumbel`` and ``uniform``."""
    if generator is None and (gumbel is None or uniform is None):
        raise ValueError("pass a seeded generator, or both gumbel and uniform draws")


def gumbel_per_item(n_items: int, shape, generator: torch.Generator, device="cuda") -> torch.Tensor:
    """(n_items, *shape) Gumbel draws, each item's drawn on its own in turn,
    so a batch of items holds the numbers a loop over them one at a time
    would draw from the same generator."""
    return torch.stack([gumbel_noise(tuple(shape), generator, device) for _ in range(n_items)])


def ransac_sample_indices(gumbel: torch.Tensor, valid: torch.Tensor, sample_size: int,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """(..., n_hypotheses, sample_size) distinct indices of valid points by
    Gumbel top-k over (..., n_hypotheses, N) noise; ``weights`` (..., N)
    bias the draw toward higher weights (weighted sampling without
    replacement)."""
    g = gumbel
    if weights is not None:
        g = g + torch.log(torch.clamp(weights, min=1e-9))[..., None, :]
    g = torch.where(valid[..., None, :], g, torch.full_like(g, float("-inf")))
    return torch.topk(g, sample_size, dim=-1).indices


def stable_topk(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest integer ``values`` along the last dim, ties
    to the lower index (jax.lax.top_k's order), on any device."""
    n = values.shape[-1]
    key = values.long() * n + (n - 1 - torch.arange(n, device=values.device))
    return torch.topk(key, k, dim=-1).indices
