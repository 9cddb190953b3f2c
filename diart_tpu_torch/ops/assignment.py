"""Exact minimum-cost row assignment, batched over streams, on device.

Port of ``diart_tpu/ops/assignment.py``. For R rows (local speakers, <= 6)
and C >= R columns, an optimal assignment exists in which every row takes
one of its R cheapest columns, so enumerating the R**R combinations of
per-row candidate ranks (masking those that reuse a column) is exact.

Gather-free, as the JAX version: candidates come from iterative masked
argmin -> one-hot, combinations from a constant rank table, and the winner
is contracted back out of its one-hot. Selection is done by elementwise
products and sums with a single nonzero term, so every picked cost is
exact whatever the matmul precision settings. Ties break to the lowest
index at every stage, as ``jnp.argmin`` does.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["assign_rows", "assign_rows_host"]

_INVALID_THRESHOLD = 1e9


@lru_cache(maxsize=None)
def _rank_combinations(num_rows: int) -> np.ndarray:
    """All ``num_rows**num_rows`` tuples of per-row candidate ranks, in the
    JAX package's (meshgrid "ij") order."""
    return np.asarray(list(itertools.product(range(num_rows), repeat=num_rows)), np.int64)


@lru_cache(maxsize=None)
def _combinations_on(num_rows: int, device: torch.device) -> torch.Tensor:
    """:func:`_rank_combinations` on ``device``, copied there once: a copy
    from host memory each call would make the step wait for the card."""
    return torch.as_tensor(_rank_combinations(num_rows), device=device)


def assign_rows(cost: torch.Tensor) -> torch.Tensor:
    """cost: (..., R, C) with R <= C -> (..., R) int64 column per row;
    equal to ``scipy.optimize.linear_sum_assignment(cost)[1]`` per matrix."""
    num_rows, num_cols = cost.shape[-2:]
    if num_rows > num_cols:
        raise ValueError(f"need rows <= cols, got {tuple(cost.shape)}")
    if num_rows > 6:
        raise ValueError(
            f"assign_rows ranks R^R candidate assignments and is meant for "
            f"R <= 6 rows; got R = {num_rows}"
        )
    if num_rows == 1:
        return torch.argmin(cost, dim=-1)

    cost_f = cost.float()
    work = cost_f
    cand = []
    for _ in range(num_rows):
        oh = F.one_hot(torch.argmin(work, dim=-1), num_cols).to(cost_f.dtype)
        cand.append(oh)
        work = torch.where(oh > 0, torch.inf, work)
    cand_oh = torch.stack(cand, dim=-2)  # (..., R, K, C)

    combos = _combinations_on(num_rows, cost.device)  # (N, R)
    rows = torch.arange(num_rows, device=cost.device)
    sel = cand_oh[..., rows[None, :], combos, :]  # (..., N, R, C) 0/1

    valid = sel.sum(dim=-2).amax(dim=-1) <= 1.5  # (..., N)
    picked = (sel * cost_f[..., None, :, :]).sum(dim=-1)  # (..., N, R), exact
    is_invalid = picked >= _INVALID_THRESHOLD
    real_total = torch.where(is_invalid, 0.0, picked).sum(dim=-1)
    inv_count = is_invalid.sum(dim=-1).to(cost_f.dtype)
    finite = torch.where(cost_f >= _INVALID_THRESHOLD, 0.0, cost_f.abs())
    weight = 2.0 * num_rows * torch.clamp(finite.flatten(-2).amax(dim=-1), min=1.0) + 1.0
    totals = torch.where(valid, inv_count * weight[..., None] + real_total, torch.inf)
    best_oh = F.one_hot(torch.argmin(totals, dim=-1), sel.shape[-3]).to(cost_f.dtype)
    sel_best = (best_oh[..., :, None, None] * sel).sum(dim=-3)  # (..., R, C)
    return torch.argmax(sel_best, dim=-1)


def assign_rows_host(cost: np.ndarray) -> np.ndarray:
    """Host reference using scipy."""
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(np.asarray(cost))[1]
