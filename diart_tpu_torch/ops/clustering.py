"""Incremental online speaker clustering as a fixed-shape op, batched over
streams (port of ``diart_tpu/ops/clustering.py``).

The JAX op is written for one stream and vmapped; here every tensor has a
leading stream axis. Where JAX branches with ``lax.cond`` on whether the
stream has seen its first chunk, both branches are computed for all streams
and selected with ``torch.where``. Everything stays on the device: no host
sync, no data-dependent Python control flow.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .assignment import assign_rows

__all__ = ["ClusteringParams", "ClusteringState", "cluster_step", "init_state"]

_BIG = 1e10


class ClusteringParams(NamedTuple):
    """tau_active / rho_update / delta_new: floats or 0-d tensors."""

    tau_active: object
    rho_update: object
    delta_new: object


class ClusteringState(NamedTuple):
    """centers (B, M, E) running sums; active (B, M) bool; initialized (B,)."""

    centers: torch.Tensor
    active: torch.Tensor
    initialized: torch.Tensor


def init_state(batch: int, max_speakers: int, dim: int, device="cpu") -> ClusteringState:
    return ClusteringState(
        centers=torch.zeros(batch, max_speakers, dim, device=device),
        active=torch.zeros(batch, max_speakers, dtype=torch.bool, device=device),
        initialized=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def _cosine_cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, K, E) x (B, M, E) -> (B, K, M), zero rows guarded (1e-30), in
    full f32 whatever the matmul precision settings."""
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-30)
    return 1.0 - (xn[:, :, None, :] * yn[:, None, :, :]).sum(-1)


def _onehot_rows(idx: torch.Tensor, num: int) -> torch.Tensor:
    """(..., K) int (-1 = none) -> (..., K, num) bool."""
    return idx[..., None] == torch.arange(num, device=idx.device)


def _scatter_rows(onehot: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """sum_k onehot[b, k, m] * emb[b, k, :] -> (B, M, E). Each centre
    receives at most one row here, so this is exact."""
    return (onehot.to(emb.dtype)[..., None] * emb[:, :, None, :]).sum(dim=1)


def cluster_step(
    state: ClusteringState,
    segmentation: torch.Tensor,
    embeddings: torch.Tensor,
    params: ClusteringParams,
) -> Tuple[ClusteringState, torch.Tensor, torch.Tensor]:
    """Advance every stream's clustering by one chunk.

    segmentation: (B, F, K) local activations; embeddings: (B, K, E).
    Returns ``(new_state, permuted (B, F, M), targets (B, K))`` with
    targets the global index per local speaker, -1 if unmapped.
    """
    num_local = segmentation.shape[-1]
    max_speakers = state.centers.shape[1]
    dev = segmentation.device
    slots = torch.arange(max_speakers, device=dev)

    active = segmentation.amax(dim=1) >= params.tau_active  # (B, K)
    long = segmentation.mean(dim=1) >= params.rho_update
    no_nan = ~torch.isnan(embeddings).any(dim=-1)
    active = active & no_nan
    emb = torch.nan_to_num(embeddings)

    # --- first chunk: every active speaker adopts a centroid ------------ #
    order = torch.cumsum(active.long(), dim=1) - 1
    tgt_init = torch.where(active & (order < max_speakers), order, -1)
    onehot = _onehot_rows(tgt_init, max_speakers) & active[..., None]
    centers_init = _scatter_rows(onehot, emb).to(state.centers.dtype)
    active_init = onehot.any(dim=1)

    # --- subsequent chunks ----------------------------------------------- #
    dist = _cosine_cdist(emb, state.centers)  # (B, K, M)
    col_ok = state.active
    row_ok = active
    cost = torch.where(row_ok[..., None] & col_ok[:, None, :], dist, _BIG)
    assigned = assign_rows(cost)
    assigned_cost = torch.gather(cost, 2, assigned[..., None])[..., 0]
    mapped = row_ok & col_ok.any(dim=1, keepdim=True)
    # the threshold is evaluated once, on the joint solve's costs; the
    # surviving rows then re-solve without the rows it invalidated
    valid = mapped & (assigned_cost < params.delta_new)
    missed = active & ~valid
    cost2 = torch.where(valid[..., None], cost, _BIG)
    assigned = assign_rows(cost2)

    free_slots = max_speakers - state.active.sum(dim=1)
    tgt = torch.where(valid, assigned, -1)
    taken = (_onehot_rows(tgt, max_speakers) & valid[..., None]).any(dim=1)  # (B, M)

    # sequential resolution of missed speakers (K is small and static)
    cols = list(tgt.unbind(dim=1))
    new_flags = []
    new_count = torch.zeros_like(free_slots)
    for k in range(num_local):
        is_missed = missed[:, k]
        make_new = is_missed & (new_count < free_slots) & long[:, k]
        new_flags.append(make_new)
        new_count = new_count + make_new.long()
        # fallback: the closest active centre not already taken
        pref = torch.where(col_ok & ~taken, cost[:, k], torch.inf)
        best = torch.argmin(pref, dim=1)
        best_cost = torch.gather(pref, 1, best[:, None])[:, 0]
        can_fallback = is_missed & ~make_new & (best_cost < _BIG)
        cols[k] = torch.where(can_fallback, best, cols[k])
        taken = taken | ((slots == best[:, None]) & can_fallback[:, None])

    # centroid updates: valid rows are never missed, so "not missed and
    # long" reduces to valid & long
    tgt = torch.stack(cols, dim=1)
    upd = _onehot_rows(tgt, max_speakers) & (valid & long)[..., None]
    centers = state.centers + _scatter_rows(upd, emb).to(state.centers.dtype)

    # new centres claim free slots in order
    center_active = state.active
    for k in range(num_local):
        make_new = new_flags[k]
        slot = torch.argmin(center_active.int(), dim=1)  # first free
        put = (slots == slot[:, None]) & make_new[:, None]  # (B, M)
        centers = torch.where(put[..., None], emb[:, k, None, :].to(centers.dtype), centers)
        cols[k] = torch.where(make_new, slot, cols[k])
        center_active = center_active | put
    tgt_norm = torch.stack(cols, dim=1)

    init = state.initialized
    new_state = ClusteringState(
        centers=torch.where(init[:, None, None], centers, centers_init),
        active=torch.where(init[:, None], center_active, active_init),
        initialized=torch.ones_like(init),
    )
    targets = torch.where(init[:, None], tgt_norm, tgt_init)

    # project local scores onto global columns
    proj = (_onehot_rows(targets, max_speakers) & (targets >= 0)[..., None]).to(
        segmentation.dtype
    )  # (B, K, M)
    permuted = (segmentation[..., None] * proj[:, None, :, :]).sum(dim=2)
    return new_state, permuted, targets
