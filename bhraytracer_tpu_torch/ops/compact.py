"""Wavefront compaction (the port of bhraytracer_tpu/ops/compact.py).

Slot order decides which lanes keep their RNG streams and which are
dropped, so `partition_indices` reproduces the stable candidates-first
order exactly (``argsort(~mask, stable=True)[:k]``). `inverse_permutation`
undoes the coherence sort of the grouped-stream traces (ops/trace.py).
`lookup_rows` is the row lookup of the tables a render differentiates.
"""

from __future__ import annotations

import torch


def partition_indices(mask: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """(k,) int64 indices of the stable partition that puts `mask` lanes
    first, each group in its original order, truncated to k (default n)."""
    n = mask.shape[0]
    k = n if k is None else k
    m = mask.to(torch.int64)
    c_true = torch.cumsum(m, 0)
    n_true = c_true[-1:] if n else c_true
    pos = torch.where(mask, c_true - 1, n_true + torch.cumsum(1 - m, 0) - 1)
    out = torch.empty(n, dtype=torch.int64, device=mask.device)
    out[pos] = torch.arange(n, device=mask.device)
    return out[:k]


def lookup_rows(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] for an integer index tensor of any shape (lookup_rows,
    compact.py:70, without its clamp: callers clamp). The same values as
    advanced indexing; its backward is index_add_'s atomic scatter-add,
    where advanced indexing's sorts the indices and adds each index's
    duplicates in one serial loop: on the card that made a 1024x1024
    gradient of the material and light tables, whose few rows a million
    lanes read, take seconds."""
    return tab.index_select(0, idx.reshape(-1).long()).reshape(
        idx.shape + tab.shape[1:])


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i: a scatter of arange (compact.py)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv
