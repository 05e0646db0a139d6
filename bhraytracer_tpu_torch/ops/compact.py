"""Wavefront compaction (the port of bhraytracer_tpu/ops/compact.py).

Slot order decides which lanes keep their RNG streams and which are
dropped, so `partition_indices` reproduces the stable candidates-first
order exactly (``argsort(~mask, stable=True)[:k]``). `inverse_permutation`
undoes the coherence sort of the grouped-stream traces (ops/trace.py).
`lookup_rows` is the row lookup of the tables a render differentiates.

`LaneFrame` and `global_partition` split that order over ranks: a rank
holding some of a level's lanes keeps, and numbers, exactly the
candidates one process holding all of them would keep (the sharded train
step, parallel/sharding.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LaneFrame(NamedTuple):
    """Where a rank's lanes of one tree level sit among the lanes one
    process would hold rendering every rank's lanes: their global rows,
    which key their draws (ops/rng.py:uniform_rows) and order their
    compactions.

    A level's global rows fall in segments of consecutive rows, and in
    each segment rank r's rows come before rank r+1's. Level 0 is one
    segment: rank r holds rows [r*shard, (r+1)*shard). A compaction keeps
    candidates in row order, so its slots fall in the parent's segments,
    and a level's children, [GI slots (G)] ++ [refraction slots (K)], are
    the parent's segments twice (models/pathtracer.py:_shade_level).
    `exchange` sums a rank's per-segment counts over the ranks: (n_seg,)
    int64 -> (the sum over lower ranks, the sum over all), one collective
    that every rank calls at the same point."""

    rows: torch.Tensor  # (n,) int64 global row of each lane, ascending
    width: int  # the level's global width
    seg: torch.Tensor  # (n,) int64 segment of each lane, nondecreasing
    n_seg: int
    exchange: Callable


def global_partition(mask: torch.Tensor, k: int, frame: LaneFrame):
    """This rank's part of partition_indices(global mask, k) over the
    frame's lanes: (the local indices of the candidates whose global slot
    is below k, in order; those slots). A candidate's slot counts the
    candidates in earlier segments, on lower ranks in its own segment, and
    before it here (one exchange)."""
    m = mask.to(torch.int64)
    counts = torch.zeros(frame.n_seg, dtype=torch.int64,
                         device=mask.device).index_add_(0, frame.seg, m)
    lower, total = frame.exchange(counts)
    first = (torch.cumsum(total, 0) - total + lower
             - (torch.cumsum(counts, 0) - counts))
    slot = first[frame.seg] + torch.cumsum(m, 0) - 1
    idx = torch.nonzero(mask & (slot < k)).reshape(-1)
    return idx, slot[idx]


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
