"""Prefix-run compaction: pack per-row prefix runs contiguously.

Counterpart of ``neuralradiancecaching_tpu/ops/compact.py``'s
``compact_prefix`` / ``prefix_segment_sum``: the collision walk's valid
events form a prefix of each ray's slots (a done lane never revives), so
the pack is one cumsum over rows, one mark scatter into a cap+1 buffer and
a running maximum -- the packed lanes come out sorted by row, and overflow
beyond the cap drops the HIGHEST row indices deterministically.
"""

from __future__ import annotations

from typing import Tuple

import torch


def compact_prefix(counts: torch.Tensor, cap: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack per-row prefix runs: row i contributes slots 0..counts[i]-1.

    counts: (n,) ints. Returns (row (cap,), slot (cap,), valid (cap,)):
    packed position p holds row[p]'s slot[p]; positions beyond
    min(sum(counts), cap) have valid False. Bit-identical to the JAX version,
    overflow included.
    """
    n = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    cum = torch.cumsum(counts, dim=0)
    offs = cum - counts  # exclusive
    total = cum[-1]
    # mark each nonempty row's id at its start (starts strictly increase, so
    # no in-bounds duplicates); position `cap` is the dropped overflow slot.
    # The running max then fills every packed position with its owner.
    start = torch.where((counts > 0) & (offs < cap), offs, cap)
    rowmark = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    rowmark = rowmark.scatter_reduce(
        0, start, torch.arange(n, device=dev), reduce="amax")[:cap]
    row = torch.clamp(torch.cummax(rowmark, dim=0).values, 0, n - 1)
    p = torch.arange(cap, device=dev)
    slot = p - offs[row]
    valid = p < torch.clamp(total, max=cap)
    return row, slot, valid


def prefix_segment_sum(contrib: torch.Tensor, counts: torch.Tensor,
                       slot: torch.Tensor) -> torch.Tensor:
    """Per-row sums of prefix-packed contributions (cap, ...) -> (n, ...).

    ``slot`` is compact_prefix's within-row slot of each packed lane, so
    ``p - slot`` is the lane's row start and each lane's row is found among
    the row starts; invalid (padding) lanes must already be zeroed. Rows
    beyond the cap or without lanes get 0; the row cut at the cap gets its
    partial sum. Equal to the JAX segmented scan up to fp add order (here
    ``index_add_``, atomic on the card).
    """
    cap = contrib.shape[0]
    n = counts.shape[0]
    counts = counts.to(torch.int64)
    offs = torch.cumsum(counts, dim=0) - counts
    starts = torch.arange(cap, device=contrib.device) - slot
    # the last row whose run starts at `starts` (empty rows share the start
    # of the next nonempty row, so take the right-most match)
    row = torch.searchsorted(offs, starts, right=True) - 1
    out = torch.zeros((n,) + contrib.shape[1:], dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, row, contrib)
