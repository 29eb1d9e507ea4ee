"""O(n) stream compaction: lane packing and prefix-run packing.

Counterpart of ``neuralradiancecaching_tpu/ops/compact.py``.
``compact_select`` packs the indices of marked lanes to the front in lane
order (cumsum + one scatter into a cap+1 buffer whose last row is a dropped
dummy); ``scatter_back`` / ``scatter_update`` put packed rows back, and
``inverse_select`` / ``gather_back`` do it with one gather through a
precomputed inverse map.
``compact_prefix`` / ``prefix_segment_sum`` pack the collision walk's
events, whose valid slots form a prefix of each ray's slots (a done lane
never revives): one cumsum over rows, one mark scatter and a running
maximum -- the packed lanes come out sorted by row. In both, overflow
beyond the cap drops the HIGHEST lane or row indices deterministically,
and the results equal the JAX package's bit for bit, padding included.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neuralradiancecaching_tpu_torch.utils import profiling


def compact_select(mask: torch.Tensor, cap: int, site: str | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the indices of True lanes to the front, in lane order.

    mask: (n,) bool. Returns (sel (cap,) int64, sel_valid (cap,) bool): the
    first min(count, cap) entries of ``sel`` are the indices of the first
    True lanes; the padding entries hold index 0 (as in JAX) with sel_valid
    False. True lanes beyond ``cap`` are dropped, highest indices first.
    site: the name under which the tracer records the pack's live count
    against its cap (``utils.profiling.cap``), for a pack whose drops lose
    energy.
    """
    n = mask.shape[0]
    dev = mask.device
    mask = mask.to(torch.bool)
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    # position `cap` is the dummy row every dropped lane writes to
    slot = torch.where(mask & (pos < cap), pos, cap)
    sel = torch.zeros((cap + 1,), dtype=torch.int64, device=dev)
    sel = sel.scatter(0, slot, torch.arange(n, device=dev))[:cap]
    live = mask.sum()
    if site is not None:
        profiling.cap(live, cap, site)
    count = torch.clamp(live, max=cap)
    return sel, torch.arange(cap, device=dev) < count


def scatter_back(n: int, sel: torch.Tensor, sel_valid: torch.Tensor,
                 values: torch.Tensor, fill) -> torch.Tensor:
    """Inverse of compact_select: ``values[i]`` (cap, ...) lands at lane
    ``sel[i]`` for valid slots; every other lane gets ``fill``. Padding
    slots write a dropped dummy row."""
    dest = torch.full((n + 1,) + tuple(values.shape[1:]), fill,
                      dtype=values.dtype, device=values.device)
    dest[torch.where(sel_valid, sel, n)] = values
    return dest[:n]


def scatter_update(x: torch.Tensor, sel: torch.Tensor,
                   sel_valid: torch.Tensor, values: torch.Tensor
                   ) -> torch.Tensor:
    """Like scatter_back but unselected lanes KEEP their value from ``x``
    (padding slots write a dropped dummy row)."""
    n = x.shape[0]
    padded = torch.cat([x, x[-1:]], dim=0)
    padded[torch.where(sel_valid, sel, n)] = values
    return padded[:n]


def inverse_select(n: int, sel: torch.Tensor, sel_valid: torch.Tensor
                   ) -> torch.Tensor:
    """The inverse map of a compact_select: inv[lane] = the packed slot
    holding that lane, or ``cap`` (sentinel) for unselected lanes. With a
    ``sel`` that stays fixed over many frames (the pose-static live-ray
    pack) the per-frame un-pack becomes one :func:`gather_back`."""
    cap = sel.shape[0]
    inv = torch.full((n + 1,), cap, dtype=torch.int64, device=sel.device)
    inv[torch.where(sel_valid, sel, n)] = torch.arange(cap, device=sel.device)
    return inv[:n]


def gather_back(inv: torch.Tensor, values: torch.Tensor, fill
                ) -> torch.Tensor:
    """scatter_back through an :func:`inverse_select` map: lane i gets
    ``values[inv[i]]``, sentinel lanes get ``fill`` (a scalar or one row).
    Equal to scatter_back for the (sel, sel_valid) that built ``inv``."""
    fill_row = torch.as_tensor(fill, dtype=values.dtype,
                               device=values.device)
    fill_row = fill_row.expand((1,) + tuple(values.shape[1:]))
    return torch.cat([values, fill_row], dim=0)[inv]


def compact_prefix(counts: torch.Tensor, cap: int, site: str | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack per-row prefix runs: row i contributes slots 0..counts[i]-1.

    counts: (n,) ints. Returns (row (cap,), slot (cap,), valid (cap,)):
    packed position p holds row[p]'s slot[p]; positions beyond
    min(sum(counts), cap) have valid False. Bit-identical to the JAX version,
    overflow included. site: as :func:`compact_select`'s.
    """
    n = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    cum = torch.cumsum(counts, dim=0)
    offs = cum - counts  # exclusive
    total = cum[-1]
    if site is not None:
        profiling.cap(total, cap, site)
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
