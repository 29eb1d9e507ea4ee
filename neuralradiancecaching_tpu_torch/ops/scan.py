"""Cumulative sums and products in a fixed, platform-independent order.

The baked collision field inverts cumulative optical-depth profiles by
comparing them against fractions of their own total (ops/collision.py), so
the exact rounding of every prefix decides knot positions: on a profile's
zero-density tail, prefixes that differ by one ulp from the total move a
knot by whole quadrature steps. ``torch.cumsum`` accumulates in float64 on
the CPU and runs a parallel scan on the card, so neither matches the JAX
reference nor each other. This helper fixes the order to the one XLA uses
for ``jnp.cumsum``: sequential sums within blocks of 16, and an exclusive
carry of the block totals, itself scanned the same way, added to each block.
The result matches ``jnp.cumsum`` bit for bit on float32 (tested) and is
deterministic on the card. :func:`cumprod` runs the same blocked scan with
products (the reference walk's throughput over its event slots).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BLOCK = 16


def _sequential(x: torch.Tensor, op) -> torch.Tensor:
    """Left-to-right inclusive scan along the last axis (length <= 16)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(op(cols[-1], x[..., i]))
    return torch.stack(cols, dim=-1)


def _scan_last(x: torch.Tensor, op, identity: float) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _BLOCK:
        return _sequential(x, op)
    nb = -(-n // _BLOCK)
    blocks = F.pad(x, (0, nb * _BLOCK - n), value=identity).reshape(
        *x.shape[:-1], nb, _BLOCK)
    within = _sequential(blocks, op)
    totals = _scan_last(within[..., -1], op, identity)
    carry = F.pad(totals[..., :-1], (1, 0), value=identity)
    out = op(within, carry[..., None])
    return out.reshape(*x.shape[:-1], nb * _BLOCK)[..., :n]


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in XLA's summation order."""
    return _scan_last(x.movedim(dim, -1), torch.add, 0.0).movedim(-1, dim)


def cumprod(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive cumulative product along ``dim``, blocked as
    :func:`cumsum`."""
    return _scan_last(x.movedim(dim, -1), torch.mul, 1.0).movedim(-1, dim)
