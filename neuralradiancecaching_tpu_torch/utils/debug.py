"""Debug modes: NaN checking and state audits.

Counterpart of ``neuralradiancecaching_tpu/utils/debug.py``. The reference
contains NaN/Inf by clamping in the optimizer kernels (SURVEY.md §5); on
top of that :func:`nan_check` makes the first op that produces a NaN raise
(JAX's ``jax_debug_nans``), and :func:`assert_all_finite` audits every
floating tensor of a nested state for tests and debug runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) of nested dicts, lists, tuples, NamedTuples and
    dataclasses, with JAX's ``keystr`` names (``['w0']``, ``[2]``,
    ``.hash_table``); None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name),
                                        f"{path}.{f.name}")
    else:
        yield path, tree


# allocations whose contents are undefined until written: not a NaN source
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided"})


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for where, t in leaves_with_path(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output{where} of {func}")
        return out


@contextlib.contextmanager
def nan_check():
    """Raise ``FloatingPointError`` on the first op inside the context
    whose floating output holds a NaN (the counterpart of
    ``jax_debug_nans``).

    Covers every ATen op that runs in this thread while the context is
    open, eager or inside autograd's backward, on any device; each op's
    outputs are read back, so the card synchronizes after every op (a
    debug mode, not for timing). Not covered: ops on other threads, work
    inside a hand-written kernel's launch (its output is not an ATen op's
    until the wrapper returns it), integer or bool outputs, and
    uninitialized allocations (``empty`` and its kin). Inf is not flagged,
    as ``jax_debug_nans`` does not flag it.
    """
    with _NaNCheck():
        yield


def assert_all_finite(tree: Any, name: str = "state") -> None:
    """Audit every floating tensor of ``tree`` for NaN/Inf; raises
    ``AssertionError`` naming the first offending path."""
    for path, leaf in leaves_with_path(tree):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf).all())):
            raise AssertionError(f"non-finite values in {name}{path}")
