"""Checkpoint / resume for training state -- the port's counterpart of
``neuralradiancecaching_tpu/io/checkpoint.py``, in the same file format, so
a cache trained by either package loads in the other.

A state (``models.nrc.NRCState``: a dataclass of tensors, dicts of tensors
and None fields) round-trips through a numpy ``.npz``. Leaves are stored
under the key paths JAX's ``jax.tree_util.keystr`` gives the JAX package's
NamedTuple state -- ``.mlp_params['w0']``, ``.hash_table``, ``.opt_step``
-- and None fields are absent, as an empty pytree is there. :func:`load`
checks name, shape and dtype against a template and raises ``ValueError``
on a mismatch; a template with None fields takes the shared leaves and
leaves the rest out (an SGD state from an Adam checkpoint).
:func:`config_hash` is the JAX package's hash of the config, so the two
packages agree on what a checkpoint was trained under.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any

import numpy as np
import torch


def _named_leaves(tree: Any, prefix: str = "") -> list:
    """[(key path, tensor)] in JAX's flatten order -- a dataclass's fields
    in order, a dict's keys sorted; None contributes none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        children = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        children = [(f".{f.name}", getattr(tree, f.name))
                    for f in dataclasses.fields(tree)]
    return [leaf for step, child in children
            for leaf in _named_leaves(child, prefix + step)]


def _rebuild(tree: Any, leaves: dict, prefix: str = "") -> Any:
    """``tree`` with each tensor replaced by ``leaves[key path]``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return leaves[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: _rebuild(getattr(tree, f.name), leaves, f"{prefix}.{f.name}")
        for f in dataclasses.fields(tree)})


def config_hash(cfg: Any) -> str:
    """Stable hash of a (nested) config dataclass, for checkpoint metadata
    (the JAX package's: sha256 of the sorted JSON of ``asdict``)."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    blob = json.dumps(cfg, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Save a state to ``<path>.npz`` (and a sidecar ``<path>.meta.json``
    with the metadata)."""
    arrays = {name: x.detach().cpu().numpy()
              for name, x in _named_leaves(tree)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    if metadata is not None:
        with open(path.removesuffix(".npz") + ".meta.json", "w") as f:
            json.dump(metadata, f)


def load(path: str, like: Any, expect_config_hash: str | None = None) -> Any:
    """Load a state saved by :func:`save` (or by the JAX package), shaped
    like ``like``, onto the devices of ``like``'s tensors.

    Checks the key paths, shapes and dtypes, and when given the config hash
    recorded in the sidecar metadata. Positionally keyed checkpoints of the
    old format (``leaf_<i>``) are read in JAX's flatten order.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    if expect_config_hash is not None:
        meta = load_metadata(path) or {}
        got = meta.get("config_hash")
        if got is not None and got != expect_config_hash:
            raise ValueError(
                f"checkpoint config hash mismatch: checkpoint was written "
                f"with config {got}, current config is {expect_config_hash}")
    with np.load(path) as data:
        legacy = all(k.startswith("leaf_") for k in data.files)
        leaves = {}
        for i, (name, want) in enumerate(_named_leaves(like)):
            key = f"leaf_{i}" if legacy else name
            if key not in data:
                raise ValueError(
                    f"checkpoint missing leaf {name!r}; it holds "
                    f"{sorted(data.files)[:8]}... — wrong model/config?")
            got = data[key]
            if got.shape != tuple(want.shape):
                raise ValueError(f"checkpoint shape mismatch at {name}: "
                                 f"{got.shape} vs {tuple(want.shape)}")
            # numpy's name of the dtype ('float32', 'int32', 'bfloat16')
            want_dtype = str(want.dtype).removeprefix("torch.")
            if got.dtype.name != want_dtype:
                raise ValueError(f"checkpoint dtype mismatch at {name}: "
                                 f"{got.dtype.name} vs {want_dtype}")
            leaves[name] = torch.from_numpy(np.array(got)).to(want.device)
    return _rebuild(like, leaves)


def load_metadata(path: str) -> dict | None:
    """The sidecar metadata of a checkpoint, or None when it has none."""
    meta_path = path.removesuffix(".npz") + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return None
