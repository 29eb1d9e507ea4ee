"""The neural radiance cache, inference half: MRHE + one-blob encoding into
the tiny MLP, queried through the oct-baked hash rows.

Counterpart of ``neuralradiancecaching_tpu/models/nrc.py``. ``NRCState``
keeps the JAX state's fields as tensors, so a JAX state converts with
:func:`state_from_numpy` and both packages compute with identical
parameters. Training (``train_step``, the optimizers, the encode backward)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Mapping

import numpy as np
import torch

from neuralradiancecaching_tpu.config import NRCConfig
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
from neuralradiancecaching_tpu_torch.ops import mrhe as mrhe_ops
from neuralradiancecaching_tpu_torch.ops import oneblob as oneblob_ops


@dataclass
class NRCState:
    """Trainable and optimizer state; the Adam fields are None unless the
    configured optimizer is Adam (as in the JAX state)."""

    mlp_params: Dict[str, torch.Tensor]    # w0..w{n-1} (in, out), b0.. (out,)
    mlp_momentum: Dict[str, torch.Tensor]  # momentum / Adam first moment
    hash_table: torch.Tensor               # (L, T, F)
    mlp_second: Dict[str, torch.Tensor] | None = None
    hash_momentum: torch.Tensor | None = None
    hash_second: torch.Tensor | None = None
    opt_step: torch.Tensor | None = None


def input_features(cfg: NRCConfig) -> int:
    """Encoded width: L*F MRHE features + 2*bins one-blob features."""
    return cfg.mrhe.n_outputs + cfg.oneblob.n_outputs


def init_state(generator: torch.Generator, cfg: NRCConfig) -> NRCState:
    """Fresh state on the generator's device (weights, then the table)."""
    expected = input_features(cfg)
    if cfg.mlp.in_features != expected:
        raise ValueError(
            f"MLPConfig.in_features={cfg.mlp.in_features} must equal the "
            f"encoded width {expected} (= mrhe {cfg.mrhe.n_outputs} + "
            f"oneblob {cfg.oneblob.n_outputs})")
    params = mlp_ops.init_params(generator, cfg.mlp)
    table = mrhe_ops.init_table(generator, cfg.mrhe)

    def zeros_like_params():
        return {k: torch.zeros_like(v) for k, v in params.items()}

    adam_mlp = cfg.mlp_opt.kind == "adam"
    adam_hash = cfg.mrhe.optimizer == "adam"
    return NRCState(
        mlp_params=params, mlp_momentum=zeros_like_params(),
        hash_table=table,
        mlp_second=zeros_like_params() if adam_mlp else None,
        hash_momentum=torch.zeros_like(table) if adam_hash else None,
        hash_second=torch.zeros_like(table) if adam_hash else None,
        opt_step=(torch.zeros((), dtype=torch.int32, device=table.device)
                  if (adam_mlp or adam_hash) else None))


def state_from_numpy(d: Mapping, device: torch.device | str) -> NRCState:
    """The port's state from the JAX NRCState's fields as numpy arrays
    (e.g. ``jax.tree_util.tree_map(np.asarray, state)._asdict()``): dicts
    stay dicts, None stays None, arrays keep dtype and shape."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    return NRCState(**{f.name: conv(d.get(f.name)) for f in fields(NRCState)})


def _inference_mlp(params, x: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """Query-path MLP forward: the fused kernel (K1) when enabled and the
    input is a flat batch; the plain torch MLP otherwise."""
    if cfg.mlp.fused_inference and x.ndim == 2:
        return fused_mlp.apply(params, x, cfg.mlp)
    return mlp_ops.apply(params, x, cfg.mlp)


def bake(state: NRCState, cfg: NRCConfig) -> torch.Tensor:
    """The MRHE inference representation: oct-packed corner rows (one row
    gather per level per query). Call after each optimizer step."""
    if cfg.mrhe.inference_bake != "oct":
        raise NotImplementedError(
            f"inference_bake={cfg.mrhe.inference_bake!r} is not ported yet")
    if cfg.volume.field_dtype != "float32":
        raise NotImplementedError("bf16 baked rows are not ported yet")
    return mrhe_ops.bake_oct(state.hash_table, cfg.mrhe)


def encode_baked(state: NRCState, baked: torch.Tensor, pos: torch.Tensor,
                 direction: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """The gather half of query_baked: [L*F MRHE features from the baked
    rows | one-blob features] rows, (N, 3), (N, 3) -> (N, 64)."""
    if cfg.mlp.inference_dtype != "float32":
        raise NotImplementedError("bf16 query is not ported yet")
    pos_norm = mrhe_ops.normalize_pos(pos, cfg.volume.box_size,
                                      cfg.volume.box_center)
    mrhe_feats = mrhe_ops.encode_with_oct(baked, pos_norm, cfg.mrhe,
                                          cfg.quirks, pos_raw=pos)
    blob_feats = oneblob_ops.encode_dir(direction, cfg.oneblob, cfg.quirks)
    return torch.cat([mrhe_feats, blob_feats], dim=-1)


def query_mlp(state: NRCState, x: torch.Tensor, cfg: NRCConfig
              ) -> torch.Tensor:
    """The matmul half of query_baked: encode_baked rows -> (N, 3)."""
    if x.dtype != torch.float32:
        raise NotImplementedError("bf16 query is not ported yet")
    return _inference_mlp(state.mlp_params, x, cfg)


def query_baked(state: NRCState, baked: torch.Tensor, pos: torch.Tensor,
                direction: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """Cache inference via the baked MRHE rows: (N, 3), (N, 3) -> (N, 3)."""
    return query_mlp(state, encode_baked(state, baked, pos, direction, cfg),
                     cfg)


def make_baked_query_fn(state: NRCState, baked: torch.Tensor,
                        cfg: NRCConfig):
    """query_fn closure for the render, carrying the encode/MLP split as the
    ``encode_fn`` / ``mlp_fn`` attributes like the JAX version."""
    def query_fn(qpos, qdir):
        return query_baked(state, baked, qpos, qdir, cfg)

    query_fn.encode_fn = lambda qpos, qdir: encode_baked(state, baked, qpos,
                                                         qdir, cfg)
    query_fn.mlp_fn = lambda x: query_mlp(state, x, cfg)
    return query_fn
