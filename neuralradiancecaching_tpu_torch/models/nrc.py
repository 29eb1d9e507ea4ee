"""The neural radiance cache: MRHE + one-blob encoding into the tiny MLP,
queried through the baked hash rows (oct or dense) or the hash path, and
trained online with guarded Adam (or the reference's SGD pair).

Counterpart of ``neuralradiancecaching_tpu/models/nrc.py``. ``NRCState``
keeps the JAX state's fields as tensors, so a JAX state converts with
:func:`state_from_numpy` and both packages compute with identical
parameters. Gradients come from autograd through the plain MLP and the
oct train encode (:func:`..ops.mrhe.encode_oct_train`), or the hash-path
encode (:func:`..ops.mrhe.encode`) when ``MRHEConfig.train_encode`` asks
for it or the table size is not a power of two; the optimizer steps are
the plain tensor functions of :mod:`..ops.optimizers`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig, OptimizerConfig
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
from neuralradiancecaching_tpu_torch.ops import mrhe as mrhe_ops
from neuralradiancecaching_tpu_torch.ops import oneblob as oneblob_ops
from neuralradiancecaching_tpu_torch.ops import optimizers
from neuralradiancecaching_tpu_torch.utils import profiling


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


def init_state(generator: Optional[torch.Generator], cfg: NRCConfig,
               device: torch.device | str = "cuda") -> NRCState:
    """Fresh state on ``device`` (the card unless the caller names
    another): weights, then the table, drawn from ``generator`` (a CPU
    generator seeded with ``cfg.seed`` when None) and moved to ``device``."""
    expected = input_features(cfg)
    if cfg.mlp.in_features != expected:
        raise ValueError(
            f"MLPConfig.in_features={cfg.mlp.in_features} must equal the "
            f"encoded width {expected} (= mrhe {cfg.mrhe.n_outputs} + "
            f"oneblob {cfg.oneblob.n_outputs})")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    params = {k: v.to(device) for k, v in
              mlp_ops.init_params(generator, cfg.mlp).items()}
    table = mrhe_ops.init_table(generator, cfg.mrhe).to(device)
    adam_mlp = cfg.mlp_opt.kind == "adam"
    adam_hash = cfg.mrhe.optimizer == "adam"
    return NRCState(
        mlp_params=params, mlp_momentum=optimizers.init_momentum(params),
        hash_table=table,
        mlp_second=optimizers.init_momentum(params) if adam_mlp else None,
        hash_momentum=torch.zeros_like(table) if adam_hash else None,
        hash_second=torch.zeros_like(table) if adam_hash else None,
        opt_step=(torch.zeros((), dtype=torch.int32, device=table.device)
                  if (adam_mlp or adam_hash) else None))


def state_from_numpy(d: Mapping, device: torch.device | str = "cuda"
                     ) -> NRCState:
    """The port's state on ``device`` from the JAX NRCState's fields as
    numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray,
    state)._asdict()``): dicts stay dicts, None stays None, arrays keep
    dtype and shape."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, Mapping):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(device)

    return NRCState(**{f.name: conv(d.get(f.name)) for f in fields(NRCState)})


def encode(hash_table: torch.Tensor, pos: torch.Tensor,
           direction: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """The trainable encode (EncodeRay, nrc-train.comp:703-713): [L*F MRHE
    features | one-blob features], differentiable in the hash table. The
    MRHE features go through the oct rows when ``train_encode`` is 'oct'
    and the table size a power of two, else through the hash path."""
    pos_norm = mrhe_ops.normalize_pos(pos, cfg.volume.box_size,
                                      cfg.volume.box_center)
    if (cfg.mrhe.train_encode == "oct"
            and mrhe_ops.oct_supported(cfg.mrhe)):
        mrhe_feats = mrhe_ops.encode_oct_train(hash_table, pos_norm,
                                               cfg.mrhe, cfg.quirks,
                                               pos_raw=pos)
    else:
        mrhe_feats = mrhe_ops.encode(hash_table, pos_norm, cfg.mrhe,
                                     cfg.quirks, pos_raw=pos)
    blob_feats = oneblob_ops.encode_dir(direction, cfg.oneblob, cfg.quirks)
    return torch.cat([mrhe_feats, blob_feats], dim=-1)


def _inference_mlp(params, x: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """Query-path MLP forward: the fused kernel (K1) when enabled and the
    input is a flat batch; the kernel's plain torch version otherwise (f32
    activations for bf16 rows too, as JAX's f32-accumulating dot)."""
    if cfg.mlp.fused_inference and x.ndim == 2:
        return fused_mlp.apply(params, x, cfg.mlp)
    return fused_mlp.apply_plain(params, x, cfg.mlp)


def query(state: NRCState, pos: torch.Tensor, direction: torch.Tensor,
          cfg: NRCConfig) -> torch.Tensor:
    """Cache inference through the trainable encode (the fragment Forward):
    (N, 3), (N, 3) -> (N, 3)."""
    x = encode(state.hash_table, pos, direction, cfg)
    return _inference_mlp(state.mlp_params, x, cfg)


@profiling.spanned("bake")
def bake(state: NRCState, cfg: NRCConfig) -> torch.Tensor:
    """The MRHE inference representation (``MRHEConfig.inference_bake``):
    'oct' corner-packed hash rows (one row gather per level per query),
    'dense' corner-packed grids of the low-resolution levels (both stored
    bf16 when the scene fields are), 'none' an empty tensor of the table's
    dtype (the query takes the hash path). Call after each optimizer
    step."""
    mode = cfg.mrhe.inference_bake
    if mode == "oct":
        baked = mrhe_ops.bake_oct(state.hash_table, cfg.mrhe)
    elif mode == "dense":
        baked = mrhe_ops.bake_dense(state.hash_table, cfg.mrhe)
    else:
        return torch.zeros((0,), dtype=state.hash_table.dtype,
                           device=state.hash_table.device)
    if cfg.volume.field_dtype == "bfloat16":
        baked = baked.to(torch.bfloat16)
    return baked


def encode_baked(state: NRCState, baked: torch.Tensor, pos: torch.Tensor,
                 direction: torch.Tensor, cfg: NRCConfig) -> torch.Tensor:
    """The gather half of query_baked: [L*F MRHE features from the baked
    rows of :func:`bake`'s mode | one-blob features] rows, (N, 3), (N, 3)
    -> (N, 64); bf16 rows when MLPConfig.inference_dtype is bf16 and the
    bake is 'oct' (index math and lerp fractions stay f32), f32 rows for
    the 'dense' and 'none' modes whatever the inference dtype."""
    mode = cfg.mrhe.inference_bake
    bf16 = cfg.mlp.inference_dtype == "bfloat16" and mode == "oct"
    pos_norm = mrhe_ops.normalize_pos(pos, cfg.volume.box_size,
                                      cfg.volume.box_center)
    if mode == "oct":
        mrhe_feats = mrhe_ops.encode_with_oct(
            baked, pos_norm, cfg.mrhe, cfg.quirks, pos_raw=pos,
            compute_dtype=torch.bfloat16 if bf16 else None)
    elif mode == "dense":
        mrhe_feats = mrhe_ops.encode_with_baked(state.hash_table, baked,
                                                pos_norm, cfg.mrhe,
                                                cfg.quirks)
    else:
        mrhe_feats = mrhe_ops.encode(state.hash_table, pos_norm, cfg.mrhe,
                                     cfg.quirks, pos_raw=pos)
    blob_feats = oneblob_ops.encode_dir(direction, cfg.oneblob, cfg.quirks)
    if bf16:
        blob_feats = blob_feats.to(torch.bfloat16)
    return torch.cat([mrhe_feats, blob_feats], dim=-1)


def query_mlp(state: NRCState, x: torch.Tensor, cfg: NRCConfig
              ) -> torch.Tensor:
    """The matmul half of query_baked: encode_baked rows -> (N, 3) f32.
    bf16 rows run with the parameters cast to bf16 (K1's bf16 mode)."""
    params = state.mlp_params
    if x.dtype == torch.bfloat16:
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    return _inference_mlp(params, x, cfg)


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


@profiling.spanned("train.grads")
def compute_grads(state: NRCState, pos: torch.Tensor,
                  direction: torch.Tensor, target: torch.Tensor,
                  cfg: NRCConfig):
    """Batch-mean gradients + the MSE stat (the nrc-train.comp Backprop
    pass, :985-1028, with the NaN-encoding early-out :993-999), through
    autograd on the plain MLP. Returns ((mlp_grads, hash_grad), mse)."""
    params = {k: v.detach().requires_grad_()
              for k, v in state.mlp_params.items()}
    table = state.hash_table.detach().requires_grad_()
    with torch.enable_grad():
        x = encode(table, pos, direction, cfg)
        valid = torch.all(torch.isfinite(x), dim=-1)
        x = torch.where(valid[:, None], x, 0.0)
        loss, mse = mlp_ops.nrc_loss(params, x, target, cfg.mlp,
                                     valid=valid, kind=cfg.train.loss)
        grads = torch.autograd.grad(loss, [*params.values(), table])
    return (dict(zip(params, grads[:-1])), grads[-1]), mse.detach()


@profiling.spanned("train.apply")
def apply_grads(state: NRCState, grads, cfg: NRCConfig) -> NRCState:
    """Both optimizer steps (nrc-step.comp + mrhe-step.comp), or the
    configured guarded Adam (OptimizerConfig.kind / MRHEConfig.optimizer)
    with the smooth lr decay keyed off the incremented step counter."""
    mlp_grads, hash_grad = grads
    opt_step = state.opt_step
    if opt_step is not None:
        opt_step = opt_step + 1

    def lr_scale(decay_steps, factor):
        if decay_steps <= 0 or opt_step is None:
            return None
        return factor ** (opt_step.to(torch.float32) / decay_steps)

    mlp_second = state.mlp_second
    if cfg.mlp_opt.kind == "adam":
        mlp_params, mlp_momentum, mlp_second = optimizers.adam_step(
            state.mlp_params, state.mlp_momentum, mlp_second, mlp_grads,
            opt_step, cfg.mlp_opt,
            lr_scale=lr_scale(cfg.mlp_opt.lr_decay_steps,
                              cfg.mlp_opt.lr_decay_factor))
    else:
        mlp_params, mlp_momentum = optimizers.momentum_sgd_step(
            state.mlp_params, state.mlp_momentum, mlp_grads, cfg.mlp_opt)

    hash_momentum, hash_second = state.hash_momentum, state.hash_second
    if cfg.mrhe.optimizer == "adam":
        hcfg = OptimizerConfig(
            learning_rate=cfg.mrhe.learning_rate,
            weight_decay=cfg.mrhe.weight_decay,
            beta1=cfg.mrhe.beta1, beta2=cfg.mrhe.beta2, eps=cfg.mrhe.eps,
            clip_border=cfg.mrhe.clip_border,
            reset_border=cfg.mrhe.reset_border, kind="adam")
        hash_table, hash_momentum, hash_second = optimizers.adam_step(
            state.hash_table, hash_momentum, hash_second, hash_grad,
            opt_step, hcfg, skip_zero_grad=True,
            lr_scale=lr_scale(cfg.mrhe.lr_decay_steps,
                              cfg.mrhe.lr_decay_factor))
    else:
        hash_table = optimizers.hash_sgd_step(state.hash_table, hash_grad,
                                              cfg.mrhe)
    return NRCState(mlp_params, mlp_momentum, hash_table, mlp_second,
                    hash_momentum, hash_second, opt_step)


def dump_weights(state: NRCState, max_per_layer: int = 8) -> str:
    """Human-readable weight summary in the JAX package's text format --
    the debug equivalent of NeuralRadianceCache::PrintWeights
    (NeuralRadianceCache.cpp:558-594), with per-layer stats (population
    std) instead of a raw dump."""
    def stats(w):
        return (f"mean={float(w.mean()):+.5f} "
                f"std={float(w.std(correction=0)):.5f} "
                f"absmax={float(w.abs().max()):.5f}")

    lines = []
    for name in sorted(state.mlp_params):
        w = state.mlp_params[name]
        head = ", ".join(f"{float(v):+.4f}"
                         for v in w.reshape(-1)[:max_per_layer])
        lines.append(f"{name} {tuple(w.shape)}: {stats(w)} head=[{head}]")
    h = state.hash_table
    lines.append(f"hash {tuple(h.shape)}: {stats(h)}")
    return "\n".join(lines)


def train_step(state: NRCState, pos: torch.Tensor, direction: torch.Tensor,
               target: torch.Tensor, cfg: NRCConfig
               ) -> Tuple[NRCState, torch.Tensor]:
    """One train pass over a batch of (pos, dir, target) -- gradients,
    then both optimizer steps. Returns (new_state, mse_stat)."""
    grads, mse = compute_grads(state, pos, direction, target, cfg)
    return apply_grads(state, grads, cfg), mse
