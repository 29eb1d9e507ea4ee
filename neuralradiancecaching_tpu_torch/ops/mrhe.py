"""Multiresolution hash encoding: the hash-path encode and its backward,
the dense bake of the low-resolution levels, and the oct-packed rows of
the inference and train encodes.

Counterpart of ``neuralradiancecaching_tpu/ops/mrhe.py``: the level
schedule, the spatial hash, the 2^D-gathers-per-level ``encode`` whose
backward scatter-adds into the (L*T, F) table (``index_add_``, atomic on
the card), the dense corner-packed grids of the levels with res <=
``dense_max_res`` (``bake_dense``, read back by ``encode_with_baked`` with
the hashed tail levels), the oct bake (each row holds the 2^D corner
feature vectors of a cell, so one row gather per level replaces 2^D hash
gathers), the encode from those rows, and ``encode_oct_train`` -- the same
forward with a backward that scatter-adds into the oct layout and folds it
back with the inverse corner rolls. ``n_dims`` 2 (image fit) and 3 (volume
positions) both work.

The hash is uint32 wrap-around arithmetic in the reference and in JAX.
PyTorch has no uint32 arithmetic, so it is computed in int64 and masked to
32 bits after every multiply-add: coordinates below 2^32 times primes below
2^27 stay below 2^59, and indices match JAX bit for bit, negative
coordinates and non-power-of-two tables (``h mod T`` of the wrapped sum)
included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neuralradiancecaching_tpu_torch.config import MRHEConfig, QuirkFlags

# hash primes (nrc-train.comp:256); first prime 1 keeps x-adjacency linear
HASH_PRIMES = (1, 19349663, 83492791)
_U32 = 0xFFFFFFFF


def resolutions(cfg: MRHEConfig) -> np.ndarray:
    """Geometric level resolutions (MRHE.cpp:111-121): N_l = Nmin * b^l,
    b = exp((ln Nmax - ln Nmin)/(L-1)), truncated."""
    if cfg.n_levels == 1:
        b = 1.0
    else:
        b = math.exp((math.log(cfg.max_res) - math.log(cfg.min_res))
                     / (cfg.n_levels - 1))
    res = [int(cfg.min_res * (b ** i)) for i in range(cfg.n_levels)]
    return np.asarray(res, dtype=np.int32)


def init_table(generator: torch.Generator, cfg: MRHEConfig,
               dtype=torch.float32) -> torch.Tensor:
    """(L, T, F) table, init N(0,1)*init_std, on the generator's device."""
    return torch.randn((cfg.n_levels, cfg.table_size, cfg.n_features),
                       generator=generator, dtype=dtype,
                       device=generator.device) * cfg.init_std


def _corner_offsets(n_dims: int) -> np.ndarray:
    """(2^D, D) binary corner offsets, x-major (x*4 + y*2 + z)."""
    n = 1 << n_dims
    out = np.zeros((n, n_dims), dtype=np.int32)
    for i in range(n):
        for d in range(n_dims):
            out[i, d] = (i >> (n_dims - 1 - d)) & 1
    return out


def hash_coords(coords: torch.Tensor, table_size: int) -> torch.Tensor:
    """Spatial hash of integer grid coords (..., D) -> (...,) int64 in [0, T).

    Equals the JAX/GLSL uint32 hash: each coordinate is taken mod 2^32
    (negative ones wrap) and the sum is reduced mod 2^32 after every step.
    """
    c = coords.to(torch.int64) & _U32
    h = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                    device=coords.device)
    for d in range(coords.shape[-1]):
        h = (h + c[..., d] * HASH_PRIMES[d]) & _U32
    if table_size & (table_size - 1) == 0:
        return h & (table_size - 1)
    return h % table_size


def _quirk_raw(quirks: QuirkFlags, pos_raw: torch.Tensor | None):
    """pos_raw when the world_space_lerp quirk reads it, else None."""
    if not quirks.world_space_lerp:
        return None
    if pos_raw is None:
        raise ValueError("world_space_lerp needs pos_raw")
    return pos_raw


def _grid(pos_norm: torch.Tensor, res: np.ndarray,
          pos_raw: torch.Tensor | None):
    """Grid cells of normalized positions (..., D) on the levels of ``res``:
    (floored grid coordinates x0, lerp fractions), each (..., L, D), in
    pos_norm's dtype. ``pos_raw`` given: the world_space_lerp quirk's
    fractions (reference bug, nrc-train.comp:312: the world position minus
    the grid corner)."""
    res_t = torch.as_tensor(res, dtype=pos_norm.dtype,
                            device=pos_norm.device)
    x = pos_norm[..., None, :] * res_t[:, None]  # (..., L, D)
    x0 = torch.floor(x)
    frac = x - x0 if pos_raw is None else pos_raw[..., None, :] - x0
    return x0, frac


def _corner_weights(frac: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Trilinear weights (..., L, 2^D) of fractions (..., L, D), corners in
    x-major order: prod_d (offset_d ? frac_d : 1 - frac_d)."""
    offsets = torch.as_tensor(_corner_offsets(n_dims), dtype=torch.bool,
                              device=frac.device)  # (2^D, D)
    w = torch.where(offsets, frac[..., None, :], 1.0 - frac[..., None, :])
    return torch.prod(w, dim=-1)


def _level_base(n_levels: int, table_size: int, device) -> torch.Tensor:
    """(L,) first row of each level in the flat (L*T, ...) layout."""
    return torch.arange(n_levels, device=device) * table_size


def _hash_geom(pos_norm: torch.Tensor, res: np.ndarray, cfg: MRHEConfig,
               pos_raw: torch.Tensor | None = None):
    """The hash path's geometry over the levels of ``res``: (flat index
    (..., L, 2^D) int64 into the (L*T, F) table of those levels, trilinear
    corner weights (..., L, 2^D))."""
    x0, frac = _grid(pos_norm, res, pos_raw)
    offsets = torch.as_tensor(_corner_offsets(cfg.n_dims),
                              device=pos_norm.device)
    corners = x0.to(torch.int64)[..., None, :] + offsets  # (..., L, 2^D, D)
    idx = hash_coords(corners, cfg.table_size)  # (..., L, 2^D)
    base = _level_base(len(res), cfg.table_size, pos_norm.device)[:, None]
    return idx + base, _corner_weights(frac, cfg.n_dims)


def _gather_lerp(flat_table: torch.Tensor, flat_idx: torch.Tensor,
                 weights: torch.Tensor, lead_shape, dtype) -> torch.Tensor:
    """Rows of the (L*T, F) table at (..., L, 2^D) indices, in ``dtype``,
    summed with their corner weights -> (..., L*F)."""
    gathered = flat_table[flat_idx].to(dtype)  # (..., L, 2^D, F)
    feats = torch.sum(weights[..., None] * gathered, dim=-2)  # (..., L, F)
    return feats.reshape(*lead_shape, -1)


class _Encode(torch.autograd.Function):
    """The JAX ``custom_vjp`` of encode (mrhe.py:118-165): the forward
    gathers the 2^D corner rows of every level from the flat (L*T, F)
    table; the backward scatter-adds w * err into a zero (L*T, F) table
    (``index_add_``). Positions get no gradient."""

    @staticmethod
    def forward(ctx, table, pos_norm, pos_raw, cfg, quirks):
        flat_idx, weights = _hash_geom(pos_norm, resolutions(cfg), cfg,
                                       _quirk_raw(quirks, pos_raw))
        ctx.save_for_backward(flat_idx, weights)
        ctx.cfg, ctx.quirks = cfg, quirks
        return _gather_lerp(table.reshape(-1, cfg.n_features), flat_idx,
                            weights, pos_norm.shape[:-1], table.dtype)

    @staticmethod
    def backward(ctx, g):
        flat_idx, weights = ctx.saved_tensors
        cfg = ctx.cfg
        f = cfg.n_features
        err = g.reshape(*flat_idx.shape[:-1], f)  # (..., L, F)
        if ctx.quirks.duplicated_feature_grad:
            # reference bug (nrc-train.comp:960): feature 0's error drives
            # every feature's table gradient
            err = err[..., :1].expand(err.shape)
        contrib = weights[..., None] * err[..., None, :]  # (..., L, 2^D, F)
        flat = torch.zeros((cfg.n_levels * cfg.table_size, f),
                           dtype=contrib.dtype, device=contrib.device)
        flat.index_add_(0, flat_idx.reshape(-1), contrib.reshape(-1, f))
        return (flat.reshape(cfg.n_levels, cfg.table_size, f), None, None,
                None, None)


def encode(table: torch.Tensor, pos_norm: torch.Tensor, cfg: MRHEConfig,
           quirks: QuirkFlags, pos_raw: torch.Tensor | None = None
           ) -> torch.Tensor:
    """The hash-path encode: (L, T, F) table, (..., D) normalized positions
    -> (..., L*F) features, level-major, differentiable in the table.
    ``pos_raw`` (world positions) is read only by the world_space_lerp
    quirk."""
    return _Encode.apply(table, pos_norm, pos_raw, cfg, quirks)


# ---------------------------------------------------------------------------
# Dense-baked low-resolution levels (inference_bake='dense'): the hash
# table of each level with res <= dense_max_res baked into a dense grid of
# corner-packed rows, so one 8*F row gather yields a level's trilinear
# patch; the remaining levels go through the hash path.
# ---------------------------------------------------------------------------

DENSE_MAX_RES = 64  # legacy default; MRHEConfig.dense_max_res overrides


def dense_level_count(cfg: MRHEConfig) -> int:
    """Number of leading levels with resolution <= cfg.dense_max_res (0
    unless the encode is 3-D)."""
    if cfg.n_dims != 3:
        return 0
    res = resolutions(cfg)
    return int(np.sum(res <= getattr(cfg, "dense_max_res", DENSE_MAX_RES)))


def dense_level_offsets(cfg: MRHEConfig):
    """(offsets, sizes) of each dense level's row block; rows are base cells
    in [0, res]^3 (covering resPos in [0, res] for pos_norm in [0,1])."""
    res = resolutions(cfg)
    n = dense_level_count(cfg)
    sizes = [(int(r) + 1) ** 3 for r in res[:n]]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    return offsets, sizes


def bake_dense(table: torch.Tensor, cfg: MRHEConfig) -> torch.Tensor:
    """(R_total, 8*F) corner-packed rows for all dense levels, concatenated:
    the row of base cell b of level l holds the 8 corner feature vectors
    table[l, hash(b + offset)] in x-major corner order. A (1, 8*F) zero row
    when no level is dense."""
    res = resolutions(cfg)
    blocks = []
    for l in range(dense_level_count(cfg)):
        r = int(res[l])
        side = r + 2  # corner coords span [0, res+1]
        ax = torch.arange(side, device=table.device)
        coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                             dim=-1)  # (side, side, side, 3)
        idx = hash_coords(coords, cfg.table_size)
        grid = table[l][idx]  # (side, side, side, F)
        packed = torch.cat([grid[dx:dx + r + 1, dy:dy + r + 1, dz:dz + r + 1]
                            for dx in (0, 1) for dy in (0, 1)
                            for dz in (0, 1)], dim=-1)
        blocks.append(packed.reshape(-1, 8 * cfg.n_features))
    if not blocks:
        return torch.zeros((1, 8 * cfg.n_features), dtype=table.dtype,
                           device=table.device)
    return torch.cat(blocks, dim=0)


def encode_with_baked(table: torch.Tensor, baked: torch.Tensor,
                      pos_norm: torch.Tensor, cfg: MRHEConfig,
                      quirks: QuirkFlags) -> torch.Tensor:
    """Inference encode: the dense levels from the baked rows (one gather
    for all of them; rows stored bf16 are upcast after the gather), the
    remaining levels from the hash table on their own resolutions. Equals
    :func:`encode` for positions in [0, 1]^3; outside it the dense levels
    read the clipped base cell, as in JAX. Falls back to :func:`encode`
    with no dense level or under world_space_lerp (where, as in JAX, it
    raises for want of raw positions)."""
    n_dense = dense_level_count(cfg)
    if n_dense == 0 or quirks.world_space_lerp:
        return encode(table, pos_norm, cfg, quirks, pos_raw=None)

    res_all = resolutions(cfg)
    offsets, _ = dense_level_offsets(cfg)
    flat_levels, w_levels = [], []
    for l in range(n_dense):
        r = int(res_all[l])
        x = pos_norm * r  # (..., 3)
        x0 = torch.floor(x)
        frac = x - x0
        b = torch.clamp(x0.to(torch.int64), 0, r)  # base in [0, res]
        flat_levels.append(int(offsets[l]) + b[..., 0] * ((r + 1) * (r + 1))
                           + b[..., 1] * (r + 1) + b[..., 2])
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
        w_levels.append(torch.stack(
            [gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
             fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz],
            dim=-1))
    flat_all = torch.stack(flat_levels, dim=-1)  # (..., n_dense)
    rows = baked[flat_all].to(pos_norm.dtype)
    rows = rows.reshape(*rows.shape[:-1], 8, cfg.n_features)
    w_all = torch.stack(w_levels, dim=-2)  # (..., n_dense, 8)
    feats = torch.sum(rows * w_all[..., None], dim=-2)  # (..., n_dense, F)
    dense = feats.reshape(*pos_norm.shape[:-1], n_dense * cfg.n_features)
    if n_dense == cfg.n_levels:
        return dense
    return torch.cat([dense, _encode_tail(table[n_dense:], pos_norm,
                                          res_all[n_dense:], cfg)], dim=-1)


def _encode_tail(tables_tail: torch.Tensor, pos_norm: torch.Tensor,
                 res_tail: np.ndarray, cfg: MRHEConfig) -> torch.Tensor:
    """Hash-path encode of the tail levels on their ORIGINAL resolutions
    (not a schedule re-derived from them), inference only: (n_tail, T, F)
    tables -> (..., n_tail*F)."""
    flat_idx, weights = _hash_geom(pos_norm, res_tail, cfg)
    return _gather_lerp(tables_tail.reshape(-1, cfg.n_features), flat_idx,
                        weights, pos_norm.shape[:-1], pos_norm.dtype)


def corner_hash_offsets(cfg: MRHEConfig) -> np.ndarray:
    """(2^D,) hash offset of each cell corner from the base corner, mod T."""
    offs = _corner_offsets(cfg.n_dims).astype(np.uint64)  # (C, D)
    primes = np.asarray(HASH_PRIMES[:cfg.n_dims], dtype=np.uint64)
    return ((offs * primes).sum(-1)
            % np.uint64(cfg.table_size)).astype(np.int32)


def oct_supported(cfg: MRHEConfig) -> bool:
    """The constant-offset identity needs T | 2^32, i.e. power-of-two T."""
    t = cfg.table_size
    return t > 0 and (t & (t - 1)) == 0


def bake_oct(table: torch.Tensor, cfg: MRHEConfig) -> torch.Tensor:
    """(L*T, 2^D * F) corner-packed hash rows: row (l, h) holds the corner
    features table[l, (h + off_c) mod T] for every corner c."""
    if not oct_supported(cfg):
        raise ValueError("oct bake requires a power-of-two table_size")
    parts = [torch.roll(table, -int(o), dims=1)
             for o in corner_hash_offsets(cfg)]
    packed = torch.cat(parts, dim=-1)  # (L, T, C*F)
    return packed.reshape(cfg.n_levels * cfg.table_size, -1)


def _oct_geom(pos_norm: torch.Tensor, cfg: MRHEConfig, quirks: QuirkFlags,
              pos_raw: torch.Tensor | None, compute_dtype=None):
    """(flat base-row index (..., L) int64, trilinear corner weights
    (..., L, 2^D)) of normalized positions (..., D). The index math and the
    fractions run in pos_norm's dtype; the fractions are then cast to
    ``compute_dtype`` (when given) and the weights computed in it."""
    x0, frac = _grid(pos_norm, resolutions(cfg), _quirk_raw(quirks, pos_raw))
    h = hash_coords(x0.to(torch.int64), cfg.table_size)  # (..., L)
    if compute_dtype is not None:
        frac = frac.to(compute_dtype)
    return (h + _level_base(cfg.n_levels, cfg.table_size, h.device),
            _corner_weights(frac, cfg.n_dims))


def _lerp_rows(rows: torch.Tensor, weights: torch.Tensor, cfg: MRHEConfig,
               lead_shape) -> torch.Tensor:
    """Gathered (..., L, C*F) rows x (..., L, C) weights -> (..., L*F)."""
    c = 1 << cfg.n_dims
    rows = rows.reshape(*rows.shape[:-1], c, cfg.n_features)
    feats = torch.sum(rows * weights[..., None], dim=-2)  # (..., L, F)
    return feats.reshape(*lead_shape, cfg.n_levels * cfg.n_features)


def encode_with_oct(oct_rows: torch.Tensor, pos_norm: torch.Tensor,
                    cfg: MRHEConfig, quirks: QuirkFlags,
                    pos_raw: torch.Tensor | None = None,
                    compute_dtype=None) -> torch.Tensor:
    """Inference encode from oct-packed rows: one row gather per level.
    (..., D) normalized positions -> (..., L*F) features, level-major.

    compute_dtype: when set (the bf16 query, MLPConfig.inference_dtype),
    the gathered rows, the lerp weights and the corner sum run in it and
    the output keeps it; the grid index math and the lerp fractions stay in
    pos_norm's dtype up to that cast. None: all in pos_norm's dtype.
    """
    cd = compute_dtype if compute_dtype is not None else pos_norm.dtype
    flat, weights = _oct_geom(pos_norm, cfg, quirks, pos_raw, cd)
    rows = oct_rows[flat].to(cd)  # (..., L, C*F)
    return _lerp_rows(rows, weights, cfg, pos_norm.shape[:-1])


class _EncodeOctTrain(torch.autograd.Function):
    """The JAX ``custom_vjp`` of encode_oct_train (mrhe.py:422-485): the
    forward bakes the oct rows and gathers one row per level; the backward
    scatter-adds (batch, L) rows of 2^D*F corner contributions into the
    (L*T, 2^D*F) oct layout (``index_add_``, atomic on the card) and folds
    it back with the inverse rolls, d_table[l, t] = sum_c
    d_oct[l, (t - off_c) mod T, c]. Positions get no gradient."""

    @staticmethod
    def forward(ctx, table, pos_norm, pos_raw, cfg, quirks):
        flat, weights = _oct_geom(pos_norm, cfg, quirks, pos_raw)
        rows = bake_oct(table, cfg)[flat]  # (..., L, C*F)
        ctx.save_for_backward(flat, weights)
        ctx.cfg, ctx.quirks = cfg, quirks
        return _lerp_rows(rows, weights, cfg, pos_norm.shape[:-1])

    @staticmethod
    def backward(ctx, g):
        flat, weights = ctx.saved_tensors
        cfg = ctx.cfg
        c, f = 1 << cfg.n_dims, cfg.n_features
        err = g.reshape(*flat.shape, f)  # (..., L, F)
        if ctx.quirks.duplicated_feature_grad:
            # reference bug (nrc-train.comp:960): feature 0's error drives
            # every feature's table gradient
            err = err[..., :1].expand(err.shape)
        contrib = weights[..., None] * err[..., None, :]  # (..., L, C, F)
        d_oct = torch.zeros((cfg.n_levels * cfg.table_size, c * f),
                            dtype=contrib.dtype, device=contrib.device)
        d_oct.index_add_(0, flat.reshape(-1), contrib.reshape(-1, c * f))
        d_oct = d_oct.reshape(cfg.n_levels, cfg.table_size, c, f)
        d_table = torch.zeros((cfg.n_levels, cfg.table_size, f),
                              dtype=contrib.dtype, device=contrib.device)
        for ci, off in enumerate(corner_hash_offsets(cfg)):
            d_table = d_table + torch.roll(d_oct[:, :, ci, :], int(off),
                                           dims=1)
        return d_table, None, None, None, None


def encode_oct_train(table: torch.Tensor, pos_norm: torch.Tensor,
                     cfg: MRHEConfig, quirks: QuirkFlags,
                     pos_raw: torch.Tensor | None = None) -> torch.Tensor:
    """Trainable encode via corner-packed rows: (L, T, F) table, (..., D)
    normalized positions -> (..., L*F) features, differentiable in the
    table. Needs a power-of-two table_size (:func:`oct_supported`)."""
    if not oct_supported(cfg):
        raise ValueError("the oct train encode needs a power-of-two "
                         "table_size")
    return _EncodeOctTrain.apply(table, pos_norm, pos_raw, cfg, quirks)


def normalize_pos(pos: torch.Tensor, box_size, box_center) -> torch.Tensor:
    """World position -> [0,1]^3 (EncodePosMrhe normPos, nrc-train.comp:268)."""
    size = torch.as_tensor(box_size, dtype=pos.dtype, device=pos.device)
    center = torch.as_tensor(box_center, dtype=pos.dtype, device=pos.device)
    return (pos - center) / size + 0.5
