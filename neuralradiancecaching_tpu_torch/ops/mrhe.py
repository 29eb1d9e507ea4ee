"""Multiresolution hash encoding, inference half (oct-packed rows).

Counterpart of ``neuralradiancecaching_tpu/ops/mrhe.py``: the level
schedule, the spatial hash, the oct bake (each row holds the 2^D corner
feature vectors of a cell, so one row gather per level replaces 2^D hash
gathers) and the encode from those rows. The training half (the hash-path
encode and its backward) is not ported yet.

The hash is uint32 wrap-around arithmetic in the reference and in JAX.
PyTorch has no uint32 arithmetic, so it is computed in int64 and masked to
32 bits after every multiply-add: coordinates below 2^32 times primes below
2^27 stay below 2^59, and indices match JAX bit for bit, negative
coordinates included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from neuralradiancecaching_tpu.config import MRHEConfig, QuirkFlags

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


def encode_with_oct(oct_rows: torch.Tensor, pos_norm: torch.Tensor,
                    cfg: MRHEConfig, quirks: QuirkFlags,
                    pos_raw: torch.Tensor | None = None,
                    compute_dtype=None) -> torch.Tensor:
    """Inference encode from oct-packed rows: one row gather per level.
    (..., D) normalized positions -> (..., L*F) features, level-major.

    Only the f32 path is ported; ``compute_dtype`` (the bf16 query) raises.
    """
    if compute_dtype is not None and compute_dtype != pos_norm.dtype:
        raise NotImplementedError("bf16 query compute is not ported yet")
    res = torch.as_tensor(resolutions(cfg), dtype=pos_norm.dtype,
                          device=pos_norm.device)
    x = pos_norm[..., None, :] * res[:, None]  # (..., L, D)
    x0 = torch.floor(x)
    if quirks.world_space_lerp:
        # reference bug (nrc-train.comp:312): world pos minus grid corner
        if pos_raw is None:
            raise ValueError("world_space_lerp needs pos_raw")
        frac = pos_raw[..., None, :] - x0
    else:
        frac = x - x0
    h = hash_coords(x0.to(torch.int64), cfg.table_size)  # (..., L)
    level_base = torch.arange(cfg.n_levels, device=h.device) * cfg.table_size
    rows = oct_rows[h + level_base].to(pos_norm.dtype)  # (..., L, C*F)
    c = 1 << cfg.n_dims
    rows = rows.reshape(*rows.shape[:-1], c, cfg.n_features)
    offsets = torch.as_tensor(_corner_offsets(cfg.n_dims), dtype=torch.bool,
                              device=pos_norm.device)  # (C, D)
    w = torch.where(offsets, frac[..., None, :], 1.0 - frac[..., None, :])
    weights = torch.prod(w, dim=-1)  # (..., L, C)
    feats = torch.sum(rows * weights[..., None], dim=-2)  # (..., L, F)
    return feats.reshape(*pos_norm.shape[:-1],
                         cfg.n_levels * cfg.n_features)


def normalize_pos(pos: torch.Tensor, box_size, box_center) -> torch.Tensor:
    """World position -> [0,1]^3 (EncodePosMrhe normPos, nrc-train.comp:268)."""
    size = torch.as_tensor(box_size, dtype=pos.dtype, device=pos.device)
    center = torch.as_tensor(box_center, dtype=pos.dtype, device=pos.device)
    return (pos - center) / size + 0.5
