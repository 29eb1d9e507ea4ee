"""Density-volume sampling and ray/box geometry.

Counterpart of ``neuralradiancecaching_tpu/ops/volume.py``: analytic slab
ray/AABB intersection, the corner table (each base cell's 8 trilinear
corners in one row, clamp-to-border black), trilinear density fetches from
it, and the fixed-step transmittance quadrature of the reference
(GetTransmittance, nrc-train.comp:1032-1053). Shape-polymorphic over
leading batch dimensions; no data-dependent control flow.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neuralradiancecaching_tpu.config import VolumeConfig


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def ray_aabb(ro: torch.Tensor, rd: torch.Tensor, box_size, box_center
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab intersection of rays with the volume AABB.

    ro, rd: (..., 3). Returns (t_entry, t_exit, hit), each (...,); t_entry
    is clamped to 0 for origins inside the box; for misses t_entry/t_exit
    are meaningless but finite.
    """
    half = _vec(box_size, ro) * 0.5
    center = _vec(box_center, ro)
    inv = 1.0 / torch.where(torch.abs(rd) < 1e-12,
                            torch.where(rd < 0, -1e-12, 1e-12), rd)
    t0 = (center - half - ro) * inv
    t1 = (center + half - ro) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t_entry = torch.clamp(tmin, min=0.0)
    return t_entry, tmax, hit


def entry_exit_points(ro: torch.Tensor, rd: torch.Tensor, box_size,
                      box_center
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """find_entry_exit as points: (entry (...,3), exit (...,3), hit (...,))."""
    t_in, t_out, hit = ray_aabb(ro, rd, box_size, box_center)
    return ro + t_in[..., None] * rd, ro + t_out[..., None] * rd, hit


def world_to_uvw(pos: torch.Tensor, box_size, box_center) -> torch.Tensor:
    """get_sky_uvw (nrc-train.comp:405-408): box -> [0,1]^3."""
    return (pos - _vec(box_center, pos)) / _vec(box_size, pos) + 0.5


def build_corner_table(grid: torch.Tensor) -> torch.Tensor:
    """(Nx, Ny, Nz) density grid -> ((Nx+1)*(Ny+1)*(Nz+1), 8) corner table.

    Base cell (i, j, k), i in [-1, Nx-1] stored shifted by +1, holds the 8
    corners grid[i+di, j+dj, k+dk] in x-major order (di*4 + dj*2 + dk);
    out-of-range corners are 0 (clamp-to-border black).
    """
    nx, ny, nz = grid.shape
    padded = torch.zeros((nx + 2, ny + 2, nz + 2), dtype=grid.dtype,
                         device=grid.device)
    padded[1:-1, 1:-1, 1:-1] = grid
    slices = [padded[dx:dx + nx + 1, dy:dy + ny + 1, dz:dz + nz + 1]
              for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.stack(slices, dim=-1).reshape(-1, 8)


def sample_corner_trilinear(table: torch.Tensor, uvw: torch.Tensor,
                            grid_shape) -> torch.Tensor:
    """Trilinear fetch from a corner table: ONE row gather per sample, clamp-
    to-border black for uvw outside [0,1]. uvw (..., 3) -> (...,)."""
    nx, ny, nz = grid_shape
    t = uvw * _vec((nx, ny, nz), uvw) - 0.5
    i0f = torch.floor(t)
    frac = t - i0f
    i0 = i0f.to(torch.int64)
    hi = torch.as_tensor((nx, ny, nz), device=uvw.device)
    valid = torch.all((i0 >= -1) & (i0 <= hi - 1), dim=-1)
    b = torch.minimum(torch.clamp(i0 + 1, min=0), hi)
    flat = b[..., 0] * ((ny + 1) * (nz + 1)) + b[..., 1] * (nz + 1) + b[..., 2]
    rows = table[flat]  # (..., 8)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    # corner order dx*4 + dy*2 + dz
    w = torch.stack([gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                     fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz],
                    dim=-1)
    val = torch.sum(rows * w, dim=-1)
    return torch.where(valid, val, 0.0)


def density_at(field: torch.Tensor, pos: torch.Tensor,
               cfg: VolumeConfig) -> torch.Tensor:
    """getDensity (nrc-train.comp:410-413): factor * trilinear fetch from a
    corner table (:func:`build_corner_table`)."""
    if field.ndim != 2:
        raise NotImplementedError("density_at takes a corner table; the raw-"
                                  "grid sampler is not ported yet")
    uvw = world_to_uvw(pos, cfg.box_size, cfg.box_center)
    return cfg.density_factor * sample_corner_trilinear(field, uvw,
                                                        cfg.grid_shape)


def transmittance(field: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  steps: int, cfg: VolumeConfig) -> torch.Tensor:
    """Fixed-step quadrature: samples at start + (i/steps)(end - start) for
    i in [0, steps), T = exp(-step * sum sigma); 1 for zero-length segments.
    start/end: (..., 3) -> (...,). Holds (..., steps, 3) points at once:
    callers chunk large batches."""
    seg = end - start
    length = torch.linalg.vector_norm(seg, dim=-1)
    step_size = length / steps
    fracs = torch.arange(steps, dtype=start.dtype, device=start.device) / steps
    pts = start[..., None, :] + fracs[:, None] * seg[..., None, :]
    dens = density_at(field, pts, cfg)  # (..., S)
    optical = step_size * torch.sum(dens, dim=-1)
    return torch.where(length > 0.0, torch.exp(-optical), 1.0)


def quantize_8bit(grid: torch.Tensor) -> torch.Tensor:
    """Quirk #7 (Texture3D.cpp:25-40): density quantized to 8-bit UNORM."""
    return torch.round(torch.clamp(grid, 0.0, 1.0) * 255.0) / 255.0
