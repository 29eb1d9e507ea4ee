"""Density-volume sampling and ray/box geometry.

Counterpart of ``neuralradiancecaching_tpu/ops/volume.py``: analytic slab
ray/AABB intersection, trilinear density fetches from the raw grid (eight
corner gathers, clamp-to-border black) or from the corner table (each base
cell's 8 corners in one row, the fast path), the fixed-step transmittance
quadrature of the reference (GetTransmittance, nrc-train.comp:1032-1053),
the unbiased ratio-tracking transmittance of the ground-truth oracle (its
uniforms from the caller) and the dilated coarse majorant grid of
local-majorant delta tracking.
Shape-polymorphic over leading batch dimensions; no data-dependent control
flow. Each call of the two transmittance estimators is traced as the span
``transmittance`` with the count ``density_samples`` (its rows x steps).

On the card the quadrature's density samples come from one hand-written
CUDA kernel (``csrc/transmittance.cu``, :func:`quadrature_densities`,
which adds its rows x steps to the count ``density_samples_kernel``): the
plain path's per-sample arithmetic done once in registers. The step sum
stays the plain path's ``torch.sum``, and a second kernel of the same file
does what follows it (the step size's product, ``exp`` and the zero-length
test), so :func:`transmittance_kernel` is bit for bit
:func:`transmittance_plain` on the same tensors at any step count.
Dispatch rule: CPU tensors take the plain path; CUDA tensors take the
kernels, or raise ``ValueError`` for what they do not take. There is no
fallback from the card to the plain path.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import consts, scan
from neuralradiancecaching_tpu_torch.utils import profiling


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a constant of ``like``'s dtype on its device."""
    return consts.const(values, like.dtype, like.device)


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


def _cell(uvw: torch.Tensor, grid_shape):
    """The base texel i0 (..., 3) int64 and the fractions (..., 3) of the
    trilinear sample at uvw: texel centres sit at (i + 0.5) / N, so the
    sample coordinates are uvw * N - 0.5."""
    t = uvw * _vec(grid_shape, uvw) - 0.5
    i0f = torch.floor(t)
    return i0f.to(torch.int64), t - i0f


def _lerp8(rows: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """The trilinear sum of the 8 corners (..., 8), in x-major order
    (dx*4 + dy*2 + dz), weighted by the fractions (..., 3)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    w = torch.stack([gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
                     fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz],
                    dim=-1)
    return torch.sum(rows * w, dim=-1)


def sample_grid_trilinear(grid: torch.Tensor, uvw: torch.Tensor
                          ) -> torch.Tensor:
    """Trilinear fetch from the raw (Nx, Ny, Nz) grid with GL texture
    semantics, eight corner gathers; corners outside the grid contribute
    zero (clamp-to-border black, src/main.cpp:126-128). The corners are
    summed as :func:`sample_corner_trilinear` sums its table row, so the
    two give the same bits. uvw (..., 3) -> (...,)."""
    nx, ny, nz = grid.shape
    i0, frac = _cell(uvw, (nx, ny, nz))
    flat = grid.reshape(-1)
    corners = []
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                ix, iy, iz = i0[..., 0] + cx, i0[..., 1] + cy, i0[..., 2] + cz
                inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                          & (iz >= 0) & (iz < nz))
                lin = (torch.clamp(ix, 0, nx - 1) * (ny * nz)
                       + torch.clamp(iy, 0, ny - 1) * nz
                       + torch.clamp(iz, 0, nz - 1))
                corners.append(torch.where(inside, flat[lin], 0.0))
    return _lerp8(torch.stack(corners, dim=-1), frac)


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
    to-border black for uvw outside [0,1]; the same values as
    :func:`sample_grid_trilinear` on the grid. uvw (..., 3) -> (...,)."""
    nx, ny, nz = grid_shape
    i0, frac = _cell(uvw, (nx, ny, nz))
    hi = consts.const((nx, ny, nz), torch.int64, uvw.device)
    valid = torch.all((i0 >= -1) & (i0 <= hi - 1), dim=-1)
    b = torch.minimum(torch.clamp(i0 + 1, min=0), hi)
    flat = b[..., 0] * ((ny + 1) * (nz + 1)) + b[..., 1] * (nz + 1) + b[..., 2]
    return torch.where(valid, _lerp8(table[flat], frac), 0.0)


def density_at(field: torch.Tensor, pos: torch.Tensor,
               cfg: VolumeConfig) -> torch.Tensor:
    """getDensity (nrc-train.comp:410-413): factor * trilinear fetch.

    ``field`` is a corner table from :func:`build_corner_table` (the fast
    path) or the raw (Nx, Ny, Nz) grid (:func:`sample_grid_trilinear`),
    told apart by rank; the two give the same values."""
    uvw = world_to_uvw(pos, cfg.box_size, cfg.box_center)
    if field.ndim == 2:
        return cfg.density_factor * sample_corner_trilinear(
            field, uvw, cfg.grid_shape)
    return cfg.density_factor * sample_grid_trilinear(field, uvw)


def transmittance_plain(field: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor, steps: int, cfg: VolumeConfig
                        ) -> torch.Tensor:
    """The quadrature in plain torch (the kernel's plain version): samples
    at start + (i/steps)(end - start) for i in [0, steps), T = exp(-step *
    sum sigma); 1 for zero-length segments. start/end: (..., 3) -> (...,).
    Holds (..., steps, 3) points at once: callers chunk large batches."""
    seg = end - start
    length = torch.linalg.vector_norm(seg, dim=-1)
    step_size = length / steps
    fracs = torch.arange(steps, dtype=start.dtype, device=start.device) / steps
    pts = start[..., None, :] + fracs[:, None] * seg[..., None, :]
    dens = density_at(field, pts, cfg)  # (..., S)
    optical = step_size * torch.sum(dens, dim=-1)
    return torch.where(length > 0.0, torch.exp(-optical), 1.0)


def _kernel_library() -> ctypes.CDLL:
    lib = kernels.load("transmittance")
    fn = lib.quadrature_densities
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int]
                       + [ctypes.c_float] * 6 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.quadrature_finish
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def quadrature_densities(field: torch.Tensor, start: torch.Tensor,
                         seg: torch.Tensor, steps: int, cfg: VolumeConfig
                         ) -> torch.Tensor:
    """The quadrature's density samples as one launch of
    ``csrc/transmittance.cu``: (..., 3) float32 CUDA start and seg ->
    (..., steps), bit for bit :func:`density_at` at start + (i/steps) seg
    (the plain path's ``dens``). ``field`` is the float32 corner table of
    ``cfg.grid_shape`` (contiguous, 16-byte aligned). Raises ``ValueError``
    for anything else; the inputs are checked before their device."""
    for name, t in (("field", field), ("start", start), ("seg", seg)):
        if t.dtype != torch.float32:
            raise ValueError(f"transmittance kernel takes float32 tensors, "
                             f"got {name} {t.dtype}")
    nx, ny, nz = cfg.grid_shape
    if tuple(field.shape) != ((nx + 1) * (ny + 1) * (nz + 1), 8):
        raise ValueError(f"transmittance kernel takes the corner table of "
                         f"grid_shape {tuple(cfg.grid_shape)}, got "
                         f"{tuple(field.shape)}")
    if not field.is_contiguous() or field.data_ptr() % 16:
        raise ValueError("transmittance kernel takes a contiguous corner "
                         "table starting 16-byte aligned (16-byte loads)")
    if start.shape != seg.shape or start.shape[-1:] != (3,):
        raise ValueError(f"transmittance kernel takes (..., 3) start and "
                         f"end, got {tuple(start.shape)}, {tuple(seg.shape)}")
    if steps < 1:
        raise ValueError(f"transmittance kernel needs steps >= 1, got {steps}")
    if start.device.type != "cuda":
        raise ValueError(f"transmittance kernel needs CUDA tensors, got "
                         f"{start.device}")
    for name, t in (("field", field), ("seg", seg)):
        if t.device != start.device:
            raise ValueError(f"transmittance kernel: {name} on {t.device}, "
                             f"start on {start.device}")
    dens = torch.empty((*start.shape[:-1], steps), dtype=torch.float32,
                       device=start.device)
    rows = start.shape[:-1].numel()
    if rows == 0:
        return dens
    start_c, seg_c = start.contiguous(), seg.contiguous()
    err = _kernel_library().quadrature_densities(
        field.data_ptr(), start_c.data_ptr(), seg_c.data_ptr(),
        dens.data_ptr(), rows, steps, *cfg.box_center, *cfg.box_size, nx, ny,
        nz, cfg.density_factor, start.device.index,
        torch.cuda.current_stream(start.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transmittance kernel launch failed: CUDA error "
                           f"{err}")
    profiling.count("k3_launches", 1)
    profiling.count("density_samples_kernel", rows * steps)
    return dens


def transmittance_kernel(field: torch.Tensor, start: torch.Tensor,
                         end: torch.Tensor, steps: int, cfg: VolumeConfig
                         ) -> torch.Tensor:
    """The quadrature on CUDA tensors, bit for bit
    :func:`transmittance_plain`: its density samples from
    :func:`quadrature_densities` (which adds its rows x steps to the count
    ``density_samples_kernel``), the segment, its length, the step size and
    the step sum in the plain path's torch operations, the rest in the
    finish kernel. Each of the two launches adds 1 to the count
    ``k3_launches`` (none without rows). start/end: float32 (..., 3) of
    any layout -> (...,)."""
    if end.device != start.device or end.shape != start.shape:
        raise ValueError(f"transmittance kernel takes start and end of one "
                         f"shape on one device, got {tuple(start.shape)} on "
                         f"{start.device}, {tuple(end.shape)} on {end.device}")
    seg = end - start
    length = torch.linalg.vector_norm(seg, dim=-1)
    step_size = length / steps
    dens = quadrature_densities(field, start, seg, steps, cfg)
    return _quadrature_finish(torch.sum(dens, dim=-1), step_size, length)


def _quadrature_finish(total: torch.Tensor, step_size: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """The plain path's ``where(length > 0, exp(-(step_size * total)), 1)``
    as one launch of ``csrc/transmittance.cu``'s finish kernel, bit for
    bit; (...,) float32 CUDA tensors of one shape, as
    :func:`transmittance_kernel` makes them."""
    out = torch.empty(length.shape, dtype=torch.float32, device=length.device)
    rows = length.numel()
    if rows == 0:
        return out
    err = _kernel_library().quadrature_finish(
        total.contiguous().data_ptr(), step_size.contiguous().data_ptr(),
        length.contiguous().data_ptr(), out.data_ptr(), rows,
        length.device.index,
        torch.cuda.current_stream(length.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transmittance finish kernel launch failed: CUDA "
                           f"error {err}")
    profiling.count("k3_launches", 1)
    return out


@profiling.spanned("transmittance")
def transmittance(field: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  steps: int, cfg: VolumeConfig) -> torch.Tensor:
    """Fixed-step quadrature: samples at start + (i/steps)(end - start) for
    i in [0, steps), T = exp(-step * sum sigma); 1 for zero-length segments.
    start/end: (..., 3) -> (...,). :func:`transmittance_kernel` on CUDA
    tensors, :func:`transmittance_plain` (which holds (..., steps, 3)
    points at once: callers chunk large batches) on CPU tensors."""
    profiling.count("density_samples", start.shape[:-1].numel() * steps)
    if start.device.type == "cpu":
        return transmittance_plain(field, start, end, steps, cfg)
    return transmittance_kernel(field, start, end, steps, cfg)


def quantize_8bit(grid: torch.Tensor) -> torch.Tensor:
    """Quirk #7 (Texture3D.cpp:25-40): density quantized to 8-bit UNORM."""
    return torch.round(torch.clamp(grid, 0.0, 1.0) * 255.0) / 255.0


@profiling.spanned("transmittance")
def transmittance_ratio(field: torch.Tensor, start: torch.Tensor,
                        end: torch.Tensor, uniforms: torch.Tensor,
                        sigma_maj: torch.Tensor | float, cfg: VolumeConfig
                        ) -> torch.Tensor:
    """UNBIASED segment transmittance by ratio tracking, batched:
    T = prod_k (1 - sigma(x_k) / sigma_maj) over Woodcock candidates at
    distances cumsum(Exp(sigma_maj)) <= |end - start| (factors past the
    segment end, or past an exhausted budget, are 1). The candidates do not
    depend on the density, so the estimate is one batched gather and a
    masked product. 1 for zero-length segments.

    start/end: (..., 3) -> (...,). uniforms: (steps, ...) -- the JAX draw
    ``uniform(key, (steps,) + shape)``. Holds (steps, ..., 3) points at
    once: callers chunk large batches.
    """
    profiling.count("density_samples", uniforms.numel())
    seg = end - start
    length = torch.linalg.vector_norm(seg, dim=-1)
    dirn = seg / torch.clamp(length, min=1e-12)[..., None]
    t_cand = scan.cumsum(-torch.log1p(-uniforms), dim=0) / sigma_maj
    x = start[None] + (torch.minimum(t_cand, length[None])[..., None]
                       * dirn[None])
    rho = density_at(field, x, cfg)
    f = torch.where(t_cand <= length[None], 1.0 - rho / sigma_maj, 1.0)
    return torch.where(length > 0.0, torch.prod(f, dim=0), 1.0)


def majorant_grid(grid: torch.Tensor, cells: Tuple[int, int, int]
                  ) -> torch.Tensor:
    """Dilated coarse max-density grid (cx, cy, cz) for local-majorant delta
    tracking: a 3^3 max dilation of the fine grid, a zero-padded block max
    into cells of ceil(N / c) voxels, and a 3^3 max dilation of the coarse
    grid, so maj[cell(q)] bounds the trilinear density anywhere within one
    cell edge of q. Raw density (multiply by density_factor at use). The
    JAX version's windows pad with 0; density is >= 0 and every window
    holds its centre, so max_pool3d's padding gives the same grid."""
    def dilate(g):
        return F.max_pool3d(g[None, None], 3, stride=1, padding=1)[0, 0]

    g = dilate(grid)
    f = [-(-n // c) for n, c in zip(grid.shape, cells)]
    g = F.pad(g, (0, cells[2] * f[2] - grid.shape[2],
                  0, cells[1] * f[1] - grid.shape[1],
                  0, cells[0] * f[0] - grid.shape[0]))
    g = g.reshape(cells[0], f[0], cells[1], f[1], cells[2], f[2])
    return dilate(g.amax(dim=(1, 3, 5)))
