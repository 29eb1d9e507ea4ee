"""Baked light fields: exit optical depth and HG-convolved env in-scatter.

Counterpart of ``neuralradiancecaching_tpu/ops/lightfield.py``. Both fields
are built once per scene at voxel centres of ``vol.field_shape`` over
equirect direction buckets and corner-packed, so a query is ONE row gather
(nearest voxel) plus a bilinear blend over (theta, phi) with phi wrapping
and theta clamping:

* the tau field: tau(voxel -> box exit along a direction bucket centre),
  4 floats per row;
* the scatter field: S(voxel, d) = sum_q HG(d . c_q) T(voxel, c_q) P_q over
  exact per-cell env powers P_q, 12 floats per row.

The bakes march V x directions x steps density samples. The JAX version maps
over directions one at a time; here directions are batched in chunks sized
so a chunk holds at most ``CHUNK_SAMPLES`` samples, which bounds the
transient memory of the quadrature (a whole scatter-field bake in one batch
would need tens of GB). Every ray is independent, so the chunking does not
change any value. The premultiplied radiance field is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from neuralradiancecaching_tpu.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import phase as phase_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops

# most density samples one bake chunk holds (~2.7 GB of transients on the
# card at 2^24)
CHUNK_SAMPLES = 1 << 24


def _dir_from_theta_phi(theta: torch.Tensor, phi: torch.Tensor
                        ) -> torch.Tensor:
    """theta in [0, pi] (polar from +y), phi in [-pi, pi)."""
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), torch.cos(theta),
                        st * torch.sin(phi)], dim=-1)


def dir_to_theta_phi(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    return theta, phi


def _centers(n: int, device) -> torch.Tensor:
    """(n,) bucket centres (i + 0.5) / n."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n


def voxel_centers(vol: VolumeConfig, field_shape, device) -> torch.Tensor:
    """(V, 3) world positions of the field's voxel centres, x-major."""
    ax = [_centers(n, device) - 0.5 for n in field_shape]
    gx, gy, gz = torch.meshgrid(*ax, indexing="ij")
    size = torch.tensor(vol.box_size, dtype=torch.float32, device=device)
    center = torch.tensor(vol.box_center, dtype=torch.float32, device=device)
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3) * size + center


def bucket_dirs(n_theta: int, n_phi: int, device) -> torch.Tensor:
    """(n_theta * n_phi, 3) equirect bucket-centre directions, theta-major."""
    th = _centers(n_theta, device) * math.pi
    ph = (_centers(n_phi, device) * 2.0 - 1.0) * math.pi
    tt, pp = torch.meshgrid(th, ph, indexing="ij")
    return _dir_from_theta_phi(tt, pp).reshape(-1, 3)


def dir_chunks(dirs: torch.Tensor, samples_per_dir: int):
    """Split (D, 3) directions into chunks of at most CHUNK_SAMPLES samples."""
    return torch.split(dirs, max(1, CHUNK_SAMPLES // max(samples_per_dir, 1)))


def ray_grid(pts: torch.Tensor, dirs: torch.Tensor):
    """Every (direction, point) pair as flat rays: (C*V, 3) points and dirs,
    direction-major."""
    c, v = dirs.shape[0], pts.shape[0]
    p = pts[None].expand(c, v, 3).reshape(-1, 3)
    d = dirs[:, None].expand(c, v, 3).reshape(-1, 3)
    return p, d


def exit_transmittance(density_field: torch.Tensor, pts: torch.Tensor,
                       dirs: torch.Tensor, steps: int, vol: VolumeConfig
                       ) -> torch.Tensor:
    """(D, V) transmittance from every point to the box exit along every
    direction, by the fixed-step quadrature, chunked over directions."""
    out = []
    for dc in dir_chunks(dirs, pts.shape[0] * steps):
        p, d = ray_grid(pts, dc)
        _, exit_p, _ = volume_ops.entry_exit_points(p, d, vol.box_size,
                                                    vol.box_center)
        out.append(volume_ops.transmittance(density_field, p, exit_p, steps,
                                            vol).reshape(dc.shape[0], -1))
    return torch.cat(out, dim=0)


def corner_pack(grid: torch.Tensor) -> torch.Tensor:
    """(V, NT, NP, C) -> (V, NT, NP, 4C): the (theta, phi) bilinear patch
    [g(it,ip), g(it,ip+1), g(it+1,ip), g(it+1,ip+1)] per bucket, phi wrapping
    and theta clamping."""
    up = torch.cat([grid[:, 1:], grid[:, -1:]], dim=1)
    return torch.cat([grid, torch.roll(grid, -1, dims=2), up,
                      torch.roll(up, -1, dims=2)], dim=-1)


def build_transmittance_field(density_field: torch.Tensor, vol: VolumeConfig,
                              steps: int = 16,
                              field_shape: Tuple[int, int, int] | None = None
                              ) -> torch.Tensor:
    """(V * NT * NP, 4) corner-packed exit-tau rows, (NT, NP) =
    vol.field_dir_buckets, V = prod(field_shape)."""
    field_shape = field_shape or vol.field_shape
    n_theta, n_phi = vol.field_dir_buckets
    device = density_field.device
    pts = voxel_centers(vol, field_shape, device)
    t = exit_transmittance(density_field, pts,
                           bucket_dirs(n_theta, n_phi, device), steps, vol)
    # store OPTICAL DEPTH: it interpolates far better than T; exp() at query
    tau = torch.clamp(-torch.log(torch.clamp(t, min=1e-20)), max=40.0)
    tau = tau.T.reshape(-1, n_theta, n_phi, 1)  # (V, T, P, 1)
    return corner_pack(tau).reshape(-1, 4)


def bucket_rows(pos: torch.Tensor, d: torch.Tensor, vol: VolumeConfig,
                field_shape, n_theta: int, n_phi: int):
    """Row index of the nearest voxel's (theta, phi) bucket patch and the
    bilinear weights (wt, wp) for (pos, d) (..., 3)."""
    nx, ny, nz = field_shape
    uvw = volume_ops.world_to_uvw(pos, vol.box_size, vol.box_center)
    shape = torch.tensor(field_shape, device=pos.device)
    ijk = (uvw * shape.to(uvw.dtype)).to(torch.int64)
    ijk = torch.minimum(torch.clamp(ijk, min=0), shape - 1)
    vox = ijk[..., 0] * (ny * nz) + ijk[..., 1] * nz + ijk[..., 2]

    theta, phi = dir_to_theta_phi(d)
    ft = theta / math.pi * n_theta - 0.5
    fp = (phi / math.pi + 1.0) * 0.5 * n_phi - 0.5
    it0 = torch.floor(ft)
    ip0 = torch.floor(fp)
    # theta edge: both corners clamp to the same bucket -> force wt = 0/1
    wt = torch.clamp(ft - it0, 0.0, 1.0)
    wt = torch.where(it0 < 0, 0.0, wt)
    wp = fp - ip0
    it0c = torch.clamp(it0.to(torch.int64), 0, n_theta - 1)
    ip0i = torch.remainder(ip0.to(torch.int64), n_phi)  # jnp.mod semantics
    return vox * (n_theta * n_phi) + it0c * n_phi + ip0i, wt, wp


def query_tau_field(field: torch.Tensor, pos: torch.Tensor, d: torch.Tensor,
                    vol: VolumeConfig,
                    field_shape: Tuple[int, int, int] | None = None
                    ) -> torch.Tensor:
    """Optical depth tau(pos -> exit along d). pos/d: (..., 3) -> (...,)."""
    idx, wt, wp = bucket_rows(pos, d, vol, field_shape or vol.field_shape,
                              *vol.field_dir_buckets)
    rows = field[idx].to(pos.dtype)  # (..., 4)
    c00, c01, c10, c11 = (rows[..., 0], rows[..., 1], rows[..., 2],
                          rows[..., 3])
    top = c00 + (c01 - c00) * wp
    bot = c10 + (c11 - c10) * wp
    return top + (bot - top) * wt


def segment_transmittance_field(field: torch.Tensor, a: torch.Tensor,
                                b: torch.Tensor, vol: VolumeConfig,
                                field_shape: Tuple[int, int, int] | None = None
                                ) -> torch.Tensor:
    """Transmittance of the segment a -> b from the exit-tau field:
    tau(a -> b) = tau(a -> exit along d) - tau(b -> exit along d)."""
    field_shape = field_shape or vol.field_shape
    seg = b - a
    length = torch.linalg.vector_norm(seg, dim=-1)
    d = seg / torch.clamp(length, min=1e-12)[..., None]
    tau = (query_tau_field(field, a, d, vol, field_shape)
           - query_tau_field(field, b, d, vol, field_shape))
    t = torch.exp(-torch.clamp(tau, min=0.0))
    return torch.where(length > 0.0, t, 1.0)


def env_cell_integrals(env_image: torch.Tensor, n_theta: int, n_phi: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-cell env integrals over the (theta, phi) quadrature grid.

    Returns ``(power, cdirs)``: ``power[q, 3]``, the sin-weighted texel sum of
    Env over cell q, and ``cdirs[q, 3]``, the cell's luminance-weighted mean
    direction (its geometric centre for dark cells). ``jax.ops.segment_sum``
    becomes ``index_add_`` (on the card in atomic order).
    """
    device = env_image.device
    h, w = env_image.shape[0], env_image.shape[1]
    theta = math.pi * (1.0 - _centers(h, device))  # polar from +y
    phi = (_centers(w, device) * 2.0 - 1.0) * math.pi
    dom = torch.sin(theta) * (math.pi / h) * (2.0 * math.pi / w)  # (H,)
    tcell = torch.clamp((theta / math.pi * n_theta).to(torch.int64),
                        0, n_theta - 1)
    pcell = torch.clamp(((phi / math.pi + 1.0) * 0.5 * n_phi)
                        .to(torch.int64), 0, n_phi - 1)
    seg = (tcell[:, None] * n_phi + pcell[None, :]).reshape(-1)  # (H*W,)
    q = n_theta * n_phi
    w_rgb = env_image.to(torch.float32) * dom[:, None, None]  # (H, W, 3)
    zeros = torch.zeros((q, 3), dtype=torch.float32, device=device)
    power = zeros.index_add(0, seg, w_rgb.reshape(-1, 3))
    lum = (w_rgb[..., 0] * 0.2126 + w_rgb[..., 1] * 0.7152
           + w_rgb[..., 2] * 0.0722)
    tt, pp = torch.meshgrid(theta, phi, indexing="ij")
    dirs = _dir_from_theta_phi(tt, pp).reshape(-1, 3)
    m = zeros.index_add(0, seg, dirs * lum.reshape(-1, 1))
    cdirs0 = bucket_dirs(n_theta, n_phi, device)
    norm = torch.linalg.vector_norm(m, dim=1, keepdim=True)
    cdirs = torch.where(norm > 1e-12, m / torch.clamp(norm, min=1e-30),
                        cdirs0)
    return power, cdirs


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full fp32 on the card too: TF32 keeps ~3 decimal digits."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def build_scatter_field(density_field: torch.Tensor, env_image: torch.Tensor,
                        vol: VolumeConfig, hg_g: float, steps: int = 16,
                        field_shape: Tuple[int, int, int] | None = None,
                        quad_dirs: Tuple[int, int] | None = None
                        ) -> torch.Tensor:
    """(V * LT * LP, 12) corner-packed rows of the HG-convolved env in-scatter
    radiance (without the hpm strength), (LT, LP) = vol.field_out_buckets.

    S_o = sum_q HG(o . c_q) T(c_q) P_q / (2 pi) over the quadrature cells of
    ``quad_dirs`` (default vol.field_dir_buckets), with exact cell powers P_q
    and T, HG sampled at each cell's power centroid c_q.
    """
    field_shape = field_shape or vol.field_shape
    l_theta, l_phi = vol.field_out_buckets
    device = density_field.device
    pts = voxel_centers(vol, field_shape, device)
    n_theta, n_phi = quad_dirs or vol.field_dir_buckets
    env_power, qdirs = env_cell_integrals(env_image, n_theta, n_phi)
    t = exit_transmittance(density_field, pts, qdirs, steps, vol)  # (Q, V)

    odirs = bucket_dirs(l_theta, l_phi, device)  # (O, 3)
    cos = (odirs[:, None, :] * qdirs[None, :, :]).sum(-1)  # (O, Q)
    # the reference's HG is mu-normalized (integrates to 2 pi over solid
    # angle); the MC estimator this replaces averages under HG / (2 pi)
    w = phase_ops.hg_phase(cos, hg_g) / (2.0 * math.pi)
    scatter = torch.stack([_matmul_f32(w * env_power[:, c][None, :], t)
                           for c in range(3)], dim=-1)  # (O, V, 3)
    scatter = scatter.permute(1, 0, 2).reshape(-1, l_theta, l_phi, 3)
    return corner_pack(scatter).reshape(-1, 12)


def query_radiance_field(field: torch.Tensor, pos: torch.Tensor,
                         d: torch.Tensor, vol: VolumeConfig,
                         field_shape: Tuple[int, int, int] | None = None
                         ) -> torch.Tensor:
    """Radiance-field rgb at pos for direction d: one 12-float row gather +
    (theta, phi) bilinear over vol.field_out_buckets. (..., 3)."""
    idx, wt, wp = bucket_rows(pos, d, vol, field_shape or vol.field_shape,
                              *vol.field_out_buckets)
    rows = field[idx].to(pos.dtype)  # (..., 12)
    c00, c01 = rows[..., 0:3], rows[..., 3:6]
    c10, c11 = rows[..., 6:9], rows[..., 9:12]
    wp = wp[..., None]
    top = c00 + (c01 - c00) * wp
    bot = c10 + (c11 - c10) * wp
    return top + (bot - top) * wt[..., None]
