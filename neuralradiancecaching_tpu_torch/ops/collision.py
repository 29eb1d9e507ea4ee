"""Collision field: baked free-flight distance sampling for the path walk.

Counterpart of ``neuralradiancecaching_tpu/ops/collision.py``. For every
(voxel, direction bucket) of the tau-field discretization one row holds

    [tau_c00, tau_c01, tau_c10, tau_c11,  t(0), t(1/3), t(2/3), t(1)]

-- the (theta, phi) bilinear corners of the total optical depth to the box
exit, then the distances at which the cumulative optical depth reaches
q * tau_total. Sampling a scatter distance is one row gather plus an
inverse-CDF lookup over the 4 knots (:func:`knots_to_distance`,
:func:`sample_collision`).

The bake is chunked over directions like the light fields
(ops/lightfield.py). Cumulative profiles use the fixed summation order of
ops/scan.py, so the knots equal the JAX bake's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from neuralradiancecaching_tpu_torch.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import lightfield
from neuralradiancecaching_tpu_torch.ops import scan
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops

N_KNOTS = 4  # quantile knots at q = 0, 1/3, 2/3, 1
ROW_WIDTH = 4 + N_KNOTS


def _profile(density_field: torch.Tensor, pts: torch.Tensor,
             dn: torch.Tensor, steps: int, vol: VolumeConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Total optical depth (R,) and quantile knots (R, N_KNOTS) of the rays
    (pts, dn) (R, 3) to the box exit, by a midpoint quadrature."""
    dev = pts.device
    _, t_exit, _ = volume_ops.ray_aabb(pts, dn, vol.box_size, vol.box_center)
    t_exit = torch.clamp(t_exit, min=1e-6)
    dt = t_exit / steps
    frac = (torch.arange(steps, dtype=torch.float32, device=dev) + 0.5) / steps
    sp = pts[:, None, :] + (frac[None, :, None]
                            * t_exit[:, None, None]) * dn[:, None, :]
    sigma = volume_ops.density_at(density_field, sp, vol)  # (R, S)
    cum = scan.cumsum(sigma, dim=1) * dt[:, None]  # tau at (j+1)*dt
    tau_total = cum[:, -1]

    # knot 0: distance of the FIRST nonzero-density sample (left edge)
    has = sigma > 0.0
    first = torch.argmax(has.to(torch.uint8), dim=1)
    t0 = torch.where(has.any(dim=1), first.to(torch.float32) * dt, 0.0)

    # knots q > 0: invert the piecewise-linear cumulative profile
    qs = torch.arange(N_KNOTS, dtype=torch.float32, device=dev) / (N_KNOTS - 1)
    target = qs[None, 1:] * tau_total[:, None]  # (R, J-1)
    j = torch.sum(cum[:, None, :] < target[:, :, None], dim=-1)
    j = torch.clamp(j, max=steps - 1)
    cum_pad = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    lo = torch.gather(cum_pad, 1, j)  # cum_{j-1}
    hi = torch.gather(cum, 1, j)      # cum_j
    w = (target - lo) / torch.clamp(hi - lo, min=1e-20)
    tq = (j.to(torch.float32) + torch.clamp(w, 0.0, 1.0)) * dt[:, None]
    knots = torch.cat([t0[:, None], tq], dim=1)
    knots = torch.where(tau_total[:, None] > 0.0, knots, 0.0)
    return tau_total, knots


def build_collision_field(density_field: torch.Tensor, vol: VolumeConfig,
                          steps: int = 48,
                          field_shape: Tuple[int, int, int] | None = None
                          ) -> torch.Tensor:
    """(V * NT * NP, 8) rows; V = prod(field_shape), (NT, NP) =
    vol.field_dir_buckets. Tau corners are packed like the tau field."""
    field_shape = field_shape or vol.field_shape
    n_theta, n_phi = vol.field_dir_buckets
    device = density_field.device
    pts = lightfield.voxel_centers(vol, field_shape, device)
    dirs = lightfield.bucket_dirs(n_theta, n_phi, device)
    taus, knots = [], []
    for dc in lightfield.dir_chunks(dirs, pts.shape[0] * steps):
        p, d = lightfield.ray_grid(pts, dc)
        tau_c, knots_c = _profile(density_field, p, d, steps, vol)
        taus.append(tau_c)
        knots.append(knots_c)
    v = pts.shape[0]
    tau = torch.clamp(torch.cat(taus).reshape(-1, v), max=40.0)  # (D, V)
    tau4 = lightfield.corner_pack(tau.T.reshape(-1, n_theta, n_phi, 1))
    kn = torch.cat(knots).reshape(-1, v, N_KNOTS).permute(1, 0, 2)
    kn = kn.reshape(-1, n_theta, n_phi, N_KNOTS)  # (V, T, P, J)
    return torch.cat([tau4, kn], dim=-1).reshape(-1, ROW_WIDTH)


def query_collision_rows(field: torch.Tensor, pos: torch.Tensor,
                         d: torch.Tensor, vol: VolumeConfig,
                         field_shape: Tuple[int, int, int] | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One row gather -> (tau_total bilinear over (theta, phi), knots (.., J)
    of the nearest bucket). pos/d: (..., 3)."""
    idx, wt, wp = lightfield.bucket_rows(
        pos, d, vol, field_shape or vol.field_shape, *vol.field_dir_buckets)
    rows = field[idx].to(pos.dtype)  # (..., 8)
    c00, c01, c10, c11 = (rows[..., 0], rows[..., 1], rows[..., 2],
                          rows[..., 3])
    top = c00 + (c01 - c00) * wp
    bot = c10 + (c11 - c10) * wp
    return top + (bot - top) * wt, rows[..., 4:]


def sample_collision(field: torch.Tensor, pos: torch.Tensor, d: torch.Tensor,
                     u: torch.Tensor, vol: VolumeConfig,
                     field_shape: Tuple[int, int, int] | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A scatter distance along (pos, d) by the exact inverse CDF of the
    baked profile. u: (...,) uniforms. Returns (t, p_scatter): the distance
    (conditioned on scattering) and the analytic scatter probability
    1 - exp(-tau_total); zero-tau rays give (0, 0)."""
    tau, knots = query_collision_rows(field, pos, d, vol, field_shape)
    return knots_to_distance(tau, knots, u), -torch.expm1(-tau)


def knots_to_distance(tau: torch.Tensor, knots: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Invert the quantile knots: u ~ U[0,1) -> scatter distance, via the
    truncated-exponential draw tau* = -log1p(-u * p_scatter) in [0, tau)."""
    p_sc = -torch.expm1(-tau)
    tau_star = -torch.log1p(-u * p_sc)
    q = torch.clamp(tau_star / torch.clamp(tau, min=1e-12), 0.0, 1.0)
    f = q * (N_KNOTS - 1)
    i = torch.clamp(torch.floor(f).to(torch.int64), 0, N_KNOTS - 2)
    frac = f - i.to(f.dtype)
    k0, k1, k2, k3 = (knots[..., 0], knots[..., 1], knots[..., 2],
                      knots[..., 3])
    lo = torch.where(i == 0, k0, torch.where(i == 1, k1, k2))
    hi = torch.where(i == 0, k1, torch.where(i == 1, k2, k3))
    return lo + frac * (hi - lo)
