"""Standalone offline path tracer with query-point export -- the reference's
``path-tracer.frag`` (+ fullscreen vert), the 'cache off' baseline and the
offline-NRC-training data generator.

Counterpart of ``neuralradiancecaching_tpu/render/offline_pathtracer.py``,
with every quirk of the reference kept: the sigma_s/sigma_e
parameterization with the scattering-integral form
``s_int = sigma_s * L_sun * (1 - t_r) / sigma_e`` (path-tracer.frag:305-319),
sun self-shadowing via exponentially-spaced secondary samples at
``exp(i - S)`` fractions with a last step of 1.0 (:161-195), Russian-roulette
selection of ONE internal path vertex per pixel whose (pos, dir) is exported
-- resetting the accumulated light so the pixel's color is the radiance AT
that vertex (:281-297), a transmittance < 0.01 early exit (:324-328),
survival decay 0.8 (:299), the full distance-to-exit step (:338-341),
exp(brightness) exposure (:349-352), and black (not the env map) on a miss
(:370-374).

The JAX masked ``lax.scan`` becomes a Python loop over ``max_bounces`` with
the same masks. Its draws come in through a seam: ``trace`` takes the
uniforms (max_bounces, 4, N) -- per bounce the Russian-roulette draw, the
HG ``u_cos`` and ``u_phi`` and the distance draw
(:func:`draw_offline_uniforms`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from neuralradiancecaching_tpu_torch.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import phase as phase_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops


@dataclass(frozen=True)
class OfflinePTConfig:
    """volumeData_t of path-tracer.frag:17-27 + loop constants."""

    sigma_s: float = 1.0
    sigma_e: float = 1.0
    brightness: float = 0.0
    max_bounces: int = 32            # TRUE_TRACE_SAMPLE_COUNT (:263)
    transmittance_steps: int = 16    # GetTransmittance count (:317)
    shadow_samples: int = 12         # SECONDARY_SAMPLE_COUNT (:50)
    rr_decay: float = 0.8            # totalTermProb *= 0.8 (:299)
    min_transmittance: float = 0.01  # early exit (:325)


class OfflinePTResult(NamedTuple):
    color: torch.Tensor       # (N, 3) outColor
    export_pos: torch.Tensor  # (N, 3) outPos: vertex pos / skySize.y (:292)
    export_dir: torch.Tensor  # (N, 2) outDir: (theta, phi) (:289-293)


def draw_offline_uniforms(generator: torch.Generator, cfg: OfflinePTConfig,
                          n: int) -> torch.Tensor:
    """The draws of :func:`trace` for n rays, on the generator's device:
    (max_bounces, 4, n) = per bounce (rr, u_cos, u_phi, dist)."""
    return torch.rand((cfg.max_bounces, 4, n), generator=generator,
                      device=generator.device)


def _export_angles(d: torch.Tensor) -> torch.Tensor:
    """theta = atan2(y, x); phi = atan2(|xy|, z) (path-tracer.frag:289-290)."""
    theta = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.atan2(torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2), d[..., 2])
    return torch.stack([theta, phi], dim=-1)


def self_shadowing(field: torch.Tensor, pos: torch.Tensor,
                   sun_dir: torch.Tensor, vol: VolumeConfig,
                   cfg: OfflinePTConfig) -> torch.Tensor:
    """get_self_shadowing (:161-195): transmittance toward the sun over
    exponentially-spaced sample points pos + (exit-pos)*exp(i - S).
    pos (N, 3) -> (N,)."""
    to_sun = -sun_dir / torch.linalg.vector_norm(sun_dir)
    _, exit_p, _ = volume_ops.entry_exit_points(
        pos, to_sun.expand(pos.shape), vol.box_size, vol.box_center)
    seg = exit_p - pos
    s = cfg.shadow_samples
    fracs = torch.exp(torch.arange(s, dtype=pos.dtype, device=pos.device)
                      - s)  # (S,)
    pts = pos[..., None, :] + fracs[:, None] * seg[..., None, :]  # (N, S, 3)
    dens = volume_ops.density_at(field, pts, vol)  # (N, S)
    # step sizes: distance to the next sample; last step = 1.0 (:181-184)
    deltas = ((fracs[1:] - fracs[:-1])[None, :]
              * torch.linalg.vector_norm(seg, dim=-1)[..., None])
    steps = torch.cat([deltas, torch.ones((*pos.shape[:-1], 1),
                                          dtype=pos.dtype,
                                          device=pos.device)], dim=-1)
    tau = torch.sum(torch.where(dens > 0.0, cfg.sigma_e * dens * steps, 0.0),
                    dim=-1)
    return torch.exp(-tau)


def _sigma_transmittance(field, start, end, steps, vol, sigma_e):
    """GetTransmittance with the sigma_e scaling (:237-261)."""
    seg = end - start
    length = torch.linalg.vector_norm(seg, dim=-1)
    step_size = length / steps
    fracs = torch.arange(steps, dtype=start.dtype,
                         device=start.device) / steps
    pts = start[..., None, :] + fracs[:, None] * seg[..., None, :]
    dens = volume_ops.density_at(field, pts, vol)
    t = torch.exp(-sigma_e * step_size * torch.sum(dens, dim=-1))
    return torch.where(length > 0.0, t, 1.0)


def trace(field: torch.Tensor, vol: VolumeConfig, cfg: OfflinePTConfig,
          sun_dir, sun_strength: float, ro: torch.Tensor, rd: torch.Tensor,
          uniforms: torch.Tensor) -> OfflinePTResult:
    """TrueTracePath (:264-346) over a ray batch (N, 3), (N, 3) through the
    density ``field``, a corner table or the raw grid; ``uniforms`` (max_bounces, 4, N) from
    :func:`draw_offline_uniforms`."""
    n = ro.shape[0]
    dtype, dev = ro.dtype, ro.device
    if tuple(uniforms.shape) != (cfg.max_bounces, 4, n):
        raise ValueError(f"uniforms {tuple(uniforms.shape)}, expected "
                         f"{(cfg.max_bounces, 4, n)}")
    sun_dir = torch.as_tensor(sun_dir, dtype=dtype, device=dev)
    sky_y = vol.box_size[1]  # outPos normalization skySize.y (:292)

    entry, _, hit = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                 vol.box_center)
    # default export: primary ray (main, :358-364)
    cur_pos, last_pos, cur_dir = entry, entry, rd
    scattered = torch.zeros((n, 3), dtype=dtype, device=dev)
    trans = torch.ones((n,), dtype=dtype, device=dev)
    term_prob = torch.ones((n,), dtype=dtype, device=dev)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)
    exp_pos, exp_dir = ro / sky_y, _export_angles(rd)

    for i in range(cfg.max_bounces):
        u_rr, u_cos, u_phi, u_dist = uniforms[i]
        # internal-path selection: reset light, export the vertex (:281-297)
        select = ~selected & (u_rr > term_prob) & ~done
        scattered = torch.where(select[:, None], 0.0, scattered)
        trans = torch.where(select, 1.0, trans)
        exp_pos = torch.where(select[:, None], cur_pos / sky_y, exp_pos)
        exp_dir = torch.where(select[:, None], _export_angles(cur_dir),
                              exp_dir)
        selected = selected | select
        term_prob = torch.where(done, term_prob, term_prob * cfg.rr_decay)

        density = volume_ops.density_at(field, cur_pos, vol)
        scatter = (density > 0.0) & ~done

        sun_phase = phase_ops.hg_phase(
            torch.sum(sun_dir * -cur_dir, dim=-1), vol.hg_g)
        shadow = self_shadowing(field, cur_pos, sun_dir, vol, cfg)
        sun_light = shadow * sun_phase * sun_strength
        sigma_s = density * cfg.sigma_s
        sigma_e = torch.clamp(density * cfg.sigma_e, min=1e-8)
        t_r = _sigma_transmittance(field, cur_pos, last_pos,
                                   cfg.transmittance_steps, vol, cfg.sigma_e)
        s_int = (sigma_s * sun_light * (1.0 - t_r)) / sigma_e  # (:319)

        scattered = scattered + torch.where(scatter, trans * s_int,
                                            0.0)[:, None]
        trans = torch.where(scatter, trans * t_r, trans)
        done = done | (scatter & (trans < cfg.min_transmittance))

        last_pos = torch.where(scatter[:, None], cur_pos, last_pos)
        new_dir = phase_ops.hg_direction_from_uniforms(u_cos, u_phi, cur_dir,
                                                       vol.hg_g)
        cur_dir = torch.where(scatter[:, None], new_dir, cur_dir)

        # full dist-to-exit step (:338-341) -- NOT the nrc 0.1 fraction
        _, t_exit, _ = volume_ops.ray_aabb(cur_pos, cur_dir, vol.box_size,
                                           vol.box_center)
        cur_pos = torch.where(done[:, None], cur_pos,
                              cur_pos + cur_dir
                              * (u_dist * torch.clamp(t_exit, min=0.0))
                              [:, None])

    color = scattered * math.exp(cfg.brightness)  # (:349-352)
    color = torch.where(hit[:, None], color, 0.0)  # black on miss (:370)
    return OfflinePTResult(color=color, export_pos=exp_pos,
                           export_dir=exp_dir)
