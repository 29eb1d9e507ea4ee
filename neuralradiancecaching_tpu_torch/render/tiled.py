"""Banded rendering of the production frame: the walk per row band with the
shade and the cache query deferred to one frame-global pass, over the
pose-static live-ray pack.

Counterpart of ``neuralradiancecaching_tpu/render/tiled.py`` for the cached
render (``RenderConfig.use_nn``) at one sample per pixel. The JAX package
maps a band program over row bands (``lax.map``) so that its transients
stay band-sized on the TPU. On the card one frame's bands fit in one call,
so the port marches every band in ONE batched walk -- lane for lane the
same walk, since the NN-mode walk has no cross-lane step. ``band_rows``
still sets the pack's rounding to whole bands and the layout of the
walk's random draws: band i draws its own (k_steps, 4, band_rows * width)
block, JAX's ``uniform(fold_in(band_key, 0), ...)`` with the band key
``fold_in(key, i)`` in the packed branch and ``fold_in(key, i *
band_rows)`` in the unpacked one. The deferred shade draws nothing, so a
frame is a deterministic function of those uniforms (``uniforms``, or
drawn from a ``torch.Generator``).

Pose-static hoists, as in the JAX package's progressive loop: the direct
env colour (:func:`frame_env_color`), the exact entry optical depth
(:func:`frame_entry_tau`) and the live-ray pack (:func:`frame_live_pack`,
which carries the packed entry tau) are computed once per camera pose and
passed to :func:`render_banded`; the oct bake once per cache state.

Not ported: ``render_tiled`` (the host band loop), spp > 1, the
cache-off banded render and the banded render of the reference and delta
samplers (all raise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.ops import compact, lightfield
from neuralradiancecaching_tpu_torch.ops import envmap as envmap_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops
from neuralradiancecaching_tpu_torch.render import pathtrace
from neuralradiancecaching_tpu_torch.scene.camera import pixel_rays
from neuralradiancecaching_tpu_torch.scene.scene import Scene


class LivePack(NamedTuple):
    """The pose-static live-ray pack (the JAX tuple's order)."""
    sel: torch.Tensor   # (capm,) packed slot -> pixel ray
    val: torch.Tensor   # (capm,) bool: slot holds a live ray
    ro_p: torch.Tensor  # (n_bands_p, band_n, 3) packed origins
    rd_p: torch.Tensor  # (n_bands_p, band_n, 3) packed directions
    inv: torch.Tensor   # (n,) pixel ray -> packed slot, capm if not packed
    et_p: torch.Tensor  # (n_bands_p, band_n) exact entry tau, 0 on padding


def _rays(scene: Scene, cfg: NRCConfig):
    return pixel_rays(scene.camera, cfg.render.width, cfg.render.height)


def frame_env_color(scene: Scene, cfg: NRCConfig) -> torch.Tensor:
    """Direct env radiance per pixel (N, 3) for the current camera: static
    per camera pose."""
    _, rd = _rays(scene, cfg)
    return envmap_ops.sample_direct(scene.env, rd, hpm=False)


def _entry_tau(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
               rd: torch.Tensor) -> torch.Tensor:
    """The ``entry_tau_steps`` quadrature of the optical depth from each
    ray's box entry to its exit, clamped to [0, 40]."""
    vol = cfg.volume
    entry, exit_p, _ = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                    vol.box_center)
    t_e = volume_ops.transmittance(scene.density, entry, exit_p,
                                   cfg.path.entry_tau_steps, vol)
    return torch.clamp(-torch.log(torch.clamp(t_e, min=1e-20)), max=40.0)


def frame_entry_tau(scene: Scene, cfg: NRCConfig) -> torch.Tensor:
    """Exact entry optical depth per pixel ray (N,) for the current pose;
    zeros when ``entry_tau_steps`` is 0 (the walk then keeps the row
    tau)."""
    ro, rd = _rays(scene, cfg)
    if cfg.path.entry_tau_steps <= 0 or cfg.path.sampler != "collision":
        return torch.zeros((ro.shape[0],), dtype=ro.dtype, device=ro.device)
    return _entry_tau(scene, cfg, ro, rd)


def _live_mask(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
               rd: torch.Tensor) -> torch.Tensor:
    """Rays that hit the box with a baked entry tau above
    ``live_tau_threshold`` (deterministic per pose: no random draw)."""
    vol = cfg.volume
    entry, _, hit = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                 vol.box_center)
    tau0 = lightfield.query_tau_field(scene.env_t_field, entry, rd, vol)
    return hit & (tau0 > cfg.render.live_tau_threshold)


def live_fraction(scene: Scene, cfg: NRCConfig) -> float:
    """The exact fraction of live pixel rays for the current pose (a count
    over the ray count): any ``live_pack_fraction`` at or above it packs
    without a drop."""
    live = _live_mask(scene, cfg, *_rays(scene, cfg))
    return int(live.sum()) / live.numel()


def frame_live_pack(scene: Scene, cfg: NRCConfig,
                    band_rows: int = 54) -> LivePack:
    """The pose-static live-ray pack for the packed banded frame: the live
    rays (:func:`_live_mask`) packed in pixel order to ``live_pack_fraction``
    of the frame rounded up to whole bands (the highest rays drop when
    that is too few), the packed rays, their exact entry tau and the
    inverse map that un-packs a frame with one gather."""
    h, w = cfg.render.height, cfg.render.width
    n = h * w
    ro, rd = _rays(scene, cfg)
    live = _live_mask(scene, cfg, ro, rd)
    band_n = band_rows * w
    n_bands_p = max(1, -(-int(n * cfg.render.live_pack_fraction) // band_n))
    capm = min(n_bands_p * band_n, n)
    sel, val = compact.compact_select(live, capm)
    ro_p, rd_p = ro[sel], rd[sel]
    if cfg.path.entry_tau_steps > 0 and cfg.path.sampler == "collision":
        et_p = torch.where(val, _entry_tau(scene, cfg, ro_p, rd_p), 0.0)
    else:
        et_p = torch.zeros((capm,), dtype=ro.dtype, device=ro.device)
    return LivePack(sel, val, ro_p.reshape(-1, band_n, 3),
                    rd_p.reshape(-1, band_n, 3),
                    compact.inverse_select(n, sel, val),
                    et_p.reshape(-1, band_n))


def band_uniform_shape(cfg: NRCConfig, n_bands: int, band_n: int):
    """(n_bands, k_steps, 4, band_n): the walk's uniforms, one block per
    band (the JAX band walk's own draw)."""
    return (n_bands, *pathtrace.walk_uniform_shapes(cfg, band_n,
                                                    use_nn=True)[0])


def _walk_bands(scene: Scene, cfg: NRCConfig, ro_b: torch.Tensor,
                rd_b: torch.Tensor, entry_tau: torch.Tensor,
                generator: Optional[torch.Generator],
                uniforms: Optional[torch.Tensor]):
    """render_band_deferred over (n_bands, band_n) rays as one batched walk;
    band i walks with uniforms[i]."""
    n_bands, band_n = ro_b.shape[:2]
    shape = band_uniform_shape(cfg, n_bands, band_n)
    if uniforms is None:
        uniforms = torch.rand(shape, generator=generator, dtype=ro_b.dtype,
                              device=ro_b.device)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms must be {shape}, got "
                         f"{tuple(uniforms.shape)}")
    # (bands, k, 4, band_n) -> (k, 4, bands * band_n): lanes band-major
    u = uniforms.permute(1, 2, 0, 3).reshape(shape[1], shape[2], -1)
    return pathtrace.render_band_deferred(
        scene, cfg, ro_b.reshape(-1, 3), rd_b.reshape(-1, 3), None,
        entry_tau=entry_tau.reshape(-1), uniforms=u)


def _bands_program(scene: Scene, generator: Optional[torch.Generator],
                   cfg: NRCConfig, band_rows: int,
                   entry_tau: Optional[torch.Tensor] = None,
                   uniforms: Optional[torch.Tensor] = None):
    """The unpacked banded walk over every pixel ray, queries and shade
    deferred."""
    h, w = cfg.render.height, cfg.render.width
    ro, rd = _rays(scene, cfg)
    if entry_tau is None:
        entry_tau = frame_entry_tau(scene, cfg)  # pose-static: hoist it
    n_bands = h // band_rows
    return _walk_bands(scene, cfg, ro.reshape(n_bands, band_rows * w, 3),
                       rd.reshape(n_bands, band_rows * w, 3), entry_tau,
                       generator, uniforms)


def _finish(state: nrc.NRCState, baked: torch.Tensor, scene: Scene, rgb,
            trans, q_pos, q_dir, q_w, ev, cfg: NRCConfig, env_rgb=None):
    query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    _, rd = _rays(scene, cfg)
    return pathtrace.finish_deferred(scene, cfg, rd, rgb, trans, q_pos,
                                     q_dir, q_w, query_fn, events=ev,
                                     env_rgb=env_rgb)


def _packed_bands_program(scene: Scene, generator: Optional[torch.Generator],
                          cfg: NRCConfig, band_rows: int,
                          pack: Optional[LivePack] = None,
                          uniforms: Optional[torch.Tensor] = None):
    """The banded walk over the packed live rays only (the rest are exactly
    T0 = 1, pure env). pack: :func:`frame_live_pack`, built here when
    None. Padding lanes march the duplicate of packed slot 0's ray; their
    query weights and events are masked."""
    if pack is None:
        pack = frame_live_pack(scene, cfg, band_rows)
    rgb, trans, qp, qd, qw, ev = _walk_bands(scene, cfg, pack.ro_p,
                                             pack.rd_p, pack.et_p,
                                             generator, uniforms)
    qw = torch.where(pack.val, qw, 0.0)
    if ev.shape[1] > 0:
        ev = ev.masked_fill(~pack.val[:, None, None], 0.0)
    return pack.inv, rgb, trans, qp, qd, qw, ev


def _finish_packed(state: nrc.NRCState, baked: torch.Tensor, scene: Scene,
                   inv, rgb_p, trans_p, qp, qd, qw, ev, cfg: NRCConfig,
                   env_rgb=None):
    """The frame-global shade and query over the packed lanes (caps
    relative to the whole frame), the un-pack as one (n, 4) gather through
    the inverse map (rays not packed: rgb 0, T0 1), and the env
    composite."""
    query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    n = cfg.render.width * cfg.render.height
    rgb_p = pathtrace.shade_and_query(scene, cfg, rgb_p, qp, qd, qw,
                                      query_fn, events=ev, cap_n=n)
    rgbt = torch.cat([rgb_p, trans_p[:, None]], dim=1)
    out = compact.gather_back(inv, rgbt, [0.0, 0.0, 0.0, 1.0])
    if env_rgb is None:
        env_rgb = frame_env_color(scene, cfg)
    return out[:, :3] + out[:, 3:4] * env_rgb


def render_banded(state: nrc.NRCState, scene: Scene,
                  generator: Optional[torch.Generator], cfg: NRCConfig,
                  band_rows: int = 54, env_rgb: Optional[torch.Tensor] = None,
                  baked: Optional[torch.Tensor] = None,
                  pack: Optional[LivePack] = None,
                  entry_tau: Optional[torch.Tensor] = None,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cached frame (H, W, 3): the banded walk with the shade and the
    query deferred, then the frame-global finish. With
    ``live_pack_fraction`` > 0 (and the deferred shade) only the packed
    live rays march.

    env_rgb: :func:`frame_env_color` (pose-static). baked: ``nrc.bake``
    of the state (once per cache state). pack: :func:`frame_live_pack` with
    the same band_rows (pose-static; carries the packed entry tau).
    entry_tau: :func:`frame_entry_tau` for the unpacked branch. Each is
    computed here when None. uniforms: the walk's draws, shaped
    :func:`band_uniform_shape` for the packed (n_bands_p) or unpacked
    (H / band_rows) bands; drawn from ``generator`` when None.
    """
    h, w = cfg.render.height, cfg.render.width
    if h % band_rows:
        raise ValueError(f"height {h} is not a multiple of band_rows "
                         f"{band_rows}")
    if not cfg.render.use_nn:
        raise NotImplementedError("the cache-off banded render is not "
                                  "ported yet")
    if cfg.path.sampler != "collision":
        raise NotImplementedError(f"the banded render of sampler="
                                  f"{cfg.path.sampler!r} is not ported")
    if cfg.render.spp != 1:
        raise NotImplementedError("spp > 1 is not ported yet")
    if baked is None:
        baked = nrc.bake(state, cfg)
    if (cfg.render.live_pack_fraction > 0.0
            and pathtrace.shade_deferred(cfg)
            and not cfg.render.show_non_nn):
        inv, rgb_p, trans_p, qp, qd, qw, ev = _packed_bands_program(
            scene, generator, cfg, band_rows, pack, uniforms)
        out = _finish_packed(state, baked, scene, inv, rgb_p, trans_p, qp,
                             qd, qw, ev, cfg, env_rgb)
    else:
        rgb, trans, qp, qd, qw, ev = _bands_program(
            scene, generator, cfg, band_rows, entry_tau, uniforms)
        out = _finish(state, baked, scene, rgb, trans, qp, qd, qw, ev, cfg,
                      env_rgb)
    return out.reshape(h, w, 3)
