"""Banded rendering of large frames: the walk per row band with the shade
and the cache query deferred to one frame-global pass, over the
pose-static live-ray pack when that is on.

Counterpart of ``neuralradiancecaching_tpu/render/tiled.py``. The JAX
package maps a band program over row bands (``lax.map``) so that its
transients stay band-sized. The port does the same -- a Python loop over
the bands -- wherever the band's walk has a cross-lane step whose cap is
per band: the cache-off ``render_image`` (the collision cascade, the delta
split, the reference march), and the cached walk that shades in the band
(the reference sampler, or delta and collision without the deferred
shade: the reference march's repack, the compacted or prefix-packed
shade). The collect walk of the collision and delta samplers (the
deferred shade) has no cross-lane step, so the port marches every band in
ONE batched walk, lane for lane the same. spp > 1 with the cache on runs
spp sample-major virtual copies of the bands and averages after the
finish; with the cache off ``render_image`` averages its own samples.

``band_rows`` sets the bands, the pack's rounding to whole bands and the
layout of the random draws: band i draws as the JAX band walk with the
band key ``fold_in(key, i)`` in the packed branch and ``fold_in(key, i *
band_rows)`` otherwise (``uniforms``, or drawn from a
``torch.Generator``). The deferred shade draws nothing.

Pose-static hoists, as in the JAX package's progressive loop: the direct
env colour (:func:`frame_env_color`), the exact entry optical depth
(:func:`frame_entry_tau`) and the live-ray pack (:func:`frame_live_pack`,
which carries the packed entry tau) are computed once per camera pose and
passed to :func:`render_banded`; the oct bake once per cache state.

:func:`render_tiled` is the JAX package's host band loop: the same band
walks, without the hoists and the pack.
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
from neuralradiancecaching_tpu_torch.utils import profiling


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


@profiling.spanned("hoist.env")
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


def rays_entry_tau(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                   rd: torch.Tensor) -> torch.Tensor:
    """Exact entry optical depth per ray (N,) of the collision walk; zeros
    when ``entry_tau_steps`` is 0 or the sampler is not 'collision' (the
    walk then keeps the row tau)."""
    if cfg.path.entry_tau_steps <= 0 or cfg.path.sampler != "collision":
        return torch.zeros((ro.shape[0],), dtype=ro.dtype, device=ro.device)
    return _entry_tau(scene, cfg, ro, rd)


def frame_entry_tau(scene: Scene, cfg: NRCConfig) -> torch.Tensor:
    """:func:`rays_entry_tau` of every pixel ray for the current pose."""
    return rays_entry_tau(scene, cfg, *_rays(scene, cfg))


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


@profiling.spanned("hoist.pack")
def frame_live_pack(scene: Scene, cfg: NRCConfig, band_rows: int = 54,
                    multiple_of: int = 1) -> LivePack:
    """The pose-static live-ray pack for the packed banded frame: the live
    rays (:func:`_live_mask`) packed in pixel order to ``live_pack_fraction``
    of the frame rounded up to whole bands (the highest rays drop when
    that is too few), the packed rays, their exact entry tau and the
    inverse map that un-packs a frame with one gather.

    multiple_of: round the packed band count up to a multiple of it (the
    world size of the data-parallel packed render, whose ranks take whole
    packed bands). The extra bands are padding, so a drop-free pack with
    multiple_of=N equals the multiple_of=1 pack on its valid lanes."""
    h, w = cfg.render.height, cfg.render.width
    n = h * w
    ro, rd = _rays(scene, cfg)
    live = _live_mask(scene, cfg, ro, rd)
    band_n = band_rows * w
    n_bands_p = max(1, -(-int(n * cfg.render.live_pack_fraction) // band_n))
    n_bands_p = -(-n_bands_p // multiple_of) * multiple_of
    capm = min(n_bands_p * band_n, n)
    sel, val = compact.compact_select(live, capm, site="live_pack")
    ro_p, rd_p = ro[sel], rd[sel]
    if cfg.path.entry_tau_steps > 0 and cfg.path.sampler == "collision":
        et_p = torch.where(val, _entry_tau(scene, cfg, ro_p, rd_p), 0.0)
    else:
        et_p = torch.zeros((capm,), dtype=ro.dtype, device=ro.device)
    return LivePack(sel, val, ro_p.reshape(-1, band_n, 3),
                    rd_p.reshape(-1, band_n, 3),
                    compact.inverse_select(n, sel, val),
                    et_p.reshape(-1, band_n))


def _per_band(uniforms, n_bands: int) -> list:
    """The per-band draws: None (each band draws from the generator) or one
    entry per band."""
    if uniforms is None:
        return [None] * n_bands
    if len(uniforms) != n_bands:
        raise ValueError(f"{n_bands} bands need {n_bands} sets of uniforms, "
                         f"got {len(uniforms)}")
    return list(uniforms)


def _tile(x: torch.Tensor, spp: int) -> torch.Tensor:
    """spp copies of x along its first axis, sample-major."""
    return x if spp == 1 else x.repeat(spp, *[1] * (x.dim() - 1))


def _walk_tensor(u) -> torch.Tensor:
    """One band's collect-walk draw from what ``trace_path`` takes: the
    walk's one march tensor, alone, in a list or in a PathUniforms (whose
    shade draws nothing: the shade is deferred)."""
    walk = u.walk if isinstance(u, pathtrace.PathUniforms) else u
    return walk if isinstance(walk, torch.Tensor) else walk[0]


def _walk_bands(scene: Scene, cfg: NRCConfig, ro_b: torch.Tensor,
                rd_b: torch.Tensor, entry_tau: Optional[torch.Tensor],
                generator: Optional[torch.Generator], uniforms=None):
    """The collect walk (render_band_deferred with the deferred shade) over
    (n_bands, band_n) rays as one batched walk; band i walks with
    uniforms[i], the bands' draws stacked here. Lane for lane the per-band
    walks: the NN-mode collision and delta collect walks have no
    cross-lane step -- unless the march split packs each band's live
    lanes, and then the bands walk one by one. entry_tau None: the walk
    computes each ray's own."""
    n_bands, band_n = ro_b.shape[:2]
    if len(pathtrace.walk_uniform_shapes(cfg, band_n, use_nn=True,
                                         collect_events=True)) > 1:
        et_b = [None] * n_bands if entry_tau is None else entry_tau
        return _cat_bands([pathtrace.render_band_deferred(
            scene, cfg, ro_i, rd_i, generator, entry_tau=et_i, uniforms=u)
            for ro_i, rd_i, et_i, u in zip(ro_b, rd_b, et_b,
                                           _per_band(uniforms, n_bands))])
    shape = (n_bands, *pathtrace.walk_uniform_shapes(cfg, band_n,
                                                     use_nn=True)[0])
    if uniforms is None:
        u = torch.rand(shape, generator=generator, dtype=ro_b.dtype,
                       device=ro_b.device)
    else:
        u = torch.stack([_walk_tensor(x)
                         for x in _per_band(uniforms, n_bands)])
    if tuple(u.shape) != shape:
        raise ValueError(f"each band's uniforms must be {shape[1:]}, got "
                         f"{tuple(u.shape[1:])}")
    # (bands, k, rows, band_n) -> (k, rows, bands * band_n): lanes band-major
    u = u.permute(1, 2, 0, 3).reshape(shape[1], shape[2], -1)
    return pathtrace.render_band_deferred(
        scene, cfg, ro_b.reshape(-1, 3), rd_b.reshape(-1, 3), None,
        entry_tau=None if entry_tau is None else entry_tau.reshape(-1),
        uniforms=u)


def _plain_bands(scene: Scene, generator: Optional[torch.Generator],
                 cfg: NRCConfig, band_rows: int, uniforms=None):
    """The cache off: ``render_image`` band by band (its spp samples and
    env composite included). uniforms: None or one entry per band, what
    render_image takes."""
    ro, rd = _rays(scene, cfg)
    band_n = band_rows * cfg.render.width
    n_bands = ro.shape[0] // band_n
    return torch.cat([pathtrace.render_image(
        scene, cfg, ro[i * band_n:(i + 1) * band_n],
        rd[i * band_n:(i + 1) * band_n], generator, query_fn=None,
        uniforms=u)[0] for i, u in enumerate(_per_band(uniforms, n_bands))])


def _cat_bands(parts: list) -> tuple:
    """Per-band walk outputs concatenated along the lanes."""
    return tuple(torch.cat(p) for p in zip(*parts))


@profiling.spanned("render.walk")
def walk_rows(scene: Scene, cfg: NRCConfig, ro_b: torch.Tensor,
              rd_b: torch.Tensor, entry_tau: Optional[torch.Tensor],
              generator: Optional[torch.Generator], uniforms=None):
    """The banded walk over (bands, band_n) rays with the query (and, when
    deferred, the shade) left to the finish: the collect walk as one batch
    (entry_tau: (bands, band_n), :func:`rays_entry_tau` of the rays, or
    None for the walk's own), else band by band, since the in-walk shade's
    packs and the reference march's repack take caps per band. uniforms:
    None or one entry per band. Returns render_band_deferred's outputs over
    all bands' lanes."""
    if pathtrace.shade_deferred(cfg):
        return _walk_bands(scene, cfg, ro_b, rd_b, entry_tau, generator,
                           uniforms)
    return _cat_bands([pathtrace.render_band_deferred(
        scene, cfg, ro_i, rd_i, generator, uniforms=u)
        for ro_i, rd_i, u in zip(ro_b, rd_b,
                                 _per_band(uniforms, ro_b.shape[0]))])


def render_tiled(state: nrc.NRCState, scene: Scene,
                 generator: Optional[torch.Generator], cfg: NRCConfig,
                 band_rows: int = 128, uniforms=None) -> torch.Tensor:
    """One frame (H, W, 3) by a host loop over ``band_rows``-row bands
    (the JAX package's ``render_tiled``): the cache off, ``render_image``
    band by band; the cache on, each band's walk with the query (and the
    shade, when deferred) left to one bake and one frame-global finish
    over the concatenated bands. No pose-static hoist and no live pack:
    each walk computes its own entry tau, the finish its own env colour.

    uniforms: None (drawn from ``generator``) or one entry per band in
    band order, band key ``fold_in(key, y0 * band_rows)`` -- what
    :func:`render_banded` takes for its unpacked bands at spp 1. Raises
    ``ValueError`` when the height is not a multiple of band_rows, or for
    spp > 1 with the cache on (:func:`render_banded` takes that)."""
    h, w = cfg.render.height, cfg.render.width
    if h % band_rows:
        raise ValueError(f"height {h} is not a multiple of band_rows "
                         f"{band_rows}")
    if not cfg.render.use_nn:
        return _plain_bands(scene, generator, cfg, band_rows,
                            uniforms).reshape(h, w, 3)
    if cfg.render.spp != 1:
        raise ValueError("render_tiled's cached path renders spp=1; "
                         "render_banded takes spp > 1")
    ro, rd = _rays(scene, cfg)
    n_bands = h // band_rows
    parts = walk_rows(scene, cfg, ro.reshape(n_bands, -1, 3),
                      rd.reshape(n_bands, -1, 3), None, generator, uniforms)
    return _finish(state, nrc.bake(state, cfg), scene, *parts,
                   cfg).reshape(h, w, 3)


def _bands_program(scene: Scene, generator: Optional[torch.Generator],
                   cfg: NRCConfig, band_rows: int,
                   entry_tau: Optional[torch.Tensor] = None,
                   uniforms=None):
    """The unpacked banded walk (:func:`walk_rows`) over every pixel ray.
    spp > 1 walks spp sample-major virtual copies of the bands (uniforms:
    None or one entry per copy)."""
    h, w = cfg.render.height, cfg.render.width
    ro, rd = _rays(scene, cfg)
    n_bands, band_n = h // band_rows, band_rows * w
    spp = cfg.render.spp
    if pathtrace.shade_deferred(cfg) and entry_tau is None:
        entry_tau = frame_entry_tau(scene, cfg)  # pose-static: hoist it
    return walk_rows(
        scene, cfg, _tile(ro.reshape(n_bands, band_n, 3), spp),
        _tile(rd.reshape(n_bands, band_n, 3), spp),
        None if entry_tau is None
        else _tile(entry_tau.reshape(n_bands, band_n), spp),
        generator, uniforms)


def _finish(state: nrc.NRCState, baked: torch.Tensor, scene: Scene, rgb,
            trans, q_pos, q_dir, q_w, ev, cfg: NRCConfig, env_rgb=None):
    """The frame-global shade, query and env composite over the
    (spp-expanded) lanes; spp > 1 composites each copy, then takes the
    mean."""
    query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    ro, rd = _rays(scene, cfg)
    if env_rgb is None:
        env_rgb = frame_env_color(scene, cfg)
    spp = cfg.render.spp
    out = pathtrace.finish_deferred(scene, cfg, _tile(ro, spp),
                                    _tile(rd, spp), rgb, trans, q_pos, q_dir,
                                    q_w, query_fn, events=ev,
                                    env_rgb=_tile(env_rgb, spp))
    return out.reshape(spp, -1, 3).mean(dim=0) if spp > 1 else out


def _packed_bands_program(scene: Scene, generator: Optional[torch.Generator],
                          cfg: NRCConfig, band_rows: int,
                          pack: Optional[LivePack] = None, uniforms=None):
    """The banded collect walk over the packed live rays only (the rest are
    exactly T0 = 1, pure env); spp > 1 walks spp sample-major copies of the
    packed bands. pack: :func:`frame_live_pack`, built here when None.
    Padding lanes march the duplicate of packed slot 0's ray; their query
    weights and events are masked."""
    if pack is None:
        pack = frame_live_pack(scene, cfg, band_rows)
    spp = cfg.render.spp
    with profiling.span("render.walk"):
        rgb, trans, qp, qd, qw, ev = _walk_bands(
            scene, cfg, _tile(pack.ro_p, spp), _tile(pack.rd_p, spp),
            _tile(pack.et_p, spp), generator, uniforms)
        val = _tile(pack.val, spp)
        qw = torch.where(val, qw, 0.0)
        if ev.shape[1] > 0:
            ev = ev.masked_fill(~val[:, None, None], 0.0)
    return pack.inv, rgb, trans, qp, qd, qw, ev


def _finish_packed(state: nrc.NRCState, baked: torch.Tensor, scene: Scene,
                   inv, rgb_p, trans_p, qp, qd, qw, ev, cfg: NRCConfig,
                   env_rgb=None):
    """The frame-global shade and query over the packed lanes (caps
    relative to the whole frame, spp times it with spp copies), the mean
    over the copies, the un-pack as one (n, 4) gather through the inverse
    map (rays not packed: rgb 0, T0 1), and the env composite."""
    query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    n = cfg.render.width * cfg.render.height
    spp = cfg.render.spp
    rgb_p = pathtrace.shade_and_query(scene, cfg, rgb_p, qp, qd, qw,
                                      query_fn, events=ev, cap_n=spp * n)
    with profiling.span("render.finish"):
        if spp > 1:
            # the pack is shared by every copy and the composite is linear
            # in (rgb, T0): the mean before the un-pack is the mean after it
            rgb_p = rgb_p.reshape(spp, -1, 3).mean(dim=0)
            trans_p = trans_p.reshape(spp, -1).mean(dim=0)
        rgbt = torch.cat([rgb_p, trans_p[:, None]], dim=1)
        out = compact.gather_back(inv, rgbt, [0.0, 0.0, 0.0, 1.0])
        if env_rgb is None:
            env_rgb = frame_env_color(scene, cfg)
        return out[:, :3] + out[:, 3:4] * env_rgb


@profiling.spanned("render")
def render_banded(state: nrc.NRCState, scene: Scene,
                  generator: Optional[torch.Generator], cfg: NRCConfig,
                  band_rows: int = 54, env_rgb: Optional[torch.Tensor] = None,
                  baked: Optional[torch.Tensor] = None,
                  pack: Optional[LivePack] = None,
                  entry_tau: Optional[torch.Tensor] = None,
                  uniforms=None) -> torch.Tensor:
    """One frame (H, W, 3) in row bands of ``band_rows`` rows.

    The cache off: ``render_image`` band by band. The cache on: the banded
    walk with the query (and, when :func:`pathtrace.shade_deferred`, the
    shade) deferred, then the frame-global finish; with
    ``live_pack_fraction`` > 0 and the deferred shade only the packed live
    rays march. spp > 1 (cache on) walks spp virtual copies of the bands
    and averages after the finish.

    env_rgb: :func:`frame_env_color` (pose-static). baked: ``nrc.bake`` of
    the state (once per cache state). pack: :func:`frame_live_pack` with
    the same band_rows (pose-static; carries the packed entry tau).
    entry_tau: :func:`frame_entry_tau` for the unpacked collect walk. Each
    is computed here when None. uniforms: the draws of the bands, in JAX's
    band order, one entry per band: the cache off, what ``render_image``
    takes for the band (its spp samples included), band key ``fold_in(key,
    y0)``, y0 = band index x band_rows; the cache on, what ``trace_path``
    takes for one copy of the band (e.g. ``draw_path_uniforms(cfg, band_n,
    True, ...)``), over spp x bands sample-major copies with the same keys
    (packed: ``fold_in(key, i)`` over spp x packed bands). Drawn from
    ``generator`` when None.
    """
    h, w = cfg.render.height, cfg.render.width
    if h % band_rows:
        raise ValueError(f"height {h} is not a multiple of band_rows "
                         f"{band_rows}")
    if not cfg.render.use_nn:
        return _plain_bands(scene, generator, cfg, band_rows,
                            uniforms).reshape(h, w, 3)
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
