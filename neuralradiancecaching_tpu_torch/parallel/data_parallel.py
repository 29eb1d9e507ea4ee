"""Data-parallel frame, train and render steps on ``torch.distributed``.

Counterpart of ``neuralradiancecaching_tpu/parallel/data_parallel.py``,
whose ``shard_map`` programs become SPMD functions: every rank of the
:class:`~.mesh.Mesh` calls them with the same arguments and gets the same
result.

Layout (the JAX package's):
  * rays and pixels: rank r takes the r-th contiguous 1/n of the leading
    dimension (the train ray pool, the pixel rays); banded renders stripe
    whole row bands instead -- rank d takes bands d, d+n, d+2n, ... (packed
    bands in the packed render), so per-rank work and cap fractions stay
    near the frame mean;
  * NRC parameters, optimizer state and scene: replicated;
  * the gradient and loss mean (JAX's ``pmean``): ONE ``all_reduce(SUM)``
    over a single flat fp32 buffer of every gradient and the mse, divided
    by the world size; then every rank runs the same optimizer step, so
    the replicated states stay bitwise equal (a ring hands every rank the
    same sum), and the hash table's sparse Adam sees the reduced gradient;
  * outputs: the ranks' image shards are gathered with one
    ``all_gather_into_tensor`` and un-striped; every rank returns the
    whole image, as JAX's global array.
Shade and query caps apply per rank, relative to its share (``cap_n =
n // n_dev``): :func:`probe_dp_caps` sizes them to the worst shard.

Randomness: JAX folds the device index into the key. Here the draws come
through the seams: ``jitter`` (the train pool's, shared by every rank) and
``train_uniforms`` (one ``TrainUniforms`` per rank, shaped for its share
-- ``targets.draw_train_uniforms(..., rays=n_rays // n)``; rank r's entry
stands for ``fold_in(key, r)``), render ``uniforms`` one entry per rank
(what ``render_image`` takes for its pixels), banded ``uniforms`` one entry
per band in GLOBAL band order (what ``render_banded`` takes: band g's
entry is keyed ``fold_in(key, g * band_rows)``, packed ``fold_in(key,
g)``). With them the image does not depend on the world size and equals
``render_banded``'s. Without them each rank draws its own share from a
stream seeded by one draw per rank from ``generator`` (shared: seeded
alike on every rank), so the sample then depends on the world size.

Each collective runs as the tracer's span ``dp.<collective>``
(``utils.profiling``): ``dp.all_reduce``, ``dp.all_gather``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.ops import compact
from neuralradiancecaching_tpu_torch.parallel.mesh import Mesh
from neuralradiancecaching_tpu_torch.render import pathtrace, targets, tiled
from neuralradiancecaching_tpu_torch.scene.camera import pixel_rays
from neuralradiancecaching_tpu_torch.scene.scene import Scene
from neuralradiancecaching_tpu_torch.utils import profiling


# -- collectives and shards ----------------------------------------------------


def _pmean(mesh: Mesh, grads, mse: torch.Tensor):
    """The mean over ranks of ((mlp grads, hash grad), mse): one all_reduce
    of one flat buffer, then a divide by the world size."""
    mlp, table = grads
    parts = [*mlp.values(), table, mse.reshape(1)]
    flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
    with profiling.span("dp.all_reduce"):
        dist.all_reduce(flat, dist.ReduceOp.SUM, mesh.group)
    flat = flat / mesh.size
    out = [f.reshape(p.shape).to(p.dtype) for f, p in zip(
        torch.split(flat, [p.numel() for p in parts]), parts)]
    return (dict(zip(mlp, out[:len(mlp)])), out[-2]), out[-1][0]


def _all_gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked rank-major along the leading dimension."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with profiling.span("dp.all_gather"):
        dist.all_gather_into_tensor(out, x, mesh.group)
    return out


def _shard(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous 1/n of x's leading dimension."""
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _per_rank(mesh: Mesh, draws: Sequence, what: str):
    if len(draws) != mesh.size:
        raise ValueError(f"{mesh.size} ranks need {mesh.size} sets of "
                         f"{what}, got {len(draws)}")
    return draws[mesh.rank]


def _rank_generator(generator: Optional[torch.Generator], mesh: Mesh
                    ) -> Optional[torch.Generator]:
    """This rank's stream: one seed per rank drawn from the shared
    generator (every rank draws the same seeds), JAX's fold_in(key,
    axis_index)."""
    if generator is None:
        return None
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=generator,
                          device=generator.device)
    return torch.Generator(mesh.device).manual_seed(int(seeds[mesh.rank]))


def _striped(n_bands: int, mesh: Mesh) -> list[int]:
    """The bands of this rank: rank, rank + n, rank + 2n, ..."""
    return list(range(mesh.rank, n_bands, mesh.size))


def _band_draws(uniforms, bands: list[int], n_bands: int):
    """This rank's entries of a global per-band uniforms list."""
    if uniforms is None:
        return None
    if len(uniforms) != n_bands:
        raise ValueError(f"{n_bands} bands need {n_bands} sets of uniforms, "
                         f"got {len(uniforms)}")
    return [uniforms[g] for g in bands]


def _unstripe(x: torch.Tensor, n_dev: int, band_n: int) -> torch.Tensor:
    """Rank-major gathered bands (rank d: bands d, d+n, ...) back to band
    order, (n_bands * band_n, C)."""
    c = x.shape[-1]
    return (x.reshape(n_dev, -1, band_n, c).transpose(0, 1)
            .reshape(-1, c))


def _check_divisible(mesh: Mesh, *counts: int) -> None:
    for c in counts:
        if c % mesh.size != 0:
            raise ValueError(
                f"ray/pixel count {c} must be divisible by the mesh size "
                f"{mesh.size}; adjust train_width/train_height or render "
                f"width x height")


def _check_bands(mesh: Mesh, h: int, band_rows: int) -> None:
    if h % (mesh.size * band_rows) != 0:
        raise ValueError(f"height {h} must divide into {mesh.size} devices "
                         f"x {band_rows}-row bands")


# -- train and render ------------------------------------------------------------

def dp_train_step(state: nrc.NRCState, scene: Scene,
                  generator: Optional[torch.Generator], cfg: NRCConfig,
                  mesh: Mesh, jitter: Optional[torch.Tensor] = None,
                  train_uniforms: Optional[Sequence] = None
                  ) -> Tuple[nrc.NRCState, torch.Tensor]:
    """Data-parallel online training pass: the whole train ray pool
    (jittered grid x vertex_oversample copies) is built on every rank and
    SHARDED; each rank compacts its share's RR-cut vertices and traces
    their targets, the gradients and mse are meaned over the ranks, and
    every rank applies the same optimizer step. Returns (state, mse).

    jitter: the pool's (O, 2, H, W) jitters; train_uniforms: one
    ``TrainUniforms`` per rank for its share (see the module docstring);
    each drawn from ``generator`` when None."""
    _check_divisible(mesh, cfg.train.n_rays)
    if jitter is None:
        jitter = torch.rand((targets._oversample(cfg), 2,
                             cfg.train.train_height, cfg.train.train_width),
                            generator=generator, device=mesh.device)
    if train_uniforms is None:
        u = targets.draw_train_uniforms(
            cfg, _rank_generator(generator, mesh), mesh.device,
            rays=cfg.train.n_rays // mesh.size)
    else:
        u = _per_rank(mesh, train_uniforms, "train uniforms")
    ro, rd = targets.train_ray_pool(scene, cfg, jitter)
    batch = targets.generate_train_batch_for_rays(
        scene, cfg, _shard(mesh, ro), _shard(mesh, rd), u)
    grads, mse = nrc.compute_grads(state, batch.pos, batch.dir, batch.target,
                                   cfg)
    grads, mse = _pmean(mesh, grads, mse)
    return nrc.apply_grads(state, grads, cfg), mse


def _local_render(state: nrc.NRCState, scene: Scene,
                  generator: Optional[torch.Generator], cfg: NRCConfig,
                  mesh: Mesh, uniforms) -> torch.Tensor:
    """This rank's share of the pixels through ``render_image`` (the
    replicated state bakes the same on every rank)."""
    query_fn = None
    if cfg.render.use_nn:
        query_fn = nrc.make_baked_query_fn(state, nrc.bake(state, cfg), cfg)
    ro, rd = pixel_rays(scene.camera, cfg.render.width, cfg.render.height)
    if uniforms is None:
        u, gen = None, _rank_generator(generator, mesh)
    else:
        u, gen = _per_rank(mesh, uniforms, "render uniforms"), None
    rgb, _ = pathtrace.render_image(scene, cfg, _shard(mesh, ro),
                                    _shard(mesh, rd), gen, query_fn=query_fn,
                                    uniforms=u)
    return rgb


def dp_render(state: nrc.NRCState, scene: Scene,
              generator: Optional[torch.Generator], cfg: NRCConfig,
              mesh: Mesh, uniforms: Optional[Sequence] = None
              ) -> torch.Tensor:
    """Data-parallel render: pixels sharded, returns (H, W, 3). uniforms:
    one entry per rank, what ``render_image`` takes for its pixels."""
    w, h = cfg.render.width, cfg.render.height
    _check_divisible(mesh, w * h)
    rgb = _local_render(state, scene, generator, cfg, mesh, uniforms)
    return _all_gather(mesh, rgb).reshape(h, w, 3)


def dp_frame_step(state: nrc.NRCState, scene: Scene,
                  generator: Optional[torch.Generator], cfg: NRCConfig,
                  mesh: Mesh, train: bool = True,
                  jitter: Optional[torch.Tensor] = None,
                  train_uniforms: Optional[Sequence] = None,
                  uniforms: Optional[Sequence] = None):
    """Full data-parallel frame: sharded train pass -> replicated optimizer
    step -> sharded render; the multi-device ``frame.frame_step``. Returns
    (state, image (H, W, 3), mse scalar; 0 without training)."""
    w, h = cfg.render.width, cfg.render.height
    _check_divisible(mesh, cfg.train.n_rays, w * h)
    if train:
        state, mse = dp_train_step(state, scene, generator, cfg, mesh,
                                   jitter, train_uniforms)
    else:
        mse = torch.zeros((), dtype=torch.float32, device=mesh.device)
    rgb = _local_render(state, scene, generator, cfg, mesh, uniforms)
    return state, _all_gather(mesh, rgb).reshape(h, w, 3), mse


def dp_render_banded(state: nrc.NRCState, scene: Scene,
                     generator: Optional[torch.Generator], cfg: NRCConfig,
                     mesh: Mesh, band_rows: int = 54,
                     env_rgb: Optional[torch.Tensor] = None,
                     baked: Optional[torch.Tensor] = None,
                     uniforms: Optional[Sequence] = None) -> torch.Tensor:
    """Data-parallel banded render: row bands STRIPED over the ranks (rank
    d takes bands d, d+n, ...), each rank walks its bands (the collision
    sampler's exact entry tau over its own rays) and finishes them with its
    own deferred shade and capped cache query, then the ranks' bands are
    gathered. Striping keeps per-rank work and cap fractions near the frame
    mean where contiguous blocks would leave the cloud's ranks with most of
    it. Returns (H, W, 3).

    env_rgb: ``tiled.frame_env_color`` (pose-static); baked: ``nrc.bake``
    of the state. uniforms: one entry per band in global band order, what
    ``render_banded`` takes."""
    if not cfg.render.use_nn:
        raise ValueError("dp_render_banded is the NN path; use dp_render "
                         "for cache-off frames")
    if cfg.render.spp != 1:
        raise ValueError("dp_render_banded renders 1 spp per call; "
                         "accumulate frames host-side (cli progressive) or "
                         "use render_banded's spp on one device")
    h, w = cfg.render.height, cfg.render.width
    _check_bands(mesh, h, band_rows)
    n_bands, band_n = h // band_rows, band_rows * w
    mine = _striped(n_bands, mesh)
    ro, rd = pixel_rays(scene.camera, w, h)
    ro_b = ro.reshape(n_bands, band_n, 3)[mine]
    rd_b = rd.reshape(n_bands, band_n, 3)[mine]
    ro_l, rd_l = ro_b.reshape(-1, 3), rd_b.reshape(-1, 3)
    et = (tiled.rays_entry_tau(scene, cfg, ro_l, rd_l).reshape(-1, band_n)
          if pathtrace.shade_deferred(cfg) else None)
    u = _band_draws(uniforms, mine, n_bands)
    gen = _rank_generator(generator, mesh) if u is None else None
    if baked is None:
        baked = nrc.bake(state, cfg)
    rgb, trans, qp, qd, qw, ev = tiled.walk_rows(scene, cfg, ro_b, rd_b, et,
                                                 gen, u)
    env_l = (None if env_rgb is None
             else env_rgb.reshape(n_bands, band_n, 3)[mine].reshape(-1, 3))
    out = pathtrace.finish_deferred(
        scene, cfg, ro_l, rd_l, rgb, trans, qp, qd, qw,
        nrc.make_baked_query_fn(state, baked, cfg), events=ev, env_rgb=env_l)
    return _unstripe(_all_gather(mesh, out), mesh.size,
                     band_n).reshape(h, w, 3)


def dp_render_banded_packed(state: nrc.NRCState, scene: Scene,
                            generator: Optional[torch.Generator],
                            cfg: NRCConfig, mesh: Mesh, band_rows: int = 54,
                            env_rgb: Optional[torch.Tensor] = None,
                            baked: Optional[torch.Tensor] = None,
                            pack: Optional[tiled.LivePack] = None,
                            uniforms: Optional[Sequence] = None
                            ) -> torch.Tensor:
    """Frame-global live-ray packing on the ranks: the pose-static pack
    (``tiled.frame_live_pack``, multiple_of = world size) groups the live
    rays into packed bands, whole packed bands stripe over the ranks (rank
    d takes packed bands d, d+n, ...), each rank walks, shades and queries
    only its live lanes (caps relative to n_pixels / n), and the gathered
    packed results un-pack to pixel order with one gather. A multiple_of=N
    pack only appends padding bands, so for one pack the image equals
    ``render_banded(pack=...)``'s at any world size (same per-band draws).
    uniforms: one entry per packed band, global order."""
    if cfg.render.spp != 1:
        raise ValueError("dp_render_banded_packed renders 1 spp per call")
    h, w = cfg.render.height, cfg.render.width
    _check_bands(mesh, h, band_rows)
    if pack is None:
        pack = tiled.frame_live_pack(scene, cfg, band_rows,
                                     multiple_of=mesh.size)
    n_bands_p, band_n = pack.ro_p.shape[:2]
    if n_bands_p % mesh.size != 0:
        raise ValueError(
            f"packed band count {n_bands_p} must be divisible by the mesh "
            f"size {mesh.size}; build the pack with multiple_of=mesh size")
    if baked is None:
        baked = nrc.bake(state, cfg)
    mine = _striped(n_bands_p, mesh)
    u = _band_draws(uniforms, mine, n_bands_p)
    gen = _rank_generator(generator, mesh) if u is None else None
    local = pack._replace(
        val=pack.val.reshape(n_bands_p, band_n)[mine].reshape(-1),
        ro_p=pack.ro_p[mine], rd_p=pack.rd_p[mine], et_p=pack.et_p[mine])
    _, rgb, trans, qp, qd, qw, ev = tiled._packed_bands_program(
        scene, gen, cfg, band_rows, local, u)
    rgb = pathtrace.shade_and_query(
        scene, cfg, rgb, qp, qd, qw,
        nrc.make_baked_query_fn(state, baked, cfg), events=ev,
        cap_n=h * w // mesh.size)
    rgbt = _unstripe(_all_gather(mesh, torch.cat([rgb, trans[:, None]], 1)),
                     mesh.size, band_n)
    out = compact.gather_back(pack.inv, rgbt, [0.0, 0.0, 0.0, 1.0])
    if env_rgb is None:
        env_rgb = tiled.frame_env_color(scene, cfg)
    return (out[:, :3] + out[:, 3:4] * env_rgb).reshape(h, w, 3)


def dp_train_banded_frame(state: nrc.NRCState, scene: Scene,
                          generator: Optional[torch.Generator],
                          cfg: NRCConfig, mesh: Mesh, band_rows: int = 54,
                          env_rgb: Optional[torch.Tensor] = None,
                          baked: Optional[torch.Tensor] = None,
                          pack: Optional[tiled.LivePack] = None,
                          jitter: Optional[torch.Tensor] = None,
                          train_uniforms: Optional[Sequence] = None,
                          uniforms: Optional[Sequence] = None):
    """The production multi-device frame: :func:`dp_train_step`, then the
    striped banded render with the updated cache -- packed
    (:func:`dp_render_banded_packed`) under the JAX package's condition,
    else :func:`dp_render_banded`. ``env_rgb``/``baked``/``pack`` are the
    single-device path's hoists; with ``baked`` None the render bakes the
    new state. Returns (state, image (H, W, 3), mse, baked)."""
    state, mse = dp_train_step(state, scene, generator, cfg, mesh, jitter,
                               train_uniforms)
    if baked is None:
        baked = nrc.bake(state, cfg)
    if (cfg.render.live_pack_fraction > 0.0 and pathtrace.shade_deferred(cfg)
            and not cfg.render.show_non_nn and cfg.render.spp == 1):
        img = dp_render_banded_packed(state, scene, generator, cfg, mesh,
                                      band_rows, env_rgb, baked, pack,
                                      uniforms)
    else:
        img = dp_render_banded(state, scene, generator, cfg, mesh, band_rows,
                               env_rgb, baked, uniforms)
    return state, img, mse, baked


# -- per-shard cap probe -----------------------------------------------------------

class DPCapReport(NamedTuple):
    """Per-shard probe results + the worst-shard-sized cap fractions. All
    fractions are relative to the per-rank cap base (n_pixels / n_dev), as
    the DP renders apply ``query_cap_fraction`` / ``shade_cap_fraction``."""
    query_frac: np.ndarray      # (n_dev,) measured query fraction per shard
    event_mean: np.ndarray      # (n_dev,) measured live events per cap lane
    live_frac: np.ndarray       # (n_dev,) exact entry-live fraction (banded)
    query_cap: float            # tightened drop-free query_cap_fraction
    shade_cap: float            # tightened drop-free shade_cap_fraction


def _round_cap(x: float, margin: float, pad: float) -> float:
    return float(np.ceil((x * margin + pad) / 0.015625) * 0.015625)


def probe_dp_caps(scene: Scene, cfg: NRCConfig, mesh_n: int,
                  band_rows: int = 54,
                  generator: Optional[torch.Generator] = None,
                  stride: Optional[int] = None, margin: float = 1.05,
                  pack: Optional[tiled.LivePack] = None, uniforms=None
                  ) -> Tuple[NRCConfig, DPCapReport]:
    """Per-shard cap probe for the striped banded DP renders: measures each
    shard's own query and shade-event fractions under the band -> rank
    assignment the DP renders use (band b -> rank b % mesh_n), sizes the
    caps to the WORST shard with the bench's margin and 1/64 rounding, and
    returns the tightened config (drop-free per shard by construction) and
    the report. Runs on one device (no collective).

    Legs: the query fraction from a strided ``trace_path`` sample; the
    shade events per lane from ``trace_path_collision(collect_events)`` on
    it (deferred-shade pipelines; its query mask then comes from the same
    walk); the exact entry-live fraction per stripe (for the record). With
    ``pack`` the lanes and their ranks come from the packed bands (padding
    lanes weigh 0). uniforms: the sample walk's draws (JAX's probe key
    defaults to PRNGKey(97)); else drawn from ``generator`` (seed 97 when
    None). Only the final per-shard sums leave the device."""
    h, w = cfg.render.height, cfg.render.width
    n = h * w
    band_n = band_rows * w
    base = n // mesh_n
    dev = scene.camera.position.device
    f64 = torch.float64
    if pack is not None:
        ro_f, rd_f = pack.ro_p.reshape(-1, 3), pack.rd_p.reshape(-1, 3)
        lane_w = pack.val.to(f64)
    else:
        ro_f, rd_f = pixel_rays(scene.camera, w, h)
        lane_w = torch.ones((n,), dtype=f64, device=dev)
    n_lanes = ro_f.shape[0]
    lane_dev = (torch.arange(n_lanes, device=dev) // band_n) % mesh_n

    def per_dev(d, weights):
        return torch.bincount(d, weights=weights, minlength=mesh_n)

    valid_per_dev = per_dev(lane_dev, lane_w)
    if stride is None:
        stride = max(1, n_lanes // (w * 64))
    idx = torch.arange(0, n_lanes, stride, device=dev)
    d_s, w_s = lane_dev[idx], lane_w[idx]
    samp_valid = torch.clamp(per_dev(d_s, w_s), min=1.0)
    if uniforms is None and generator is None:
        generator = torch.Generator(dev).manual_seed(97)
    deferred = pathtrace.shade_deferred(cfg)
    if deferred:
        res, ev = pathtrace.trace_path_collision(
            scene, cfg, ro_f[idx], rd_f[idx], generator, use_nn=True,
            uniforms=uniforms, collect_events=True)
        counts = (ev[..., 6] > 0).sum(dim=1).to(f64)
        ev_slots = int(ev.shape[1])
    else:
        res = pathtrace.trace_path(scene, cfg, ro_f[idx], rd_f[idx],
                                   generator, use_nn=True, uniforms=uniforms)
        counts = torch.zeros((idx.shape[0],), dtype=f64, device=dev)
        ev_slots = 0
    qmask = (res.query_weight > 0).to(f64) * w_s
    # a shard's need = mean per valid sampled lane x its valid lanes / base
    scale = valid_per_dev / samp_valid / base
    qfrac = per_dev(d_s, qmask) * scale
    ev_frac = per_dev(d_s, counts * w_s) * scale

    ro_px, rd_px = pixel_rays(scene.camera, w, h)
    live = tiled._live_mask(scene, cfg, ro_px, rd_px).to(f64)
    live_dev = (torch.arange(n, device=dev) // band_n) % mesh_n
    live_frac = per_dev(live_dev, live) / torch.clamp(
        per_dev(live_dev, None).to(f64), min=1.0)
    qfrac, ev_frac, live_frac = (x.cpu().numpy()
                                 for x in (qfrac, ev_frac, live_frac))

    query_cap = min(1.0, _round_cap(float(qfrac.max()), margin, 0.005))
    shade_cap = cfg.render.shade_cap_fraction
    if deferred and ev_slots > 0:
        shade_cap = min(float(ev_slots),
                        _round_cap(float(ev_frac.max()), margin, 0.01))
    cfg_t = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, query_cap_fraction=query_cap,
        shade_cap_fraction=shade_cap))
    return cfg_t, DPCapReport(qfrac, ev_frac, live_frac, query_cap,
                              shade_cap)
