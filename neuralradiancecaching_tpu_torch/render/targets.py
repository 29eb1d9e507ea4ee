"""Self-training target generation: the nrc-train.comp kernel's path logic.

Counterpart of ``neuralradiancecaching_tpu/render/targets.py`` for the three
samplers. Per train step the (jittered) train grid gives the rays:

* collision and delta: the grid stacked ``vertex_oversample`` times runs
  the render's own NN-mode walk; its Russian-roulette cuts, compacted after
  a lane permutation, are the batch's (pos, dir) vertices; each vertex's
  target is next-event estimation plus the mean of ``target_samples``
  HG-sampled no-cache continuation walks (``target_bounces`` slots, the
  split march), clamped to ``target_clamp``;
* reference (TracePathAndLearn, nrc-train.comp:1173-1226): the RR vertex
  walk (``vertex_walk_steps``) scatters where the density is nonzero and
  keeps its last vertex (entry fallback when it never scattered); each
  target is the mean of ``target_samples`` 64-step scatter walks from it
  (:func:`trace_target_paths`: events recorded step-major, shaded dense or
  packed by a stable sort under ``train.compact_events``).

Randomness: every draw of a batch goes through one seam,
:class:`TrainUniforms` -- drawn from a ``torch.Generator`` by
:func:`draw_train_uniforms`, or handed in by the caller (a test hands in
the JAX package's own draws).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.ops import compact, scan
from neuralradiancecaching_tpu_torch.ops import phase as phase_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops
from neuralradiancecaching_tpu_torch.render import pathtrace
from neuralradiancecaching_tpu_torch.scene.camera import pixel_rays
from neuralradiancecaching_tpu_torch.scene.scene import Scene
from neuralradiancecaching_tpu_torch.utils import profiling


def _train_walk_cfg(cfg: NRCConfig) -> NRCConfig:
    """Train-side walk overrides (targets.py:43-81 of the JAX package): the
    row tau at slot 0 (entry_tau_steps=0), the p1=4 target march split with
    its cascade, bf16 shade-event stacks and the phase-1 shade budget --
    all scoped to the train walks."""
    p = cfg.path
    p2 = dataclasses.replace(
        p, entry_tau_steps=0,
        coll_nonn_phase1_steps=p.coll_target_phase1_steps,
        coll_nonn_phase2_steps=p.coll_target_phase2_steps,
        coll_shade_bf16=p.coll_target_shade_bf16,
        coll_shade_cap_p1=p.coll_target_shade_cap_p1)
    if p2 == p:
        return cfg
    return dataclasses.replace(cfg, path=p2)


class TrainBatch(NamedTuple):
    pos: torch.Tensor     # (N, 3) query vertex positions
    dir: torch.Tensor     # (N, 3) query directions
    target: torch.Tensor  # (N, 3) path-traced radiance targets (clamped)


class TrainUniforms(NamedTuple):
    """Every random draw of one train batch (N = train_width *
    train_height rays, O = vertex_oversample (1 for the reference sampler),
    S = target_samples). Collision and delta: the vertex-walk and
    target-walk phases of :func:`pathtrace.walk_uniform_shapes`, the lane
    permutation and the HG pairs; ``shade`` holds the NEE call's and then
    the target walk's shade calls' draws. Reference: ``vertex`` is the one
    (vertex_walk_steps, 4, N) block (JAX: ``uniform(k_v, ...)``),
    ``target`` the one (target_bounces, 4, S*N) block (``fold_in(k_t,
    0)``), ``shade`` the target shade's draws (``fold_in(k_t, 1)``); perm
    and hg are None. ``shade`` is empty when the shades draw nothing (the
    'field' modes)."""
    jitter: Optional[torch.Tensor]     # (O, 2, H, W) pixel jitters (u, v)
    vertex: Sequence[torch.Tensor]     # vertex-walk phases
    perm: Optional[torch.Tensor]       # (O*N,) int64 lane permutation
    hg: Optional[torch.Tensor]         # (2, S*N) HG pairs (u_cos, u_phi)
    target: Sequence[torch.Tensor]     # target-walk phases
    shade: Sequence[Optional[pathtrace.SceneUniforms]] = ()


def _oversample(cfg: NRCConfig) -> int:
    if cfg.path.sampler == "reference":
        return 1
    return max(1, cfg.train.vertex_oversample)


def _walk_steps(cfg: NRCConfig) -> int:
    """The reference vertex walk's steps: survival past step k is
    rr_decay^(k(k-1)/2), so 16 are indistinguishable from the reference's
    64."""
    return min(cfg.train.vertex_walk_steps or cfg.train.target_bounces,
               cfg.train.target_bounces)


def _target_cap(cfg: NRCConfig, n_t: int) -> int:
    """The reference target shade's row count: every step-major event, or
    the ``train.compact_events`` budget."""
    ns = cfg.train.target_bounces * n_t
    if cfg.train.compact_events > 0:
        return min(ns, max(1024, int(n_t * cfg.train.compact_events)))
    return ns


def train_shade_rows(cfg: NRCConfig, rays: int | None = None) -> list[int]:
    """The row count of each shade call of one train batch whose draws
    :class:`TrainUniforms`.shade carries (empty when none draws). rays: the
    batch's rows (default the train grid's; a data-parallel shard's
    share)."""
    n = rays or cfg.train.train_width * cfg.train.train_height
    n_t = cfg.train.target_samples * n
    env = cfg.train.env_samples
    if pathtrace.scene_uniform_shapes(cfg, 1, env) is None:
        return []
    if cfg.path.sampler == "reference":
        return [_target_cap(cfg, n_t)]
    _, rows = pathtrace.path_uniform_shapes(
        _train_walk_cfg(cfg), n_t, use_nn=False, env_samples=env,
        max_bounces=cfg.train.target_bounces)
    return [n] + rows


def draw_train_uniforms(cfg: NRCConfig, generator: torch.Generator,
                        device: torch.device | str,
                        rays: int | None = None) -> TrainUniforms:
    """Draw one batch's :class:`TrainUniforms` from ``generator`` (which
    must live on ``device``). rays: a data-parallel shard's batch rows --
    the draws of its share of the ray pool, without the pool's jitter
    (``jitter`` None: it is drawn once for every shard)."""
    tw, th = cfg.train.train_width, cfg.train.train_height
    over, n = _oversample(cfg), rays or tw * th
    n_t = cfg.train.target_samples * n
    wcfg = _train_walk_cfg(cfg)

    def rand(shape):
        return torch.rand(shape, generator=generator, device=device)

    jitter = None if rays else rand((over, 2, th, tw))
    if cfg.path.sampler == "reference":
        vertex = [rand((_walk_steps(cfg), 4, n))]
        perm = hg = None
        target = [rand((cfg.train.target_bounces, 4, n_t))]
    else:
        vertex = [rand(sh) for sh in pathtrace.walk_uniform_shapes(
            wcfg, over * n, use_nn=True)]
        perm = torch.randperm(over * n, generator=generator, device=device)
        hg = rand((2, n_t))
        target = [rand(sh) for sh in pathtrace.walk_uniform_shapes(
            wcfg, n_t, use_nn=False, max_bounces=cfg.train.target_bounces)]
    shade = [pathtrace.draw_scene_uniforms(cfg, r, cfg.train.env_samples,
                                           generator, device)
             for r in train_shade_rows(cfg, rays)]
    return TrainUniforms(jitter, vertex, perm, hg, target, shade)


def train_ray_pool(scene: Scene, cfg: NRCConfig, jitter: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The camera-ray pool of ONE train step: the train grid, stacked
    ``vertex_oversample`` times with jitters ``jitter[i]`` (copy 0 is
    jittered only when TrainConfig.jitter_train_grid)."""
    tw, th = cfg.train.train_width, cfg.train.train_height
    ros, rds = [], []
    for i in range(_oversample(cfg)):
        j = jitter[i] if (i > 0 or cfg.train.jitter_train_grid) else None
        r_o, r_d = pixel_rays(scene.camera, tw, th, jitter=j)
        ros.append(r_o)
        rds.append(r_d)
    return torch.cat(ros), torch.cat(rds)


def _entry_fallback(cfg: NRCConfig, ro: torch.Tensor, rd: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(entry, -normalize(entry)): the vertex of a ray without a cut
    (train main, nrc-train.comp:1252-1255)."""
    entry, _, _ = volume_ops.entry_exit_points(ro, rd, cfg.volume.box_size,
                                               cfg.volume.box_center)
    fb_dir = -entry / torch.clamp(torch.linalg.vector_norm(
        entry, dim=-1, keepdim=True), min=1e-8)
    return entry, fb_dir


def choose_train_vertices_collision(scene: Scene, cfg: NRCConfig,
                                    ro: torch.Tensor, rd: torch.Tensor,
                                    uniforms: Sequence[torch.Tensor]
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vertex selection without oversampling: the render's NN-mode walk
    over the rays (misses re-aimed at the origin); each ray's RR cut, or
    the entry fallback when it records none."""
    vol = cfg.volume
    _, _, hit = volume_ops.ray_aabb(ro, rd, vol.box_size, vol.box_center)
    rd = torch.where(hit[:, None], rd, -ro / torch.linalg.vector_norm(
        ro, dim=-1, keepdim=True))
    res = pathtrace.trace_path_collision(scene, _train_walk_cfg(cfg), ro, rd,
                                         None, use_nn=True, env_samples=0,
                                         uniforms=uniforms)
    has = (res.query_weight > 0.0)[:, None]
    entry, fb_dir = _entry_fallback(cfg, ro, rd)
    return (torch.where(has, res.query_pos, entry),
            torch.where(has, res.query_dir, fb_dir))


def cache_targets_collision(scene: Scene, cfg: NRCConfig, pos: torch.Tensor,
                            d: torch.Tensor, hg: torch.Tensor,
                            walk: Sequence[torch.Tensor],
                            shade: Sequence = ()) -> torch.Tensor:
    """MC estimate of the cache's target S(x, d_in) = NEE(x, d_in) + the
    mean over target_samples HG-sampled continuation walks (no-cache
    collision or delta walks; their escapes are covered by the NEE).
    ``hg`` (2, S*N) and ``walk`` are the direction and walk uniforms,
    ``shade`` the NEE's and then the walk's shade draws (empty when they
    draw nothing)."""
    s_count = cfg.train.target_samples
    n = pos.shape[0]
    nee = pathtrace.trace_scene(scene, cfg, pos, d, cfg.train.env_samples,
                                shade[0] if shade else None)
    pos_t = pos.repeat(s_count, 1)
    d_t = phase_ops.sample_hg_direction(d.repeat(s_count, 1),
                                        cfg.volume.hg_g, uniforms=hg)
    res = pathtrace.trace_path_collision(
        scene, _train_walk_cfg(cfg), pos_t, d_t, None, use_nn=False,
        env_samples=cfg.train.env_samples,
        max_bounces=cfg.train.target_bounces,
        uniforms=pathtrace.PathUniforms(walk, list(shade[1:])))
    cont = torch.mean(res.scattered.reshape(s_count, n, 3), dim=0)
    return nee + cont


def choose_train_vertices(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                          rd: torch.Tensor, uniforms: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference sampler's RR vertex walk (nrc-train.comp:1173-1215):
    the walk breaks before a bounce with the RR draw, scatters (HG) where
    the density is nonzero, steps U(0, step_fraction * distance to exit);
    returns (pos, dir) of its last vertex, or (entry, -normalize(entry))
    when it never scattered. Misses are re-aimed at the origin.
    uniforms: (vertex_walk_steps, 4, N) [u_rr, u_hg1, u_hg2, u_d]."""
    vol = cfg.volume
    pt = cfg.path
    _, _, hit = volume_ops.ray_aabb(ro, rd, vol.box_size, vol.box_center)
    rd = torch.where(hit[:, None], rd, -ro / torch.linalg.vector_norm(
        ro, dim=-1, keepdim=True))
    entry, fb_dir = _entry_fallback(cfg, ro, rd)
    n = ro.shape[0]
    pos, d = entry, rd
    term_prob = torch.ones((n,), dtype=ro.dtype, device=ro.device)
    done = torch.zeros((n,), dtype=torch.bool, device=ro.device)
    did_scatter = torch.zeros_like(done)
    for u in uniforms:
        u_rr, u_hg1, u_hg2, u2 = u.unbind(0)
        # break BEFORE the bounce (train :1192-1196)
        done = done | ((u_rr > term_prob) & ~done)
        term_prob = torch.where(done, term_prob, term_prob * pt.rr_decay)
        density = volume_ops.density_at(scene.density, pos, vol)
        scatter = (density > 0.0) & ~done
        new_dir = phase_ops.hg_direction_from_uniforms(u_hg1, u_hg2, d,
                                                       vol.hg_g)
        d = torch.where(scatter[:, None], new_dir, d)
        did_scatter = did_scatter | scatter
        _, t_exit, _ = volume_ops.ray_aabb(pos, d, vol.box_size,
                                           vol.box_center)
        dist = u2 * torch.clamp(t_exit, min=0.0) * pt.step_fraction
        pos = torch.where(done[:, None], pos, pos + d * dist[:, None])
    return (torch.where(did_scatter[:, None], pos, entry),
            torch.where(did_scatter[:, None], d, fb_dir))


def trace_target_paths(scene: Scene, cfg: NRCConfig, pos: torch.Tensor,
                       d: torch.Tensor, uniforms: torch.Tensor,
                       shade: Optional[pathtrace.SceneUniforms] = None
                       ) -> torch.Tensor:
    """Batched TracePath (nrc-train.comp:1123-1171) for the reference
    sampler's targets: the fixed ``target_bounces``-step scatter walk from
    (pos, d), no Russian roulette, no cache. Each step's event -- vertex,
    previous scatter vertex, direction, density, scatter flag -- is
    recorded step-major; the valid events are shaded once, all of them, or
    with ``train.compact_events`` > 0 the first ``compact_events * N`` in
    step-major order (a stable sort: the deepest events drop first), and
    the throughput is the cumulative product over the steps.

    uniforms: (target_bounces, 4, N) [-, u_hg1, u_hg2, u_d] (JAX:
    ``fold_in(key, 0)``); shade: the shade call's draws (``fold_in(key,
    1)``). Returns (N, 3) scattered radiance."""
    vol = cfg.volume
    pt = cfg.path
    n = pos.shape[0]
    dtype, device = pos.dtype, pos.device
    entry, _, _ = volume_ops.entry_exit_points(pos, d, vol.box_size,
                                               vol.box_center)
    cur, last, cd = entry, entry, d
    ys = []
    for u in uniforms:
        dens = volume_ops.density_at(scene.density, cur, vol)
        scatter = dens > 0.0
        ys.append((cur, last, cd, dens, scatter))
        last = torch.where(scatter[:, None], cur, last)
        nd = phase_ops.hg_direction_from_uniforms(u[1], u[2], cd, vol.hg_g)
        cd = torch.where(scatter[:, None], nd, cd)
        _, t_exit, _ = volume_ops.ray_aabb(cur, cd, vol.box_size,
                                           vol.box_center)
        cur = cur + cd * (u[3] * torch.clamp(t_exit, min=0.0)
                          * pt.step_fraction)[:, None]
    ev_pos, ev_prev, ev_dir, ev_dens, valid = (torch.stack(c)
                                               for c in zip(*ys))
    steps = ev_dens.shape[0]
    ns = steps * n
    cap = _target_cap(cfg, n)
    packed = torch.cat([ev_pos, ev_prev, ev_dir, ev_dens[..., None]],
                       dim=-1).reshape(ns, 10)
    flat_valid = valid.reshape(ns)
    env = cfg.train.env_samples
    if cap < ns:
        profiling.cap(flat_valid, cap, "target_events")
        # the valid events first, in step-major order (JAX: the stable
        # jnp.argsort(~valid))
        sel = torch.argsort((~flat_valid).to(torch.int32), stable=True)[:cap]
        rows = packed[sel]
        sel_valid = flat_valid[sel]
        t_r_sel = pathtrace._segment_t(scene, cfg, rows[:, 0:3], rows[:, 3:6])
        light_sel = pathtrace.trace_scene(scene, cfg, rows[:, 0:3],
                                          rows[:, 6:9], env, shade)
        t_r = torch.ones((ns,), dtype=dtype, device=device)
        t_r[sel] = torch.where(sel_valid, t_r_sel, 1.0)
        light = torch.zeros((ns, 3), dtype=dtype, device=device)
        light[sel] = torch.where(sel_valid[:, None], light_sel, 0.0)
    else:
        t_r = torch.where(flat_valid, pathtrace._segment_t(
            scene, cfg, packed[:, 0:3], packed[:, 3:6]), 1.0)
        light = torch.where(flat_valid[:, None], pathtrace.trace_scene(
            scene, cfg, packed[:, 0:3], packed[:, 6:9], env, shade), 0.0)
    t_r = t_r.reshape(steps, n)
    light = light.reshape(steps, n, 3)
    t_incl = scan.cumprod(t_r, dim=0)  # throughput AFTER each step's event
    t_before = torch.cat([torch.ones((1, n), dtype=dtype, device=device),
                          t_incl[:-1]], dim=0)
    contrib = (valid * t_before * ev_dens)[..., None] * light
    return torch.sum(contrib, dim=0)


def generate_train_batch_for_rays(scene: Scene, cfg: NRCConfig,
                                  ro: torch.Tensor, rd: torch.Tensor,
                                  uniforms: TrainUniforms) -> TrainBatch:
    """Train batch for a :func:`train_ray_pool`-shaped ray set (the
    oversample copies included): ``ro.shape[0] // vertex_oversample``
    rows."""
    if cfg.path.sampler == "reference":
        pos, d = choose_train_vertices(scene, cfg, ro, rd,
                                       uniforms.vertex[0])
        s_count, n = cfg.train.target_samples, pos.shape[0]
        scattered = trace_target_paths(
            scene, cfg, pos.repeat(s_count, 1), d.repeat(s_count, 1),
            uniforms.target[0], uniforms.shade[0] if uniforms.shade else None)
        target = torch.mean(scattered.reshape(s_count, n, 3), dim=0)
        target = torch.clamp(target, max=cfg.train.target_clamp)
        return TrainBatch(pos=pos, dir=d, target=target)
    over = _oversample(cfg)
    n = ro.shape[0] // over
    if over > 1:
        res = pathtrace.trace_path_collision(
            scene, _train_walk_cfg(cfg), ro, rd, None, use_nn=True,
            env_samples=0, uniforms=uniforms.vertex)
        has = res.query_weight > 0.0
        # permute lanes before the stable pack: compact_select keeps the
        # FIRST n marked lanes, so unpermuted the last jitter set used would
        # contribute only top-of-frame cuts
        perm = uniforms.perm
        sel_p, val = compact.compact_select(has[perm], n)
        sel = perm[sel_p]
        # not enough cuts: the entry fallback on padding lanes
        entry, fb_dir = _entry_fallback(cfg, ro[:n], rd[:n])
        pos = torch.where(val[:, None], res.query_pos[sel], entry)
        d = torch.where(val[:, None], res.query_dir[sel], fb_dir)
    else:
        pos, d = choose_train_vertices_collision(scene, cfg, ro, rd,
                                                 uniforms.vertex)
    target = cache_targets_collision(scene, cfg, pos, d, uniforms.hg,
                                     uniforms.target, uniforms.shade)
    target = torch.clamp(target, max=cfg.train.target_clamp)
    return TrainBatch(pos=pos, dir=d, target=target)


@profiling.spanned("train.batch")
def generate_train_batch(scene: Scene, cfg: NRCConfig,
                         generator: Optional[torch.Generator],
                         uniforms: Optional[TrainUniforms] = None
                         ) -> TrainBatch:
    """One frame's train batch: (jittered) train-grid rays -> RR-cut
    vertices -> averaged path-traced targets. ``uniforms`` replaces the
    draw from ``generator``."""
    if uniforms is None:
        uniforms = draw_train_uniforms(cfg, generator,
                                       scene.camera.position.device)
    ro, rd = train_ray_pool(scene, cfg, uniforms.jitter)
    return generate_train_batch_for_rays(scene, cfg, ro, rd, uniforms)
