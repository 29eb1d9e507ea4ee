"""Monte-Carlo volumetric path tracing with the analytic collision sampler:
the cached serving render and the no-cache walks of the train targets.

Counterpart of ``neuralradiancecaching_tpu/render/pathtrace.py`` for the
paths the port runs: ``PathTraceConfig.sampler='collision'`` with the cache
on (``use_nn``, the render and the train-vertex walk) or off (the target
walks: weight Russian roulette, the march split with its cascade repack
and the two-phase prefix shade), prefix-packed event shading (f32 or bf16
event stacks), 'field' light modes and a full (uncapped) cache query; and
the deferred pieces of the banded frame (render/tiled.py): the walk's
collect mode, which returns its scatter events unshaded, and the
frame-global shade and cache query (``shade_and_query``,
``finish_deferred``). The JAX ``lax.scan`` over walk slots is a Python
loop.

Randomness: each walk phase draws its uniforms at once, a (steps, 4,
lanes) tensor [u_rr, u_t, u_hg1, u_hg2] per slot, from a
``torch.Generator`` -- or takes them from the caller (``uniforms``: one
tensor per phase, the shapes of :func:`walk_uniform_shapes`, matching the
JAX draws ``fold_in(key, 0/1/2)``). The shade draws nothing in the field
light modes, and the entry optical depth is a quadrature, so a walk is a
deterministic function of those uniforms: fed the JAX walk's own uniforms
it reproduces the JAX result lane for lane. Other samplers and modes raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import (Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.ops import collision, compact, lightfield
from neuralradiancecaching_tpu_torch.ops import envmap as envmap_ops
from neuralradiancecaching_tpu_torch.ops import phase as phase_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops
from neuralradiancecaching_tpu_torch.scene.scene import Scene

# A cache query function: (pos (N,3), dir (N,3)) -> radiance (N,3)
QueryFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def trace_scene(scene: Scene, cfg: NRCConfig, pos: torch.Tensor,
                direction: torch.Tensor, env_samples: int) -> torch.Tensor:
    """Direct in-scattered light at scatter vertices (TraceScene,
    nrc-forward.frag:751-755): dir light + point light + env, in the
    deterministic 'field' modes. pos/direction: (N, 3) -> (N, 3)."""
    vol = cfg.volume
    lights = cfg.dir_light.enabled or cfg.point_light.enabled
    if lights and cfg.path.transmittance_mode != "field":
        raise NotImplementedError("only 'field' light transmittance is "
                                  "ported yet")
    total = torch.zeros_like(pos)

    if cfg.dir_light.enabled:
        # TraceDirLight (frag:664-675): white * strength, HG phase
        light = scene.dir_light
        to_light = -light.direction / torch.linalg.vector_norm(
            light.direction)
        _, exit_p, _ = volume_ops.entry_exit_points(
            pos, to_light.expand(pos.shape), vol.box_size, vol.box_center)
        t = lightfield.segment_transmittance_field(scene.env_t_field, pos,
                                                   exit_p, vol)
        ph = phase_ops.hg_phase(torch.sum(light.direction * -direction,
                                          dim=-1), vol.hg_g)
        total = total + (t * light.strength * ph)[:, None]

    if cfg.point_light.enabled:
        # TracePointLight (frag:677-688): no 1/r^2 falloff, as the reference
        light = scene.point_light
        lpos = light.position.expand(pos.shape)
        t = lightfield.segment_transmittance_field(scene.env_t_field, lpos,
                                                   pos, vol)
        wi = lpos - pos
        wi = wi / torch.clamp(torch.linalg.vector_norm(wi, dim=-1,
                                                       keepdim=True),
                              min=1e-8)
        ph = phase_ops.hg_phase(torch.sum(wi * -direction, dim=-1), vol.hg_g)
        total = total + light.color[None, :] * (light.strength * t
                                                * ph)[:, None]

    if env_samples > 0:
        if cfg.env_map.in_scatter_mode != "field":
            raise NotImplementedError("only the 'field' env in-scatter mode "
                                      "is ported yet")
        # the MC estimator's expectation, baked: ONE row gather per event
        total = total + scene.env.hpm_strength * \
            lightfield.query_radiance_field(scene.env_s_field, pos,
                                            direction, vol)
    return total


class PathResult(NamedTuple):
    scattered: torch.Tensor     # (N, 3) accumulated in-scattered light
    transmittance: torch.Tensor  # (N,) primary see-through T0
    query_pos: torch.Tensor     # (N, 3) cache-query position
    query_dir: torch.Tensor     # (N, 3)
    query_weight: torch.Tensor  # (N,) weight at the RR cut; 0 if none


class _Walk(NamedTuple):
    """Per-lane walk state (the JAX scan carry)."""
    pos: torch.Tensor        # (N, 3) current vertex
    dir: torch.Tensor        # (N, 3) current direction
    weight: torch.Tensor     # (N,) prod of past scatter probabilities
    term_prob: torch.Tensor  # (N,) RR survival threshold
    done: torch.Tensor       # (N,) bool
    tau0: torch.Tensor       # (N,) first-step tau (sentinel -1 unset)
    has_q: torch.Tensor      # (N,) bool: RR cut recorded
    q_pos: torch.Tensor      # (N, 3)
    q_dir: torch.Tensor      # (N, 3) incoming dir at the cut
    last_in: torch.Tensor    # (N, 3) previous event's incoming dir
    q_w: torch.Tensor        # (N,) weight at the cut (incl. quirk phase)
    etau: torch.Tensor       # (N,) exact entry tau (zeros when off)


def _check_collision_slice(cfg: NRCConfig, use_nn: bool,
                           collect_events: bool) -> None:
    pt = cfg.path
    if use_nn and 0 < pt.coll_phase1_steps < min(pt.coll_max_events,
                                                 pt.max_bounces) \
            and pt.coll_live_fraction > 0.0:
        raise NotImplementedError("the NN-mode collision march split is not "
                                  "ported yet")
    if pt.coll_shade_cap <= 0.0 and not collect_events:
        raise NotImplementedError("only the prefix-packed event shade is "
                                  "ported yet")


class _Plan(NamedTuple):
    """The static phase plan of one walk (pathtrace.py:438-513 of the JAX
    package): slots, the march split and its cascade, lane counts."""
    k_steps: int
    p1: int      # full-width slots before the first repack (0: no split)
    m1: int      # lanes after the first repack
    p2a: int     # slots at m1 lanes before the cascade repack (0: none)
    m2: int      # lanes after the cascade repack


def _plan(cfg: NRCConfig, n: int, use_nn: bool,
          max_bounces: int | None) -> _Plan:
    pt = cfg.path
    if max_bounces is None:
        max_bounces = pt.max_bounces
    # with RR (survival halves per event) 6 slots are distributionally
    # exact in NN mode; without RR every slot can scatter
    k_steps = min(pt.coll_max_events, max_bounces) if use_nn else max_bounces
    if use_nn:
        return _Plan(k_steps, 0, n, 0, n)  # the NN split raises above
    live_frac = pt.coll_nonn_live_fraction if pt.coll_weight_rr > 0.0 else 0.0
    p1 = pt.coll_nonn_phase1_steps
    if not (0 < p1 < k_steps and live_frac > 0.0):
        return _Plan(k_steps, 0, n, 0, n)
    m1 = min(n, max(1024, int(n * live_frac)))
    p2a = pt.coll_nonn_phase2_steps
    if not 0 < p2a < k_steps - p1:
        return _Plan(k_steps, p1, m1, 0, m1)
    m2 = min(m1, max(1024, int(n * pt.coll_nonn_live2_fraction)))
    return _Plan(k_steps, p1, m1, p2a, m2)


def walk_uniform_shapes(cfg: NRCConfig, n: int, use_nn: bool,
                        max_bounces: int | None = None
                        ) -> List[Tuple[int, int, int]]:
    """The (steps, 4, lanes) shape of each walk phase's uniforms, in the
    order trace_path_collision consumes them: one phase without a march
    split; (p1, n) and (k - p1, m1) with it; (p1, n), (p2a, m1) and
    (k - p1 - p2a, m2) with the cascade."""
    pl = _plan(cfg, n, use_nn, max_bounces)
    if not pl.p1:
        return [(pl.k_steps, 4, n)]
    if not pl.p2a:
        return [(pl.p1, 4, n), (pl.k_steps - pl.p1, 4, pl.m1)]
    return [(pl.p1, 4, n), (pl.p2a, 4, pl.m1),
            (pl.k_steps - pl.p1 - pl.p2a, 4, pl.m2)]


def _take(s: _Walk, idx: torch.Tensor) -> _Walk:
    return _Walk(*[x[idx] for x in s])


def _merge(s: _Walk, sel: torch.Tensor, valid: torch.Tensor,
           sub: _Walk) -> _Walk:
    return _Walk(*[compact.scatter_update(a, sel, valid, b)
                   for a, b in zip(s, sub)])


def trace_path_collision(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                         rd: torch.Tensor,
                         generator: Optional[torch.Generator], use_nn: bool,
                         env_samples: int | None = None,
                         max_bounces: int | None = None,
                         uniforms: torch.Tensor | Sequence[torch.Tensor]
                         | None = None, collect_events: bool = False,
                         entry_tau: Optional[torch.Tensor] = None):
    """Analytic-collision path walk (PathTraceConfig.sampler='collision').

    Per slot, ONE collision-row gather gives the optical depth ahead and
    the quantile knots of its profile; the scatter branch is integrated
    analytically (each event carries prod_j (1 - exp(-tau_j))). With the
    cache on (``use_nn``) Russian roulette cuts the walk into a cache
    query; with it off, weight Russian roulette retires lanes, the march
    packs the live lanes after ``coll_nonn_phase1_steps`` slots (and once
    more after ``coll_nonn_phase2_steps``, the cascade), and each phase's
    events are shaded prefix-packed at its own width. The slot-0 optical
    depth comes from an exact ``entry_tau_steps`` quadrature at the ray's
    box entry when that is on.

    uniforms: the walk's uniforms, one (steps, 4, lanes) tensor per phase
    (:func:`walk_uniform_shapes`; a bare tensor for a one-phase walk);
    drawn from ``generator`` only when None.

    collect_events=True skips the shade and returns (PathResult with
    scattered = 0, events (N, K, 7)): ray-major [pos(3), dir(3), weight(1)]
    rows, weight 0 for invalid slots, in bf16 when the scene fields are --
    for the frame-global deferred shade. Its march split is not ported.
    entry_tau: the precomputed exact slot-0 optical depth per ray (the
    pose-static hoist of render/tiled.py); computed here when None.
    """
    _check_collision_slice(cfg, use_nn, collect_events)
    vol = cfg.volume
    pt = cfg.path
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    n = ro.shape[0]
    dtype, device = ro.dtype, ro.device
    plan = _plan(cfg, n, use_nn, max_bounces)
    if collect_events and plan.p1:
        raise NotImplementedError("the collect-mode march split is not "
                                  "ported")
    shapes = walk_uniform_shapes(cfg, n, use_nn, max_bounces)
    if uniforms is None:
        uniforms = [torch.rand(sh, generator=generator, dtype=dtype,
                               device=device) for sh in shapes]
    elif isinstance(uniforms, torch.Tensor):
        uniforms = [uniforms]
    got = [tuple(u.shape) for u in uniforms]
    if got != shapes:
        raise ValueError(f"uniforms must be {shapes}, got {got}")
    half = torch.tensor(vol.box_size, dtype=dtype, device=device) * 0.5
    ctr = torch.tensor(vol.box_center, dtype=dtype, device=device)
    lo_box, hi_box = ctr - half, ctr + half

    entry, _, hit = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                 vol.box_center)
    # exact slot-0 tau: primary rays enter ON the box face, maximally far
    # from the collision row's voxel-centre anchor
    exact_entry = pt.entry_tau_steps > 0
    if exact_entry and entry_tau is not None:
        etau = entry_tau.to(dtype)
    elif exact_entry:
        _, exit_e, _ = volume_ops.entry_exit_points(entry, rd, vol.box_size,
                                                    vol.box_center)
        t_e = volume_ops.transmittance(scene.density, entry, exit_e,
                                       pt.entry_tau_steps, vol)
        etau = torch.clamp(-torch.log(torch.clamp(t_e, min=1e-20)), max=40.0)
    else:
        etau = torch.zeros((n,), dtype=dtype, device=device)
    # event stacks in bf16 (PathTraceConfig.coll_shade_bf16, or collected
    # events of bf16 fields): the same values as casting after the walk;
    # the shade upcasts after its gather
    ys_bf16 = (cfg.volume.field_dtype == "bfloat16" if collect_events
               else pt.coll_shade_bf16)
    ys_dtype = torch.bfloat16 if ys_bf16 else dtype
    weight_rr = 0.0 if use_nn else pt.coll_weight_rr

    def step(s: _Walk, u: torch.Tensor):
        u_rr, u_t, u_hg1, u_hg2 = u.unbind(0)
        tau, knots = collision.query_collision_rows(scene.coll_field, s.pos,
                                                    s.dir, vol)
        if exact_entry:
            # slot 0 only (tau0 unset): the exact entry tau replaces the row
            # tau for T0 and the first event; the knots still map the row
            # profile's shape
            tau = torch.where(s.tau0 < 0.0, s.etau, tau)
        p_sc = -torch.expm1(-tau)
        alive = ~s.done & (p_sc > 1e-6)
        t = collision.knots_to_distance(tau, knots, u_t)
        # knots are baked from the bucket's voxel centre, so a sampled point
        # can overshoot the box by up to a field voxel -- clamp
        x = torch.minimum(torch.maximum(s.pos + t[:, None] * s.dir, lo_box),
                          hi_box)
        if use_nn:
            terminate = alive & (u_rr > s.term_prob)
            scatter = alive & ~terminate
            done = s.done | terminate | ~alive
        else:
            scatter = alive
            done = s.done | ~alive
        ev_w = s.weight * p_sc
        weight = torch.where(scatter, ev_w, s.weight)
        if weight_rr > 0.0:
            # weight Russian roulette on the CONTINUATION (unbiased: the
            # current event keeps its analytic weight; survivors divide by
            # their survival probability)
            p_surv = torch.clamp(ev_w / weight_rr, 0.0, 1.0)
            die = scatter & (u_rr >= p_surv)
            weight = torch.where(scatter & ~die,
                                 ev_w / torch.clamp(p_surv, min=1e-12),
                                 weight)
            done = done | die
        term_prob = torch.where(scatter, s.term_prob * pt.rr_decay,
                                s.term_prob)
        new_dir = phase_ops.hg_direction_from_uniforms(u_hg1, u_hg2, s.dir,
                                                       vol.hg_g)
        s2 = s._replace(
            pos=torch.where(scatter[:, None], x, s.pos),
            dir=torch.where(scatter[:, None], new_dir, s.dir),
            weight=weight, term_prob=term_prob, done=done,
            tau0=torch.where(s.tau0 < 0.0, tau, s.tau0))
        if use_nn:
            if cfg.quirks.query_dir_phase:
                # reference frag:785-786: the cut carries HG(dir, previous
                # dir)
                q_new = ev_w * phase_ops.hg_phase(
                    torch.sum(s.dir * -s.last_in, dim=-1), vol.hg_g)
            else:
                q_new = ev_w
            s2 = s2._replace(
                has_q=s.has_q | terminate,
                q_pos=torch.where(terminate[:, None], x, s.q_pos),
                q_dir=torch.where(terminate[:, None], s.dir, s.q_dir),
                q_w=torch.where(terminate, q_new, s.q_w),
                last_in=torch.where(scatter[:, None], s.dir, s.last_in))
        ys = (x, s.dir, torch.where(scatter, ev_w, 0.0))
        return s2, tuple(y.to(ys_dtype) for y in ys)

    def scan(s: _Walk, u: torch.Tensor):
        ys = []
        for k in range(u.shape[0]):
            s, y = step(s, u[k])
            ys.append(y)
        return s, tuple(torch.stack(c) for c in zip(*ys))

    lights = cfg.dir_light.enabled or cfg.point_light.enabled

    def shade(ys, lanes: int, cap_events: float = 0.0) -> torch.Tensor:
        if env_samples == 0 and not lights:
            # nothing to shade: trace_scene is zero at every event (the
            # train-vertex walk, whose caller reads only the cut)
            return torch.zeros((lanes, 3), dtype=dtype, device=device)
        return _prefix_shade(scene, cfg, *ys, env_samples, dtype,
                             cap_events)

    init = _Walk(pos=entry, dir=rd,
                 weight=torch.ones((n,), dtype=dtype, device=device),
                 term_prob=torch.ones((n,), dtype=dtype, device=device),
                 done=~hit,
                 tau0=torch.full((n,), -1.0, dtype=dtype, device=device),
                 has_q=torch.zeros((n,), dtype=torch.bool, device=device),
                 q_pos=entry, q_dir=rd, last_in=rd,
                 q_w=torch.zeros((n,), dtype=dtype, device=device),
                 etau=etau)
    if not plan.p1:
        s_fin, ys = scan(init, uniforms[0])
        scattered = (torch.zeros((n, 3), dtype=dtype, device=device)
                     if collect_events else shade(ys, n))
    else:
        # march split: full-width slots 0..p1-1, then the live lanes packed
        # to m1 lanes (O(n) cumsum compaction; overflow drops the highest
        # lanes); each phase's events shade prefix-packed at its own width
        # and one (m1, 3) scatter-add puts phase 2's sums back
        s1, ys1 = scan(init, uniforms[0])
        sel, sel_valid = compact.compact_select(~s1.done, plan.m1)
        sub = _take(s1, sel)
        sub = sub._replace(done=sub.done | ~sel_valid)  # inert padding
        if plan.p2a:
            # cascade: a second repack to m2 lanes p2a slots into phase 2
            s2a, ys2a = scan(sub, uniforms[1])
            sel2, val2 = compact.compact_select(~s2a.done, plan.m2)
            sub2 = _take(s2a, sel2)
            sub2 = sub2._replace(done=sub2.done | ~val2)
            s2b, ys2b = scan(sub2, uniforms[2])
            s2 = _merge(s2a, sel2, val2, s2b)
            sc2 = shade(ys2a, plan.m1)
            sc2b = torch.where(val2[:, None], shade(ys2b, plan.m2), 0.0)
            sc2 = sc2.index_add(0, sel2, sc2b)
        else:
            s2, ys2 = scan(sub, uniforms[1])
            sc2 = shade(ys2, plan.m1)
        s_fin = _merge(s1, sel, sel_valid, s2)
        sc1 = shade(ys1, n, cap_events=pt.coll_shade_cap_p1)
        sc2 = torch.where(sel_valid[:, None], sc2, 0.0)
        scattered = sc1.index_add(0, sel, sc2)

    # primary see-through: T0 = exp(-tau of the camera segment)
    t0_trans = torch.where(hit, torch.exp(-s_fin.tau0), 1.0)
    res = PathResult(scattered, t0_trans, s_fin.q_pos, s_fin.q_dir,
                     torch.where(s_fin.has_q, s_fin.q_w, 0.0))
    if collect_events:
        ev = torch.cat([ys[0], ys[1], ys[2][..., None]], dim=-1)  # (K, N, 7)
        return res, ev.transpose(0, 1)
    return res


def _prefix_shade(scene: Scene, cfg: NRCConfig, e_pos: torch.Tensor,
                  e_dir: torch.Tensor, e_w: torch.Tensor,
                  env_samples: int, dtype: torch.dtype,
                  cap_events: float = 0.0) -> torch.Tensor:
    """Shade step-major (k, lanes, .) events once, prefix-packed: each
    lane's valid events are a prefix of its slots, so they pack to a
    per-lane budget of ``cap_events`` (or coll_shade_cap) events on average
    (overflow drops the highest lanes) and sum back per lane. Event stacks
    in bf16 upcast to ``dtype`` after the pack's gather. Returns
    (lanes, 3)."""
    k, lanes = e_w.shape
    nk = k * lanes
    per_lane = cap_events or cfg.path.coll_shade_cap
    cap = min(nk, max(1024, int(lanes * per_lane)))
    w_rm = e_w.T  # (lanes, k); 0 marks invalid
    packed = torch.cat([e_pos, e_dir], dim=-1).transpose(0, 1).reshape(nk, 6)
    counts = torch.sum(w_rm > 0.0, dim=1)
    row, slot, val_e = compact.compact_prefix(counts, cap)
    idx = row * k + torch.clamp(slot, max=k - 1)
    rows = packed[idx].to(dtype)
    w_rows = w_rm.reshape(nk)[idx].to(dtype)
    light = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 3:6], env_samples)
    contrib = torch.where(val_e[:, None], w_rows[:, None] * light, 0.0)
    return compact.prefix_segment_sum(contrib, counts, slot)


def trace_path(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
               rd: torch.Tensor, generator: Optional[torch.Generator],
               use_nn: bool, env_samples: int | None = None,
               max_bounces: int | None = None,
               uniforms: torch.Tensor | Sequence[torch.Tensor] | None = None
               ) -> PathResult:
    """One path per ray; dispatches on PathTraceConfig.sampler (only the
    collision sampler is ported)."""
    if cfg.path.sampler != "collision":
        raise NotImplementedError(
            f"sampler={cfg.path.sampler!r} is not ported yet")
    return trace_path_collision(scene, cfg, ro, rd, generator, use_nn,
                                env_samples, max_bounces, uniforms)


def render_image(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                 rd: torch.Tensor, generator: Optional[torch.Generator],
                 query_fn: Optional[QueryFn] = None,
                 uniforms: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full render pass (nrc-forward.frag main, :837-870): path trace, the
    batched cache query at the RR cuts, and the analytic env see-through.
    Returns (rgb (N, 3), transmittance (N,))."""
    if cfg.render.query_cap_fraction < 1.0:
        raise NotImplementedError("capped cache queries are not ported yet")
    if cfg.render.spp != 1:
        raise NotImplementedError("spp > 1 is not ported yet")
    use_nn = cfg.render.use_nn and query_fn is not None
    res = trace_path(scene, cfg, ro, rd, generator, use_nn=use_nn,
                     uniforms=uniforms)
    rgb = res.scattered
    if use_nn and not cfg.render.show_non_nn:
        rgb = rgb + res.query_weight[:, None] * query_fn(res.query_pos,
                                                         res.query_dir)
    # collision mode: the primary escape is analytic, rgb += T0 * env
    env_color = envmap_ops.sample_direct(scene.env, rd, hpm=False)
    return rgb + res.transmittance[:, None] * env_color, res.transmittance


def shade_deferred(cfg: NRCConfig) -> bool:
    """True when band shading is deferred to the frame-global finish: the
    collision sampler with the deterministic 'field' light modes (the
    deferred shade draws nothing, so moving it out of the bands is exact).
    The JAX package also defers the 'delta' sampler, not ported here."""
    return (cfg.path.sampler == "collision"
            and cfg.path.defer_shade
            and cfg.env_map.in_scatter_mode == "field"
            and cfg.path.transmittance_mode == "field")


def render_band_deferred(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                         rd: torch.Tensor,
                         generator: Optional[torch.Generator],
                         entry_tau: Optional[torch.Tensor] = None,
                         uniforms: Optional[torch.Tensor] = None):
    """Band-local render work with the cache query -- and, when
    :func:`shade_deferred`, all event shading -- left to the caller's
    frame-global pass. Returns (rgb without the cache, trans, query_pos,
    query_dir, query_weight, events (N, K, 7)); K = 0 when the shade ran in
    the walk. Each ray is traced at one sample."""
    if shade_deferred(cfg):
        res, ev = trace_path_collision(scene, cfg, ro, rd, generator,
                                       use_nn=True, uniforms=uniforms,
                                       collect_events=True,
                                       entry_tau=entry_tau)
    else:
        res = trace_path(scene, cfg, ro, rd, generator, use_nn=True,
                         uniforms=uniforms)
        ev = torch.zeros((ro.shape[0], 0, 7), dtype=ro.dtype,
                         device=ro.device)
    q_w = (torch.zeros_like(res.query_weight) if cfg.render.show_non_nn
           else res.query_weight)
    return (res.scattered, res.transmittance, res.query_pos, res.query_dir,
            q_w, ev)


def shade_and_query(scene: Scene, cfg: NRCConfig, rgb: torch.Tensor,
                    q_pos: torch.Tensor, q_dir: torch.Tensor,
                    q_w: torch.Tensor, query_fn: QueryFn,
                    events: Optional[torch.Tensor] = None,
                    cap_n: Optional[int] = None) -> torch.Tensor:
    """Frame-global shade of the collected events and the cache query,
    without the env composite. Returns rgb (N, 3).

    The events' valid slots are a prefix of each ray's slots, so they pack
    with compact_prefix and sum back with prefix_segment_sum under a cap of
    ``shade_cap_fraction`` events per frame ray; with ``shade_slot0_dense``
    slot 0 shades dense and the cap budgets only the tail slots. The query
    runs on every lane (``query_cap_fraction`` 1) or on the querying lanes
    packed by compact_select under the cap. cap_n: the base count of both
    cap fractions (the full frame in the packed pipeline, where n is the
    packed width). The JAX package's ``query_chunk`` batching served only
    its compiler's program-size limit: one call here; the cap keeps its
    rounding up to whole chunks, which decides what a full cap drops.
    """
    n = rgb.shape[0]
    base = cap_n if cap_n is not None else n
    n_env = cfg.env_map.n_samples
    if events is not None and events.shape[1] > 0:
        k = events.shape[1]
        if cfg.render.shade_slot0_dense and k > 1:
            rows0 = events[:, 0, :].to(rgb.dtype)
            w0 = rows0[:, 6]
            light0 = trace_scene(scene, cfg, rows0[:, 0:3], rows0[:, 3:6],
                                 n_env)
            # mask BEFORE weighting: empty slots can shade to NaN
            rgb = rgb + torch.where((w0 > 0.0)[:, None], w0[:, None] * light0,
                                    0.0)
            events = events[:, 1:, :]
            k = k - 1
        flat = events.reshape(n * k, 7)
        counts = torch.sum(events[:, :, 6] > 0.0, dim=1)
        cap_e = min(n * k,
                    max(1024, int(base * cfg.render.shade_cap_fraction)))
        row, slot, val_e = compact.compact_prefix(counts, cap_e)
        idx = row * k + torch.clamp(slot, max=k - 1)
        rows = flat[idx].to(rgb.dtype)  # bf16 events upcast after the gather
        light = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 3:6], n_env)
        contrib = torch.where(val_e[:, None], rows[:, 6:7] * light, 0.0)
        rgb = rgb + compact.prefix_segment_sum(contrib, counts, slot)

    frac = cfg.render.query_cap_fraction
    has_q = q_w > 0.0
    if frac < 1.0:
        chunk = cfg.render.query_chunk
        capq = min(n, max(1024, int(base * frac)))
        if capq > chunk:  # whole chunks, as the JAX package; may exceed n
            capq = -(-capq // chunk) * chunk
        sel, sel_valid = compact.compact_select(has_q, capq)
        cache_sel = query_fn(q_pos[sel], q_dir[sel])
        cache_sel = torch.where(sel_valid[:, None], cache_sel, 0.0)
        cache = compact.scatter_back(n, sel, sel_valid, cache_sel, 0.0)
    else:
        cache = torch.where(has_q[:, None], query_fn(q_pos, q_dir), 0.0)
    return rgb + q_w[:, None] * cache


def finish_deferred(scene: Scene, cfg: NRCConfig, rd: torch.Tensor,
                    rgb: torch.Tensor, trans: torch.Tensor,
                    q_pos: torch.Tensor, q_dir: torch.Tensor,
                    q_w: torch.Tensor, query_fn: QueryFn,
                    events: Optional[torch.Tensor] = None,
                    env_rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global finish of deferred bands: shade_and_query, then the analytic
    env see-through composite rgb + T0 * env (frag:848-864 with the
    collision sampler's exact T0). env_rgb: the precomputed direct env
    radiance per pixel (pose-static); sampled from ``rd`` when None.
    Returns the final rgb (N, 3)."""
    if cfg.path.sampler != "collision":
        raise NotImplementedError(
            f"sampler={cfg.path.sampler!r} is not ported yet")
    rgb = shade_and_query(scene, cfg, rgb, q_pos, q_dir, q_w, query_fn,
                          events)
    if env_rgb is None:
        env_rgb = envmap_ops.sample_direct(scene.env, rd, hpm=False)
    return rgb + trans[:, None] * env_rgb
