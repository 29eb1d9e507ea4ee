"""Monte-Carlo volumetric path tracing with the analytic collision sampler
and the radiance-cache query (the serving render).

Counterpart of ``neuralradiancecaching_tpu/render/pathtrace.py`` for the
slice the port runs: ``PathTraceConfig.sampler='collision'`` with the cache
on (``use_nn``), one walk phase, prefix-packed event shading, 'field' light
modes and a full (uncapped) cache query. The JAX ``lax.scan`` over walk
slots is a Python loop over the ``coll_max_events`` slots.

Randomness: the walk draws all its uniforms at once, a (k_steps, 4, n)
tensor [u_rr, u_t, u_hg1, u_hg2] per slot, from a ``torch.Generator`` --
or takes them from the caller (``uniforms``). The shade draws nothing in
the field light modes, and the entry optical depth is a quadrature, so the
whole render is a deterministic function of those uniforms: fed the JAX
walk's own uniforms it reproduces the JAX image pixel for pixel.
Other samplers and modes raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from neuralradiancecaching_tpu.config import NRCConfig
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


def _check_collision_slice(cfg: NRCConfig, use_nn: bool) -> None:
    pt = cfg.path
    if not use_nn:
        raise NotImplementedError("the no-cache collision walk is not "
                                  "ported yet")
    if 0 < pt.coll_phase1_steps < min(pt.coll_max_events, pt.max_bounces) \
            and pt.coll_live_fraction > 0.0:
        raise NotImplementedError("the collision march split is not ported "
                                  "yet")
    if pt.coll_shade_cap <= 0.0 or pt.coll_shade_bf16:
        raise NotImplementedError("only the f32 prefix-packed event shade "
                                  "is ported yet")


def trace_path_collision(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                         rd: torch.Tensor,
                         generator: Optional[torch.Generator], use_nn: bool,
                         env_samples: int | None = None,
                         max_bounces: int | None = None,
                         uniforms: Optional[torch.Tensor] = None
                         ) -> PathResult:
    """Analytic-collision path walk (PathTraceConfig.sampler='collision').

    Per slot, ONE collision-row gather gives the optical depth ahead and
    the quantile knots of its profile; the scatter branch is integrated
    analytically (each event carries prod_j (1 - exp(-tau_j))), Russian
    roulette cuts the walk into a cache query, and the events are shaded
    once, prefix-packed. The slot-0 optical depth comes from an exact
    ``entry_tau_steps`` quadrature at the ray's box entry.

    uniforms: optional (k_steps, 4, n) [u_rr, u_t, u_hg1, u_hg2] per slot;
    drawn from ``generator`` only when None.
    """
    _check_collision_slice(cfg, use_nn)
    vol = cfg.volume
    pt = cfg.path
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    if max_bounces is None:
        max_bounces = pt.max_bounces
    k_steps = min(pt.coll_max_events, max_bounces)
    n = ro.shape[0]
    dtype, device = ro.dtype, ro.device
    half = torch.tensor(vol.box_size, dtype=dtype, device=device) * 0.5
    ctr = torch.tensor(vol.box_center, dtype=dtype, device=device)
    lo_box, hi_box = ctr - half, ctr + half

    if uniforms is None:
        uniforms = torch.rand((k_steps, 4, n), generator=generator,
                              dtype=dtype, device=device)
    elif tuple(uniforms.shape) != (k_steps, 4, n):
        raise ValueError(f"uniforms must be {(k_steps, 4, n)}, got "
                         f"{tuple(uniforms.shape)}")

    entry, _, hit = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                 vol.box_center)
    # exact slot-0 tau: primary rays enter ON the box face, maximally far
    # from the collision row's voxel-centre anchor
    if pt.entry_tau_steps > 0:
        _, exit_e, _ = volume_ops.entry_exit_points(entry, rd, vol.box_size,
                                                    vol.box_center)
        t_e = volume_ops.transmittance(scene.density, entry, exit_e,
                                       pt.entry_tau_steps, vol)
        etau = torch.clamp(-torch.log(torch.clamp(t_e, min=1e-20)), max=40.0)
    else:
        etau = None

    pos, dirn = entry, rd
    weight = torch.ones((n,), dtype=dtype, device=device)
    term_prob = torch.ones((n,), dtype=dtype, device=device)
    done = ~hit
    tau0 = None  # first-slot optical depth
    has_q = torch.zeros((n,), dtype=torch.bool, device=device)
    q_pos, q_dir = entry, rd
    last_in = rd
    q_w = torch.zeros((n,), dtype=dtype, device=device)
    ev_pos, ev_dir, ev_w = [], [], []

    for k in range(k_steps):
        u_rr, u_t, u_hg1, u_hg2 = uniforms[k].unbind(0)
        tau, knots = collision.query_collision_rows(scene.coll_field, pos,
                                                    dirn, vol)
        if k == 0 and etau is not None:
            # exact entry tau replaces the row tau for T0 and the first
            # event; the knots still map the row profile's shape
            tau = etau
        p_sc = -torch.expm1(-tau)
        alive = ~done & (p_sc > 1e-6)
        t = collision.knots_to_distance(tau, knots, u_t)
        # knots are baked from the bucket's voxel centre, so a sampled point
        # can overshoot the box by up to a field voxel -- clamp
        x = torch.minimum(torch.maximum(pos + t[:, None] * dirn, lo_box),
                          hi_box)
        terminate = alive & (u_rr > term_prob)
        scatter = alive & ~terminate
        ev_w_k = weight * p_sc
        if cfg.quirks.query_dir_phase:
            # reference frag:785-786: the cut carries HG(dir, previous dir)
            q_new = ev_w_k * phase_ops.hg_phase(
                torch.sum(dirn * -last_in, dim=-1), vol.hg_g)
        else:
            q_new = ev_w_k
        has_q = has_q | terminate
        q_pos = torch.where(terminate[:, None], x, q_pos)
        q_dir = torch.where(terminate[:, None], dirn, q_dir)
        q_w = torch.where(terminate, q_new, q_w)
        last_in = torch.where(scatter[:, None], dirn, last_in)
        if tau0 is None:
            tau0 = tau
        ev_pos.append(x)
        ev_dir.append(dirn)
        ev_w.append(torch.where(scatter, ev_w_k, 0.0))

        weight = torch.where(scatter, ev_w_k, weight)
        term_prob = torch.where(scatter, term_prob * pt.rr_decay, term_prob)
        new_dir = phase_ops.hg_direction_from_uniforms(u_hg1, u_hg2, dirn,
                                                       vol.hg_g)
        dirn = torch.where(scatter[:, None], new_dir, dirn)
        pos = torch.where(scatter[:, None], x, pos)
        done = done | terminate | ~alive

    # primary see-through: T0 = exp(-tau of the camera segment)
    t0_trans = torch.where(hit, torch.exp(-tau0), 1.0)
    scattered = _prefix_shade(scene, cfg, torch.stack(ev_pos),
                              torch.stack(ev_dir), torch.stack(ev_w),
                              env_samples)
    return PathResult(scattered, t0_trans, q_pos, q_dir,
                      torch.where(has_q, q_w, 0.0))


def _prefix_shade(scene: Scene, cfg: NRCConfig, e_pos: torch.Tensor,
                  e_dir: torch.Tensor, e_w: torch.Tensor,
                  env_samples: int) -> torch.Tensor:
    """Shade step-major (k, lanes, .) events once, prefix-packed: each
    lane's valid events are a prefix of its slots, so they pack to
    coll_shade_cap events per lane on average (overflow drops the highest
    lanes) and sum back per lane. Returns (lanes, 3)."""
    k, lanes = e_w.shape
    nk = k * lanes
    cap = min(nk, max(1024, int(lanes * cfg.path.coll_shade_cap)))
    w_rm = e_w.T  # (lanes, k); 0 marks invalid
    packed = torch.cat([e_pos, e_dir], dim=-1).transpose(0, 1).reshape(nk, 6)
    counts = torch.sum(w_rm > 0.0, dim=1)
    row, slot, val_e = compact.compact_prefix(counts, cap)
    idx = row * k + torch.clamp(slot, max=k - 1)
    rows = packed[idx]
    w_rows = w_rm.reshape(nk)[idx]
    light = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 3:6], env_samples)
    contrib = torch.where(val_e[:, None], w_rows[:, None] * light, 0.0)
    return compact.prefix_segment_sum(contrib, counts, slot)


def trace_path(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
               rd: torch.Tensor, generator: Optional[torch.Generator],
               use_nn: bool, env_samples: int | None = None,
               max_bounces: int | None = None,
               uniforms: Optional[torch.Tensor] = None) -> PathResult:
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
