"""Monte-Carlo volumetric path tracing: the three distance samplers, their
shade and the render pass.

Counterpart of ``neuralradiancecaching_tpu/render/pathtrace.py``. The
samplers (``PathTraceConfig.sampler``):

* ``'collision'`` -- the analytic collision walk over the baked collision
  field, with the cache on (``use_nn``: the render and the train-vertex
  walk) or off (weight Russian roulette, the march split with its cascade
  repack, the two-phase prefix shade); its collect mode returns the scatter
  events unshaded for the frame-global deferred shade and cache query of
  the banded frame (``shade_and_query``, ``finish_deferred``,
  render/tiled.py);
* ``'delta'`` -- batched Woodcock tracking against a global or a local
  (dilated coarse-grid) majorant, binary scatter/escape, the same walk
  skeleton with its own march split and the same collect mode: with
  'ratio' light transmittance and 'mc' env in-scatter it is the unbiased
  ground-truth oracle;
* ``'reference'`` -- the sequential march of nrc-forward.frag (the
  presets' default): K event slots per ray, the two-phase march, then the
  compacted or the dense per-slot shade with the segment transmittance
  between events and the cumulative-product throughput.

The banded frame (render/tiled.py) takes each band's walk from
:func:`render_band_deferred` -- the collect walk under the deferred shade
(collision and delta with the 'field' light modes, :func:`shade_deferred`),
else the walk that shades in the band -- and finishes the frame with
:func:`finish_deferred`: the deferred shade and the cache query, then the
env composite of :func:`render_image` (analytic rgb + T0 env for collision
and delta; for the reference sampler the env where a ray misses the box or
keeps a throughput of 1).

The shade (:func:`trace_scene`) runs the dir and point lights with 'field',
'quadrature' or 'ratio' segment transmittance, and the env in-scatter as
the baked 'field' or the 'mc' estimator (phase-sampled and inverse-CDF
samples with 'field', 'quadrature' or 'ratio' exit transmittance). The JAX
``lax.scan`` over walk slots is a Python loop.

Randomness: each walk phase draws its uniforms at once, a (steps, rows,
lanes) tensor per phase (:func:`walk_uniform_shapes`), and each shade call
that draws (ratio tracking, MC in-scatter) takes one :class:`SceneUniforms`
(:func:`scene_uniform_shapes`); :class:`PathUniforms` carries both for one
walk (:func:`path_uniform_shapes`). They are drawn from a
``torch.Generator`` or handed in by the caller, who can rebuild the JAX
package's own draws: fed them, a walk reproduces the JAX result lane for
lane.
"""

from __future__ import annotations

import math
from typing import (Callable, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.ops import (collision, compact,
                                                 lightfield, scan)
from neuralradiancecaching_tpu_torch.ops import envmap as envmap_ops
from neuralradiancecaching_tpu_torch.ops import phase as phase_ops
from neuralradiancecaching_tpu_torch.ops import volume as volume_ops
from neuralradiancecaching_tpu_torch.scene.scene import Scene
from neuralradiancecaching_tpu_torch.utils import profiling

# A cache query function: (pos (N,3), dir (N,3)) -> radiance (N,3)
QueryFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# most density samples one shade chunk holds in the ratio and quadrature
# estimators ((samples, 8) corner rows: ~0.5 GB at 2^24)
SHADE_CHUNK_SAMPLES = 1 << 24


# -- the shade ---------------------------------------------------------------

class SceneUniforms(NamedTuple):
    """The draws of one :func:`trace_scene` call over n shade rows; None
    where the configuration draws nothing. In brackets the JAX draw, K the
    call's shade key."""
    dir_ratio: Optional[torch.Tensor]    # (steps, n) [fold_in(K, 9101)]
    point_ratio: Optional[torch.Tensor]  # (steps, n) [fold_in(K, 9102)]
    # (n_phase, 2, n): phase-sampled env sample s's HG pair (u_cos, u_phi)
    # [split(fold_in(K, s))]
    env_hg: Optional[torch.Tensor]
    # (n_cdf, 2, n): CDF sample s's (u1, u2) [split(fold_in(K, n_phase + s))]
    env_cdf: Optional[torch.Tensor]
    # (n_env, steps, n): exit ratio candidates per env sample, the phase
    # samples first [fold_in(fold_in(K, s), 9201)]
    env_ratio: Optional[torch.Tensor]


def _env_split(cfg: NRCConfig, env_samples: int) -> Tuple[int, int]:
    """(phase-sampled, inverse-CDF) env sample counts."""
    n_cdf = int(round(env_samples * cfg.env_map.cdf_fraction))
    return env_samples - n_cdf, n_cdf


def scene_uniform_shapes(cfg: NRCConfig, n: int, env_samples: int
                         ) -> Optional[SceneUniforms]:
    """The shapes of one shade call's :class:`SceneUniforms` over n rows, or
    None when the shade draws nothing (the 'field' modes)."""
    steps = cfg.path.ratio_tracking_steps
    ratio = cfg.path.transmittance_mode == "ratio"
    mc = env_samples > 0 and cfg.env_map.in_scatter_mode == "mc"
    n_phase, n_cdf = _env_split(cfg, env_samples)
    shapes = SceneUniforms(
        dir_ratio=(steps, n) if ratio and cfg.dir_light.enabled else None,
        point_ratio=(steps, n) if ratio and cfg.point_light.enabled else None,
        env_hg=(n_phase, 2, n) if mc and n_phase else None,
        env_cdf=(n_cdf, 2, n) if mc and n_cdf else None,
        env_ratio=((env_samples, steps, n) if mc
                   and cfg.env_map.transmittance_mode == "ratio" else None))
    return None if all(s is None for s in shapes) else shapes


def draw_scene_uniforms(cfg: NRCConfig, n: int, env_samples: int,
                        generator: Optional[torch.Generator],
                        device: torch.device | str | None = None
                        ) -> Optional[SceneUniforms]:
    """Draw one shade call's :class:`SceneUniforms` from ``generator``."""
    shapes = scene_uniform_shapes(cfg, n, env_samples)
    if shapes is None:
        return None
    return SceneUniforms(*[
        None if sh is None else torch.rand(sh, generator=generator,
                                           device=device)
        for sh in shapes])


def _global_majorant(scene: Scene, cfg: NRCConfig,
                     dtype: torch.dtype) -> torch.Tensor:
    """density_factor * max(grid) + 1e-8: trilinear interpolation never
    exceeds the grid maximum."""
    return (cfg.volume.density_factor
            * torch.max(scene.density_grid).to(dtype) + 1e-8)


def trace_scene(scene: Scene, cfg: NRCConfig, pos: torch.Tensor,
                direction: torch.Tensor, env_samples: int,
                uniforms: Optional[SceneUniforms] = None) -> torch.Tensor:
    """Direct in-scattered light at scatter vertices (TraceScene,
    nrc-forward.frag:751-755): dir light + point light + env.
    pos/direction: (N, 3) -> (N, 3). ``uniforms``: the call's draws (shapes
    :func:`scene_uniform_shapes`); needed only by 'ratio' transmittance and
    'mc' in-scatter. The ratio and quadrature estimators run in row chunks
    of at most SHADE_CHUNK_SAMPLES density samples (rows are independent,
    so the chunking changes no value)."""
    shapes = scene_uniform_shapes(cfg, pos.shape[0], env_samples)
    if shapes is not None:
        if uniforms is None:
            raise ValueError("this shade draws: pass SceneUniforms")
        got = SceneUniforms(*[None if u is None else tuple(u.shape)
                              for u in uniforms])
        if got != shapes:
            raise ValueError(f"scene uniforms must be {shapes}, got {got}")
    pt, env_cfg = cfg.path, cfg.env_map
    steps = max(
        pt.ratio_tracking_steps if "ratio" in (pt.transmittance_mode,
                                               env_cfg.transmittance_mode)
        else 1,
        pt.transmittance_steps if pt.transmittance_mode == "quadrature"
        else 1,
        env_cfg.transmittance_steps
        if env_cfg.transmittance_mode == "quadrature" else 1)
    n = pos.shape[0]
    chunk = max(1024, SHADE_CHUNK_SAMPLES // steps)
    if steps == 1 or n <= chunk:
        return _trace_scene(scene, cfg, pos, direction, env_samples,
                            uniforms)
    return torch.cat([_trace_scene(
        scene, cfg, pos[lo:lo + chunk], direction[lo:lo + chunk],
        env_samples, None if uniforms is None else SceneUniforms(
            *[None if u is None else u[..., lo:lo + chunk]
              for u in uniforms]))
        for lo in range(0, n, chunk)])


def _trace_scene(scene: Scene, cfg: NRCConfig, pos: torch.Tensor,
                 direction: torch.Tensor, env_samples: int,
                 u: Optional[SceneUniforms]) -> torch.Tensor:
    vol = cfg.volume
    total = torch.zeros_like(pos)

    def segment_t(a, b, ratio_u):
        """Segment transmittance: tau field, quadrature, or ratio
        tracking."""
        mode = cfg.path.transmittance_mode
        if mode == "field":
            return lightfield.segment_transmittance_field(scene.env_t_field,
                                                          a, b, vol)
        if mode == "ratio":
            return volume_ops.transmittance_ratio(
                scene.density, a, b, ratio_u,
                _global_majorant(scene, cfg, pos.dtype), vol)
        return volume_ops.transmittance(scene.density, a, b,
                                        cfg.path.transmittance_steps, vol)

    if cfg.dir_light.enabled:
        # TraceDirLight (frag:664-675): white * strength, HG phase
        light = scene.dir_light
        to_light = -light.direction / torch.linalg.vector_norm(
            light.direction)
        _, exit_p, _ = volume_ops.entry_exit_points(
            pos, to_light.expand(pos.shape), vol.box_size, vol.box_center)
        t = segment_t(pos, exit_p, u and u.dir_ratio)
        ph = phase_ops.hg_phase(torch.sum(light.direction * -direction,
                                          dim=-1), vol.hg_g)
        total = total + (t * light.strength * ph)[:, None]

    if cfg.point_light.enabled:
        # TracePointLight (frag:677-688): no 1/r^2 falloff, as the reference
        light = scene.point_light
        lpos = light.position.expand(pos.shape)
        t = segment_t(lpos, pos, u and u.point_ratio)
        wi = lpos - pos
        wi = wi / torch.clamp(torch.linalg.vector_norm(wi, dim=-1,
                                                       keepdim=True),
                              min=1e-8)
        ph = phase_ops.hg_phase(torch.sum(wi * -direction, dim=-1), vol.hg_g)
        total = total + light.color[None, :] * (light.strength * t
                                                * ph)[:, None]

    if env_samples > 0 and cfg.env_map.in_scatter_mode == "field":
        # the MC estimator's expectation, baked: ONE row gather per event
        total = total + scene.env.hpm_strength * \
            lightfield.query_radiance_field(scene.env_s_field, pos,
                                            direction, vol)
    elif env_samples > 0:
        # SampleHdrEnvMap(pos, dir, N) (frag:710-749): phase-sampled rays
        # with transmittance to the box exit; optional inverse-CDF branch
        n_phase, n_cdf = _env_split(cfg, env_samples)
        env_mode = cfg.env_map.transmittance_mode

        def exit_transmittance(p, d, s):
            if env_mode == "field":
                return lightfield.query_transmittance_field(
                    scene.env_t_field, p, d, vol)
            _, exit_p, _ = volume_ops.entry_exit_points(p, d, vol.box_size,
                                                        vol.box_center)
            if env_mode == "ratio":
                return volume_ops.transmittance_ratio(
                    scene.density, p, exit_p, u.env_ratio[s],
                    _global_majorant(scene, cfg, p.dtype), vol)
            return volume_ops.transmittance(scene.density, p, exit_p,
                                            cfg.env_map.transmittance_steps,
                                            vol)

        acc = torch.zeros_like(pos)
        for s in range(n_phase):
            rnd_dir = phase_ops.sample_hg_direction(direction, vol.hg_g,
                                                    u.env_hg[s])
            if env_mode == "premultiplied":
                # one 12-float row: T * Env baked per (voxel, dir bucket)
                acc = acc + scene.env.hpm_strength * \
                    lightfield.query_radiance_field(scene.env_l_field, pos,
                                                    rnd_dir, vol)
            else:
                t = exit_transmittance(pos, rnd_dir, s)
                light = envmap_ops.sample_direct(scene.env, rnd_dir,
                                                 hpm=True)
                acc = acc + light * t[:, None]
        for s in range(n_cdf):
            rnd_dir, radiance = envmap_ops.importance_sample(
                scene.env, u.env_cdf[s, 0], u.env_cdf[s, 1], cfg.quirks)
            t = exit_transmittance(pos, rnd_dir, n_phase + s)
            ph = phase_ops.hg_phase(torch.sum(rnd_dir * -direction, dim=-1),
                                    vol.hg_g)
            acc = acc + radiance * scene.env.hpm_strength * (ph * t)[:, None]
        total = total + acc / env_samples
    return total


# -- the walks' random draws --------------------------------------------------

class PathUniforms(NamedTuple):
    """Every draw of one walk: its march phases' uniforms
    (:func:`walk_uniform_shapes`) and one :class:`SceneUniforms` per shade
    call (:func:`path_uniform_shapes`; empty when the shade draws
    nothing)."""
    walk: Sequence[torch.Tensor]
    shade: Sequence[Optional[SceneUniforms]]


class PathResult(NamedTuple):
    scattered: torch.Tensor     # (N, 3) accumulated in-scattered light
    transmittance: torch.Tensor  # (N,) see-through (T0, or the throughput)
    query_pos: torch.Tensor     # (N, 3) cache-query position
    query_dir: torch.Tensor     # (N, 3)
    query_weight: torch.Tensor  # (N,) weight at the RR cut; 0 if none


class _Plan(NamedTuple):
    """The static phase plan of one collision or delta walk
    (pathtrace.py:438-513 of the JAX package): slots, the march split and
    its cascade, lane counts, uniform rows per slot."""
    k_steps: int
    p1: int      # full-width slots before the first repack (0: no split)
    m1: int      # lanes after the first repack
    p2a: int     # slots at m1 lanes before the cascade repack (0: none)
    m2: int      # lanes after the cascade repack
    u_dim: int   # uniform rows per slot: 4, plus 2 per delta candidate


def _plan(cfg: NRCConfig, n: int, use_nn: bool, max_bounces: int | None,
          collect_events: bool = False) -> _Plan:
    pt = cfg.path
    delta = pt.sampler == "delta"
    u_dim = 4 + 2 * pt.delta_null_steps if delta else 4
    if max_bounces is None:
        max_bounces = pt.max_bounces
    # with RR (survival halves per event) 6 slots are distributionally
    # exact in NN mode; without RR every slot can scatter
    k_steps = min(pt.coll_max_events, max_bounces) if use_nn else max_bounces
    if use_nn:
        p1, live_frac = pt.coll_phase1_steps, pt.coll_live_fraction
    elif delta:
        # binary escape retires delta lanes without weight RR
        p1, live_frac = pt.delta_phase1_steps, pt.delta_live_fraction
    else:
        p1 = pt.coll_nonn_phase1_steps
        live_frac = (pt.coll_nonn_live_fraction if pt.coll_weight_rr > 0.0
                     else 0.0)
    if not (0 < p1 < k_steps and live_frac > 0.0):
        return _Plan(k_steps, 0, n, 0, n, u_dim)
    m1 = min(n, max(1024, int(n * live_frac)))
    # the cascade: only the no-NN collision walk that shades each phase
    # prefix-packed
    cascade = not (use_nn or delta or collect_events
                   or pt.coll_shade_cap <= 0.0)
    p2a = pt.coll_nonn_phase2_steps if cascade else 0
    if not 0 < p2a < k_steps - p1:
        return _Plan(k_steps, p1, m1, 0, m1, u_dim)
    m2 = min(m1, max(1024, int(n * pt.coll_nonn_live2_fraction)))
    return _Plan(k_steps, p1, m1, p2a, m2, u_dim)


def _ref_march(cfg: NRCConfig, n: int, use_nn: bool,
               max_bounces: int | None) -> Tuple[int, int, int, int]:
    """(march steps, phase-1 steps (0: one phase), phase-1 lanes (the entry
    kill's pack, n without it), lanes after the repack) of the reference
    sampler's march."""
    pt = cfg.path
    steps = pt.max_bounces if max_bounces is None else max_bounces
    p1 = pt.march_phase1_steps
    if not (use_nn and p1 > 0 and steps > p1
            and pt.transmittance_mode == "field"):
        return steps, 0, n, n
    m0 = (min(n, max(1024, int(n * pt.march_entry_fraction)))
          if pt.march_entry_fraction > 0 else n)
    return steps, p1, m0, min(m0, max(1024, int(n * pt.march_live_fraction)))


def walk_uniform_shapes(cfg: NRCConfig, n: int, use_nn: bool,
                        max_bounces: int | None = None,
                        collect_events: bool = False
                        ) -> List[Tuple[int, int, int]]:
    """The (steps, rows, lanes) shape of each walk phase's uniforms, in the
    order the walk consumes them (JAX: ``fold_in(key, 0/1/2)``). Collision
    and delta: rows 4 per slot [u_rr, u_t, u_hg1, u_hg2], plus delta's 2 per
    null-collision candidate; one phase without a march split, (p1, n) and
    (k - p1, m1) with it, (p1, n), (p2a, m1) and (k - p1 - p2a, m2) with the
    cascade. Reference: rows [u_rr, u_hg1, u_hg2, u_d]; (steps, n), or
    (p1, m0) and (steps - p1, m1) with the two-phase march (m0 = n without
    the entry kill)."""
    if cfg.path.sampler == "reference":
        steps, p1, m0, m1 = _ref_march(cfg, n, use_nn, max_bounces)
        return ([(steps, 4, n)] if not p1
                else [(p1, 4, m0), (steps - p1, 4, m1)])
    pl = _plan(cfg, n, use_nn, max_bounces, collect_events)
    if not pl.p1:
        return [(pl.k_steps, pl.u_dim, n)]
    if not pl.p2a:
        return [(pl.p1, pl.u_dim, n), (pl.k_steps - pl.p1, pl.u_dim, pl.m1)]
    return [(pl.p1, pl.u_dim, n), (pl.p2a, pl.u_dim, pl.m1),
            (pl.k_steps - pl.p1 - pl.p2a, pl.u_dim, pl.m2)]


def _shade_cap(k: int, lanes: int, per_lane: float) -> int:
    return min(k * lanes, max(1024, int(lanes * per_lane)))


def path_uniform_shapes(cfg: NRCConfig, n: int, use_nn: bool,
                        env_samples: int | None = None,
                        max_bounces: int | None = None,
                        collect_events: bool = False):
    """(walk shapes, shade row counts) of one walk: the row count of each
    shade call in JAX's key order -- collision and delta: the prefix shade
    of each march phase (k_scene, then fold_in(k_scene, 1/2)), or with
    ``coll_shade_cap <= 0`` the dense shade of each slot (fold_in(k_scene,
    slot)); in collect mode only the split's phase-2 shade
    (fold_in(k_scene, 1)); reference: one compacted call, or one dense call
    per slot (fold_in(k_scene, k)). The row counts are empty when the shade
    draws nothing."""
    pt = cfg.path
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    walk = walk_uniform_shapes(cfg, n, use_nn, max_bounces, collect_events)
    if scene_uniform_shapes(cfg, 1, env_samples) is None:
        return walk, []
    if pt.sampler == "reference":
        steps = walk[0][0] + (walk[1][0] if len(walk) > 1 else 0)
        k_slots = min(8, steps) if use_nn else steps
        if use_nn and pt.compact_events > 0:
            return walk, [min(n * k_slots,
                              max(1024, int(n * pt.compact_events)))]
        return walk, [n] * k_slots
    pl = _plan(cfg, n, use_nn, max_bounces, collect_events)
    if collect_events:
        if pl.p1 and pt.coll_shade_cap > 0.0:
            return walk, [_shade_cap(pl.k_steps - pl.p1, pl.m1,
                                     pt.coll_shade_cap)]
        return walk, []
    if pt.coll_shade_cap <= 0.0:
        return walk, [n] * pl.k_steps
    if not pl.p1:
        return walk, [_shade_cap(pl.k_steps, n, pt.coll_shade_cap)]
    rows = [_shade_cap(pl.p1, n, pt.coll_shade_cap_p1 or pt.coll_shade_cap)]
    if not pl.p2a:
        return walk, rows + [_shade_cap(pl.k_steps - pl.p1, pl.m1,
                                        pt.coll_shade_cap)]
    return walk, rows + [
        _shade_cap(pl.p2a, pl.m1, pt.coll_shade_cap),
        _shade_cap(pl.k_steps - pl.p1 - pl.p2a, pl.m2, pt.coll_shade_cap)]


def draw_path_uniforms(cfg: NRCConfig, n: int, use_nn: bool,
                       generator: Optional[torch.Generator],
                       device: torch.device | str | None = None,
                       env_samples: int | None = None,
                       max_bounces: int | None = None,
                       collect_events: bool = False) -> PathUniforms:
    """Draw every uniform of one walk over n rays from ``generator``."""
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    walk, rows = path_uniform_shapes(cfg, n, use_nn, env_samples,
                                     max_bounces, collect_events)
    return PathUniforms(
        [torch.rand(sh, generator=generator, device=device) for sh in walk],
        [draw_scene_uniforms(cfg, r, env_samples, generator, device)
         for r in rows])


def _path_uniforms(cfg: NRCConfig, n: int, use_nn: bool, env_samples: int,
                   max_bounces: int | None, uniforms,
                   generator: Optional[torch.Generator],
                   device, collect_events: bool = False) -> PathUniforms:
    """The walk's :class:`PathUniforms` from what the caller passed: a
    PathUniforms, the walk's uniforms alone (a tensor for a one-phase walk,
    or one per phase; the shade's then come from ``generator``), or None
    (all from ``generator``)."""
    walk_shapes, rows = path_uniform_shapes(cfg, n, use_nn, env_samples,
                                            max_bounces, collect_events)
    if isinstance(uniforms, PathUniforms):
        walk, shade = uniforms
    else:
        walk, shade = uniforms, None
    if walk is None:
        walk = [torch.rand(sh, generator=generator, device=device)
                for sh in walk_shapes]
    elif isinstance(walk, torch.Tensor):
        walk = [walk]
    got = [tuple(u.shape) for u in walk]
    if got != walk_shapes:
        raise ValueError(f"uniforms must be {walk_shapes}, got {got}")
    if shade is None:
        shade = [draw_scene_uniforms(cfg, r, env_samples, generator, device)
                 for r in rows]
    if len(shade) != len(rows):
        raise ValueError(f"{len(rows)} shade calls draw, got {len(shade)} "
                         "SceneUniforms")
    return PathUniforms(list(walk), list(shade))


def _nth(shade: Sequence[Optional[SceneUniforms]], i: int):
    return shade[i] if shade else None


# -- the collision and delta walks --------------------------------------------

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


def _take(s, idx: torch.Tensor):
    return type(s)(*[x[idx] for x in s])


def _merge(s, sel: torch.Tensor, valid: torch.Tensor, sub):
    return type(s)(*[compact.scatter_update(a, sel, valid, b)
                     for a, b in zip(s, sub)])


def _delta_majorant(scene: Scene, cfg: NRCConfig, dtype, device):
    """The per-event majorant of the delta walk: (lane positions, dirs,
    t_far) -> sigma_maj, global or local. The local majorant's static
    coverage check raises when its midpoint samples cannot cover the box
    diagonal at one coarse cell edge."""
    vol, pt = cfg.volume, cfg.path
    if pt.delta_majorant != "local":
        sig = _global_majorant(scene, cfg, dtype)
        return lambda pos, d, t_far: sig
    vox = [b / g for b, g in zip(vol.box_size, vol.grid_shape)]
    fpc = [-(-g // c) for g, c in zip(vol.grid_shape, pt.delta_majorant_cells)]
    min_edge = min(v * f for v, f in zip(vox, fpc))
    diag = math.sqrt(sum(b * b for b in vol.box_size))
    if pt.delta_majorant_samples * min_edge < diag:
        raise ValueError(
            f"delta_majorant_samples={pt.delta_majorant_samples} cannot "
            f"cover the box diagonal {diag:.1f} at coarse cell edge "
            f"{min_edge:.2f}; need >= {diag / min_edge:.1f}")
    cdims = pt.delta_majorant_cells
    maj_flat = volume_ops.majorant_grid(scene.density_grid.to(dtype),
                                        cdims).reshape(-1)
    cell_sz = torch.tensor([v * f for v, f in zip(vox, fpc)], dtype=dtype,
                           device=device)
    half = torch.tensor(vol.box_size, dtype=dtype, device=device) * 0.5
    lo = torch.tensor(vol.box_center, dtype=dtype, device=device) - half
    top = torch.tensor(cdims, dtype=torch.int32, device=device) - 1
    m = pt.delta_majorant_samples
    fr = (torch.arange(m, dtype=dtype, device=device) + 0.5) / m

    def local(pos, d, t_far):
        sp = pos[None] + (fr[:, None] * t_far[None])[..., None] * d[None]
        # truncating casts, as the JAX int32 cast
        idx = torch.minimum(torch.clamp(
            ((sp.reshape(-1, 3) - lo) / cell_sz).to(torch.int32), min=0), top)
        flat = ((idx[:, 0] * cdims[1] + idx[:, 1]) * cdims[2]
                + idx[:, 2]).to(torch.int64)
        bound = maj_flat[flat].reshape(m, pos.shape[0])
        return vol.density_factor * torch.amax(bound, dim=0) + 1e-8

    return local


def trace_path_collision(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                         rd: torch.Tensor,
                         generator: Optional[torch.Generator], use_nn: bool,
                         env_samples: int | None = None,
                         max_bounces: int | None = None,
                         uniforms=None, collect_events: bool = False,
                         entry_tau: Optional[torch.Tensor] = None):
    """The collision and delta walks (PathTraceConfig.sampler 'collision' or
    'delta').

    Collision: per slot, ONE collision-row gather gives the optical depth
    ahead and the quantile knots of its profile; the scatter branch is
    integrated analytically (each event carries prod_j (1 - exp(-tau_j))),
    and the slot-0 optical depth comes from an exact ``entry_tau_steps``
    quadrature at the box entry when that is on. Delta: batched Woodcock
    tracking -- the ``delta_null_steps`` candidate distances of a slot are a
    cumsum of exponentials under the slot's majorant (global, or local from
    the dilated coarse grid at ``delta_majorant_samples`` midpoints), so
    their acceptance tests are one batched density gather and the first
    accepted candidate is the scatter point; no acceptance before the exit
    is an escape (binary T0). With the cache on (``use_nn``) Russian
    roulette cuts the walk into a cache query; with it off, weight Russian
    roulette retires lanes. The march split packs the live lanes after
    ``coll_phase1_steps`` slots with the cache on, after
    ``coll_nonn_phase1_steps`` (delta: ``delta_phase1_steps``) without it
    (and, for the no-cache collision walk, once more after
    ``coll_nonn_phase2_steps``, the cascade); each phase's events are shaded
    prefix-packed at its own width. With ``coll_shade_cap <= 0`` the split's
    phase-2 events are written back to full width and every slot is shaded
    dense (masked before the weighting: empty slots can shade to NaN).

    uniforms: a :class:`PathUniforms`, or the walk's uniforms alone (one
    (steps, rows, lanes) tensor per phase, :func:`walk_uniform_shapes`; a
    bare tensor for a one-phase walk); what is missing is drawn from
    ``generator``.

    collect_events=True skips the shade and returns (PathResult with
    scattered = 0, events (N, K, 7)): ray-major [pos(3), dir(3), weight(1)]
    rows, weight 0 for invalid slots, in bf16 when the scene fields are --
    for the frame-global deferred shade (both samplers record prefix-shaped
    events). With the march split (and ``coll_shade_cap > 0``) only the p1
    phase-1 slots are returned: the phase-2 events are shaded here at the
    packed m1 lanes and their sums ride ``scattered``. entry_tau: the
    precomputed exact slot-0 optical depth per
    ray (the pose-static hoist of render/tiled.py); computed here when None.
    """
    vol = cfg.volume
    pt = cfg.path
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    n = ro.shape[0]
    dtype, device = ro.dtype, ro.device
    plan = _plan(cfg, n, use_nn, max_bounces, collect_events)
    pu = _path_uniforms(cfg, n, use_nn, env_samples, max_bounces, uniforms,
                        generator, device, collect_events)
    half = torch.tensor(vol.box_size, dtype=dtype, device=device) * 0.5
    ctr = torch.tensor(vol.box_center, dtype=dtype, device=device)
    lo_box, hi_box = ctr - half, ctr + half
    delta = pt.sampler == "delta"
    n_null = pt.delta_null_steps
    majorant = _delta_majorant(scene, cfg, dtype, device) if delta else None

    entry, _, hit = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                                 vol.box_center)
    # exact slot-0 tau: primary rays enter ON the box face, maximally far
    # from the collision row's voxel-centre anchor
    exact_entry = not delta and pt.entry_tau_steps > 0
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

    def distance(s: _Walk, u: torch.Tensor):
        """(alive, scatter probability, distance, first-step tau) of a
        slot."""
        if delta:
            ln = s.pos.shape[0]
            _, t_far, _ = volume_ops.ray_aabb(s.pos, s.dir, vol.box_size,
                                              vol.box_center)
            sigma_maj = majorant(s.pos, s.dir, t_far)
            u_null = u[4:].reshape(n_null, 2, ln)
            t_cand = scan.cumsum(-torch.log1p(-u_null[:, 0]), dim=0) \
                / sigma_maj                                      # (K, N)
            # clamp the gather positions, not the comparison: beyond-exit
            # candidates fail the t <= t_far test whatever their density
            xc = (s.pos[None] + torch.minimum(t_cand, t_far[None])[..., None]
                  * s.dir[None])
            dens = volume_ops.density_at(scene.density, xc.reshape(-1, 3),
                                         vol).reshape(n_null, ln)
            acc = (t_cand <= t_far[None]) & (u_null[:, 1] * sigma_maj < dens)
            found = acc.any(dim=0)
            # the first accepted candidate (argmax returns the first max)
            kidx = torch.argmax(acc.to(torch.int32), dim=0)
            t = torch.gather(t_cand, 0, kidx[None])[0]
            # first-step escape <=> the transmitted photon survives: T0 = 1
            # on escape, 0 on collision
            tau_first = torch.where(found, math.inf, 0.0).to(dtype)
            return ~s.done & found, torch.ones_like(t), t, tau_first
        tau, knots = collision.query_collision_rows(scene.coll_field, s.pos,
                                                    s.dir, vol)
        if exact_entry:
            # slot 0 only (tau0 unset): the exact entry tau replaces the row
            # tau for T0 and the first event; the knots still map the row
            # profile's shape
            tau = torch.where(s.tau0 < 0.0, s.etau, tau)
        p_sc = -torch.expm1(-tau)
        return (~s.done & (p_sc > 1e-6), p_sc,
                collision.knots_to_distance(tau, knots, u[1]), tau)

    def step(s: _Walk, u: torch.Tensor):
        u_rr, u_hg1, u_hg2 = u[0], u[2], u[3]
        alive, p_sc, t, tau_first = distance(s, u)
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
            tau0=torch.where(s.tau0 < 0.0, tau_first, s.tau0))
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

    def scan_walk(s: _Walk, u: torch.Tensor):
        ys = []
        for k in range(u.shape[0]):
            s, y = step(s, u[k])
            ys.append(y)
        return s, tuple(torch.stack(c) for c in zip(*ys))

    lights = cfg.dir_light.enabled or cfg.point_light.enabled

    def shade(ys, lanes: int, phase: int,
              cap_events: float = 0.0) -> torch.Tensor:
        if env_samples == 0 and not lights:
            # nothing to shade: trace_scene is zero at every event (the
            # train-vertex walk, whose caller reads only the cut)
            return torch.zeros((lanes, 3), dtype=dtype, device=device)
        return _prefix_shade(scene, cfg, *ys, env_samples, dtype,
                             cap_events, _nth(pu.shade, phase))

    init = _Walk(pos=entry, dir=rd,
                 weight=torch.ones((n,), dtype=dtype, device=device),
                 term_prob=torch.ones((n,), dtype=dtype, device=device),
                 done=~hit,
                 tau0=torch.full((n,), -1.0, dtype=dtype, device=device),
                 has_q=torch.zeros((n,), dtype=torch.bool, device=device),
                 q_pos=entry, q_dir=rd, last_in=rd,
                 q_w=torch.zeros((n,), dtype=dtype, device=device),
                 etau=etau)
    # coll_shade_cap <= 0: the split writes phase 2's slot rows back and the
    # walk shades every slot dense (in collect mode: leaves them unshaded)
    write_back = pt.coll_shade_cap <= 0.0
    dense = write_back and not collect_events
    if not plan.p1:
        s_fin, ys = scan_walk(init, pu.walk[0])
    else:
        # march split: full-width slots 0..p1-1, then the live lanes packed
        # to m1 lanes (O(n) cumsum compaction; overflow drops the highest
        # lanes)
        s1, ys1 = scan_walk(init, pu.walk[0])
        sel, sel_valid = compact.compact_select(
            ~s1.done, plan.m1, site="walk_repack_nn" if use_nn
            else "walk_repack")
        sub = _take(s1, sel)
        sub = sub._replace(done=sub.done | ~sel_valid)  # inert padding
        if plan.p2a:
            # cascade: a second repack to m2 lanes p2a slots into phase 2
            s2a, ys2a = scan_walk(sub, pu.walk[1])
            sel2, val2 = compact.compact_select(~s2a.done, plan.m2,
                                                site="walk_repack2")
            sub2 = _take(s2a, sel2)
            sub2 = sub2._replace(done=sub2.done | ~val2)
            s2b, ys2b = scan_walk(sub2, pu.walk[2])
            s2 = _merge(s2a, sel2, val2, s2b)
        else:
            s2, ys2 = scan_walk(sub, pu.walk[1])
        s_fin = _merge(s1, sel, sel_valid, s2)
        if write_back:
            # the phase-2 slot rows written back to full width (0 elsewhere)
            ys = tuple(torch.cat([a, compact.scatter_back(
                n, sel, sel_valid, b.transpose(0, 1), 0.0).transpose(0, 1)])
                for a, b in zip(ys1, ys2))
        else:
            ys = ys1  # phase-2 events shade at the packed m1 lanes below

    if dense:
        # one shade per slot (JAX: lax.map over the slots, key
        # fold_in(k_scene, slot)); mask BEFORE weighting: the zero-filled
        # rows of the written-back slots can shade to NaN
        e_pos, e_dir, e_w = (y.to(dtype) for y in ys)
        if env_samples == 0 and not lights:
            light = torch.zeros_like(e_pos)
        else:
            light = torch.stack([trace_scene(
                scene, cfg, e_pos[k], e_dir[k], env_samples,
                _nth(pu.shade, k)) for k in range(e_w.shape[0])])
        light = torch.where((e_w > 0.0)[..., None], light, 0.0)
        scattered = torch.sum(e_w[..., None] * light, dim=0)
    elif collect_events:
        scattered = torch.zeros((n, 3), dtype=dtype, device=device)
        if plan.p1 and not write_back:
            # the collect-mode split: the finish sees only the (n, p1)
            # phase-1 slots; the phase-2 events shade here at the packed m1
            # lanes and their per-lane sums ride the band's rgb
            sc2 = torch.where(sel_valid[:, None],
                              shade(ys2, plan.m1, 0), 0.0)
            scattered = scattered.index_add(0, sel, sc2)
    elif not plan.p1:
        scattered = shade(ys, n, 0)
    else:
        # each phase's events shade prefix-packed at its own width; one
        # (m1, 3) scatter-add puts phase 2's sums back
        if plan.p2a:
            sc2 = shade(ys2a, plan.m1, 1)
            sc2b = torch.where(val2[:, None], shade(ys2b, plan.m2, 2), 0.0)
            sc2 = sc2.index_add(0, sel2, sc2b)
        else:
            sc2 = shade(ys2, plan.m1, 1)
        sc1 = shade(ys1, n, 0, cap_events=pt.coll_shade_cap_p1)
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
                  cap_events: float = 0.0,
                  uniforms: Optional[SceneUniforms] = None) -> torch.Tensor:
    """Shade step-major (k, lanes, .) events once, prefix-packed: each
    lane's valid events are a prefix of its slots, so they pack to a
    per-lane budget of ``cap_events`` (or coll_shade_cap) events on average
    (overflow drops the highest lanes) and sum back per lane. Event stacks
    in bf16 upcast to ``dtype`` after the pack's gather. Returns
    (lanes, 3)."""
    k, lanes = e_w.shape
    nk = k * lanes
    cap = _shade_cap(k, lanes, cap_events or cfg.path.coll_shade_cap)
    w_rm = e_w.T  # (lanes, k); 0 marks invalid
    packed = torch.cat([e_pos, e_dir], dim=-1).transpose(0, 1).reshape(nk, 6)
    counts = torch.sum(w_rm > 0.0, dim=1)
    row, slot, val_e = compact.compact_prefix(counts, cap,
                                              site="prefix_shade")
    idx = row * k + torch.clamp(slot, max=k - 1)
    rows = packed[idx].to(dtype)
    w_rows = w_rm.reshape(nk)[idx].to(dtype)
    light = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 3:6], env_samples,
                        uniforms)
    contrib = torch.where(val_e[:, None], w_rows[:, None] * light, 0.0)
    return compact.prefix_segment_sum(contrib, counts, slot)


# -- the reference sampler ------------------------------------------------------

class _March(NamedTuple):
    """Per-lane state of the reference march; the event slots carry one
    extra column K where lanes that record nothing write."""
    cur_pos: torch.Tensor    # (N, 3)
    last_pos: torch.Tensor   # (N, 3) previous scatter vertex (or entry)
    cur_dir: torch.Tensor    # (N, 3)
    last_dir: torch.Tensor   # (N, 3)
    term_prob: torch.Tensor  # (N,)
    done: torch.Tensor       # (N,) bool
    cnt: torch.Tensor        # (N,) int64 recorded events
    has_query: torch.Tensor  # (N,) bool
    q_pos: torch.Tensor      # (N, 3)
    q_dir: torch.Tensor      # (N, 3)
    q_phase: torch.Tensor    # (N,) dirPhase at the cut
    ev_pos: torch.Tensor     # (N, K + 1, 3)
    ev_prev: torch.Tensor    # (N, K + 1, 3)
    ev_dir: torch.Tensor     # (N, K + 1, 3)
    ev_dens: torch.Tensor    # (N, K + 1)


def _segment_t(scene: Scene, cfg: NRCConfig, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Transmittance between the reference walk's vertices: the tau field,
    else the reference's quadrature (ratio tracking is for the NEE shade
    only)."""
    if cfg.path.transmittance_mode == "field":
        return lightfield.segment_transmittance_field(scene.env_t_field, a, b,
                                                      cfg.volume)
    return volume_ops.transmittance(scene.density, a, b,
                                    cfg.path.transmittance_steps, cfg.volume)


def _reference_path(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                    rd: torch.Tensor, generator: Optional[torch.Generator],
                    use_nn: bool, env_samples: int,
                    max_bounces: int | None, uniforms) -> PathResult:
    """The reference sampler's walk and shade (see :func:`trace_path`)."""
    vol = cfg.volume
    pt = cfg.path
    n = ro.shape[0]
    dtype, device = ro.dtype, ro.device
    steps, p1, m0, m1 = _ref_march(cfg, n, use_nn, max_bounces)
    k_slots = min(8, steps) if use_nn else steps
    pu = _path_uniforms(cfg, n, use_nn, env_samples, max_bounces, uniforms,
                        generator, device)
    entry, _, _ = volume_ops.entry_exit_points(ro, rd, vol.box_size,
                                               vol.box_center)
    slots = torch.arange(k_slots, device=device)

    def slot_buffer(x):
        return x[:, None].expand(n, k_slots + 1, *x.shape[1:]).contiguous()

    init = _March(
        cur_pos=entry, last_pos=entry, cur_dir=rd,
        last_dir=torch.zeros_like(rd),
        term_prob=torch.ones((n,), dtype=dtype, device=device),
        done=torch.zeros((n,), dtype=torch.bool, device=device),
        cnt=torch.zeros((n,), dtype=torch.int64, device=device),
        has_query=torch.zeros((n,), dtype=torch.bool, device=device),
        q_pos=entry, q_dir=rd, q_phase=torch.zeros((n,), dtype=dtype,
                                                   device=device),
        ev_pos=slot_buffer(entry), ev_prev=slot_buffer(entry),
        ev_dir=slot_buffer(rd),
        ev_dens=torch.zeros((n, k_slots + 1), dtype=dtype, device=device))

    def step(s: _March, u: torch.Tensor) -> _March:
        u_rr, u_hg1, u_hg2, u_d = u.unbind(0)
        density = volume_ops.density_at(scene.density, s.cur_pos, vol)
        has_density = (density > 0.0) & ~s.done
        if use_nn:
            terminate = has_density & (u_rr > s.term_prob)
            if cfg.quirks.query_dir_phase:
                # reference frag:785-786 (QuirkFlags.query_dir_phase)
                dir_phase = phase_ops.hg_phase(
                    torch.sum(s.cur_dir * -s.last_dir, dim=-1), vol.hg_g)
            else:
                dir_phase = torch.ones_like(density)
            s = s._replace(
                has_query=s.has_query | terminate,
                q_phase=torch.where(terminate, dir_phase, s.q_phase),
                q_pos=torch.where(terminate[:, None], s.cur_pos, s.q_pos),
                q_dir=torch.where(terminate[:, None], s.cur_dir, s.q_dir),
                done=s.done | terminate,
                term_prob=torch.where(has_density & ~terminate,
                                      s.term_prob * pt.rr_decay,
                                      s.term_prob))
            scatter = has_density & ~terminate
        else:
            scatter = has_density
        # record the event in slot cnt: every lane writes, lanes that
        # record nothing into the spare column K
        record = scatter & (s.cnt < k_slots)
        lane = torch.arange(s.cnt.shape[0], device=device)
        col = torch.where(record, s.cnt, k_slots)
        s.ev_pos[lane, col] = s.cur_pos
        s.ev_prev[lane, col] = s.last_pos
        s.ev_dir[lane, col] = s.cur_dir
        s.ev_dens[lane, col] = density
        new_dir = phase_ops.hg_direction_from_uniforms(u_hg1, u_hg2,
                                                       s.cur_dir, vol.hg_g)
        cur_dir = torch.where(scatter[:, None], new_dir, s.cur_dir)
        # advance (frag:814-818): U(0, step_fraction * dist_to_exit)
        _, t_exit, _ = volume_ops.ray_aabb(s.cur_pos, cur_dir, vol.box_size,
                                           vol.box_center)
        max_dist = torch.clamp(t_exit, min=0.0) * pt.step_fraction
        return s._replace(
            cnt=s.cnt + record.to(torch.int64),
            last_pos=torch.where(scatter[:, None], s.cur_pos, s.last_pos),
            last_dir=torch.where(scatter[:, None], s.cur_dir, s.last_dir),
            cur_dir=cur_dir,
            cur_pos=torch.where(s.done[:, None], s.cur_pos,
                                s.cur_pos + cur_dir
                                * (u_d * max_dist)[:, None]))

    def march(s: _March, u: torch.Tensor) -> _March:
        for k in range(u.shape[0]):
            s = step(s, u[k])
        return s

    if not p1:
        s = march(init, pu.walk[0])
    else:
        # two-phase march: after p1 full-width steps, rays with no optical
        # depth ahead can never scatter, query or change their throughput
        # again; the others are packed to m1 lanes for the remaining steps
        # (overflow keeps the phase-1 state of the highest lanes)
        s0 = init
        if m0 < n:
            # the entry kill: rays with no optical depth at entry can never
            # scatter (env see-through, cnt 0, throughput 1); phase 1 marches
            # only the others, packed to m0 lanes
            tau0 = lightfield.query_tau_field(scene.env_t_field, entry, rd,
                                              vol)
            sel0, val0 = compact.compact_select(tau0 > 1e-4, m0,
                                                site="march_entry")
            s0 = _take(init, sel0)
            s0 = s0._replace(done=s0.done | ~val0)
        s1 = march(s0, pu.walk[0])
        tau_ahead = lightfield.query_tau_field(scene.env_t_field, s1.cur_pos,
                                               s1.cur_dir, vol)
        live = ~s1.done & (tau_ahead > 1e-4)
        sel, val = compact.compact_select(live, m1, site="march_repack")
        sub = _take(s1, sel)
        sub = march(sub._replace(done=sub.done | ~val), pu.walk[1])
        s = _merge(s1, sel, val, sub)
        if m0 < n:
            s = _merge(init, sel0, val0, s)

    # shade the recorded events
    ev_pos, ev_prev = s.ev_pos[:, :k_slots], s.ev_prev[:, :k_slots]
    ev_dir, ev_dens = s.ev_dir[:, :k_slots], s.ev_dens[:, :k_slots]
    valid = slots[None, :] < s.cnt[:, None]  # (N, K)
    if use_nn and pt.compact_events > 0:
        # cross-ray compaction: the valid events packed to the front, a
        # capped batch shaded; unselected slots keep t_r = 1 and light = 0
        nk = n * k_slots
        cap = min(nk, max(1024, int(n * pt.compact_events)))
        packed = torch.cat([ev_pos, ev_prev, ev_dir, ev_dens[..., None]],
                           dim=-1).reshape(nk, 10)
        sel, sel_valid = compact.compact_select(valid.reshape(nk), cap,
                                                site="march_events")
        rows = packed[sel]
        t_r_sel = _segment_t(scene, cfg, rows[:, 0:3], rows[:, 3:6])
        light_sel = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 6:9],
                                env_samples, _nth(pu.shade, 0))
        t_r = compact.scatter_back(
            nk, sel, sel_valid, torch.where(sel_valid, t_r_sel, 1.0),
            1.0).reshape(n, k_slots)
        light = compact.scatter_back(
            nk, sel, sel_valid,
            torch.where(sel_valid[:, None], light_sel, 0.0),
            0.0).reshape(n, k_slots, 3)
    else:
        # dense per-slot shade, one slot at a time so transients stay
        # O(N) (JAX: lax.map over the slots, key fold_in(k_scene, slot))
        t_r_k, light_k = [], []
        for k in range(k_slots):
            t_r_k.append(_segment_t(scene, cfg, ev_pos[:, k], ev_prev[:, k]))
            light_k.append(trace_scene(scene, cfg, ev_pos[:, k], ev_dir[:, k],
                                       env_samples, _nth(pu.shade, k)))
        t_r = torch.where(valid, torch.stack(t_r_k, dim=1), 1.0)
        light = torch.stack(light_k, dim=1)
    ones = torch.ones((n, 1), dtype=dtype, device=device)
    # the sequential `transmittance *= t_r` (frag:801-804) as a cumprod
    t_incl = scan.cumprod(t_r, dim=1)  # throughput AFTER event k
    t_before = torch.cat([ones, t_incl[:, :-1]], dim=1)
    contrib = (valid * t_before * ev_dens)[..., None] * light
    scattered = torch.sum(contrib, dim=1)
    # throughput over all recorded events: the reference's transmittance
    # at the RR cut (frag:786) and at the loop end (frag:821)
    t_at = torch.cat([ones, t_incl], dim=1)
    t_final = torch.gather(t_at, 1, torch.clamp(s.cnt, max=k_slots)[:, None]
                           )[:, 0]
    q_w = torch.where(s.has_query, t_final * s.q_phase, 0.0)
    return PathResult(scattered, t_final, s.q_pos, s.q_dir, q_w)


def trace_path(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
               rd: torch.Tensor, generator: Optional[torch.Generator],
               use_nn: bool, env_samples: int | None = None,
               max_bounces: int | None = None, uniforms=None) -> PathResult:
    """One path per ray (TracePath, nrc-forward.frag:758-822); dispatches on
    PathTraceConfig.sampler. Collision and delta: see
    :func:`trace_path_collision`.

    Reference: the sequential march in two phases. The march fetches the
    density at the current vertex (one corner-table row per ray-step),
    draws the RR and scatter decisions and records each scatter event --
    position, previous vertex, direction, density -- into K slots per ray
    (K = min(8, max_bounces) with the cache on, max_bounces without), then
    steps U(0, step_fraction * distance to exit). With the cache on and
    'field' transmittance the march is two-phase: after
    ``march_phase1_steps`` full-width steps the rays with optical depth
    ahead are packed to ``march_live_fraction`` of the lanes. The shade
    runs once over the recorded events -- compacted to
    ``compact_events`` events per ray with the cache on, else dense slot by
    slot -- and the path throughput is the cumulative product of the
    segment transmittances. The cache query is recorded at the RR cut
    (weight T * dirPhase, frag:785-787); the caller runs it batched.

    uniforms: a :class:`PathUniforms`, or the walk's uniforms alone (see
    :func:`path_uniform_shapes`); what is missing is drawn from
    ``generator``.
    """
    if env_samples is None:
        env_samples = cfg.env_map.n_samples
    if cfg.path.sampler in ("collision", "delta"):
        return trace_path_collision(scene, cfg, ro, rd, generator, use_nn,
                                    env_samples, max_bounces, uniforms)
    return _reference_path(scene, cfg, ro, rd, generator, use_nn,
                           env_samples, max_bounces, uniforms)


# -- the render pass -------------------------------------------------------------

def _capped_query(cfg: NRCConfig, query_fn: QueryFn, q_pos: torch.Tensor,
                  q_dir: torch.Tensor, has_q: torch.Tensor,
                  base: int) -> torch.Tensor:
    """The cache query on the querying lanes only, packed by compact_select
    under a cap of ``query_cap_fraction * base`` lanes (rounded up to whole
    ``query_chunk``s, as the JAX package; the cap decides what a full pack
    drops), scattered back; 0 on every other lane. The JAX package's chunk
    batching served only its compiler's program-size limit: one call
    here."""
    n = q_pos.shape[0]
    chunk = cfg.render.query_chunk
    capq = min(n, max(1024, int(base * cfg.render.query_cap_fraction)))
    if capq > chunk:  # whole chunks; may exceed n (compact_select pads)
        capq = -(-capq // chunk) * chunk
    sel, sel_valid = compact.compact_select(has_q, capq, site="query")
    cache_sel = torch.where(sel_valid[:, None],
                            query_fn(q_pos[sel], q_dir[sel]), 0.0)
    return compact.scatter_back(n, sel, sel_valid, cache_sel, 0.0)


def render_image(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                 rd: torch.Tensor, generator: Optional[torch.Generator],
                 query_fn: Optional[QueryFn] = None, uniforms=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full render pass (nrc-forward.frag main, :837-870): the spp-averaged
    path trace, the batched cache query at the RR cuts (on every ray, or
    packed under ``query_cap_fraction``), and the env composite: collision
    and delta add the see-through T0 * env; the reference sampler shows the
    env where the ray misses the box or its throughput stays 1.

    uniforms: what :func:`trace_path` takes, for spp 1; a sequence of spp of
    them for spp > 1 (JAX: one key per sample). Returns (rgb (N, 3),
    transmittance (N,))."""
    use_nn = cfg.render.use_nn and query_fn is not None
    n = ro.shape[0]

    def one_sample(u):
        with profiling.span("render.walk"):
            res = trace_path(scene, cfg, ro, rd, generator, use_nn=use_nn,
                             uniforms=u)
        rgb = res.scattered
        if use_nn and not cfg.render.show_non_nn:
            with profiling.span("render.query"):
                if cfg.render.query_cap_fraction < 1.0:
                    cache = _capped_query(cfg, query_fn, res.query_pos,
                                          res.query_dir,
                                          res.query_weight > 0.0, n)
                else:
                    cache = query_fn(res.query_pos, res.query_dir)
                rgb = rgb + res.query_weight[:, None] * cache
        return rgb, res.transmittance

    spp = cfg.render.spp
    if spp == 1:
        rgb, trans = one_sample(uniforms)
    else:
        if uniforms is None:
            uniforms = [None] * spp
        if len(uniforms) != spp:
            raise ValueError(f"spp={spp} needs {spp} sets of uniforms, got "
                             f"{len(uniforms)}")
        rgbs, transs = zip(*[one_sample(u) for u in uniforms])
        rgb = torch.mean(torch.stack(rgbs), dim=0)
        trans = torch.mean(torch.stack(transs), dim=0)

    with profiling.span("render.finish"):
        env_color = envmap_ops.sample_direct(scene.env, rd, hpm=False)
        return _env_composite(cfg, ro, rd, rgb, trans, env_color), trans


def _env_composite(cfg: NRCConfig, ro: torch.Tensor, rd: torch.Tensor,
                   rgb: torch.Tensor, trans: torch.Tensor,
                   env_color: torch.Tensor) -> torch.Tensor:
    """The direct env composite (frag:848-864). Collision and delta: the
    analytic primary escape rgb + T0 * env (delta samples T0 binarily,
    E[trans] = T0); reference: the env where the ray misses the box or its
    throughput stays 1."""
    if cfg.path.sampler in ("collision", "delta"):
        return rgb + trans[:, None] * env_color
    _, _, hit = volume_ops.ray_aabb(ro, rd, cfg.volume.box_size,
                                    cfg.volume.box_center)
    return torch.where((~hit | (trans >= 1.0))[:, None], env_color, rgb)


# -- the banded frame's deferred pieces --------------------------------------------

def shade_deferred(cfg: NRCConfig) -> bool:
    """True when band shading is deferred to the frame-global finish: the
    collision or delta sampler with the deterministic 'field' light modes
    (the deferred shade draws nothing, so moving it out of the bands is
    exact; both samplers record prefix-shaped (pos, dir, weight) events)."""
    return (cfg.path.sampler in ("collision", "delta")
            and cfg.path.defer_shade
            and cfg.env_map.in_scatter_mode == "field"
            and cfg.path.transmittance_mode == "field")


def render_band_deferred(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                         rd: torch.Tensor,
                         generator: Optional[torch.Generator],
                         entry_tau: Optional[torch.Tensor] = None,
                         uniforms=None):
    """Band-local render work with the cache query -- and, when
    :func:`shade_deferred`, all event shading -- left to the caller's
    frame-global pass. Returns (rgb without the cache, trans, query_pos,
    query_dir, query_weight, events (N, K, 7)); K = 0 when the shade ran in
    the walk (then ``entry_tau`` is unused: the walk computes its own, as
    the JAX package's). Each ray is traced at one sample; ``uniforms`` is
    what :func:`trace_path` takes."""
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
    packed under the cap (:func:`_capped_query`). cap_n: the base count of
    both cap fractions (the full frame in the packed pipeline, where n is
    the packed width).
    """
    n = rgb.shape[0]
    base = cap_n if cap_n is not None else n
    n_env = cfg.env_map.n_samples
    if events is not None and events.shape[1] > 0:
        with profiling.span("render.shade"):
            rgb = _shade_events(scene, cfg, rgb, events, base, n_env)

    with profiling.span("render.query"):
        has_q = q_w > 0.0
        if cfg.render.query_cap_fraction < 1.0:
            cache = _capped_query(cfg, query_fn, q_pos, q_dir, has_q, base)
        else:
            cache = torch.where(has_q[:, None], query_fn(q_pos, q_dir), 0.0)
        return rgb + q_w[:, None] * cache


def _shade_events(scene: Scene, cfg: NRCConfig, rgb: torch.Tensor,
                  events: torch.Tensor, base: int,
                  n_env: int) -> torch.Tensor:
    """The deferred shade of :func:`shade_and_query`: rgb plus the
    events' light."""
    n = rgb.shape[0]
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
    row, slot, val_e = compact.compact_prefix(counts, cap_e,
                                              site="deferred_shade")
    idx = row * k + torch.clamp(slot, max=k - 1)
    rows = flat[idx].to(rgb.dtype)  # bf16 events upcast after the gather
    light = trace_scene(scene, cfg, rows[:, 0:3], rows[:, 3:6], n_env)
    contrib = torch.where(val_e[:, None], rows[:, 6:7] * light, 0.0)
    return rgb + compact.prefix_segment_sum(contrib, counts, slot)


def finish_deferred(scene: Scene, cfg: NRCConfig, ro: torch.Tensor,
                    rd: torch.Tensor, rgb: torch.Tensor, trans: torch.Tensor,
                    q_pos: torch.Tensor, q_dir: torch.Tensor,
                    q_w: torch.Tensor, query_fn: QueryFn,
                    events: Optional[torch.Tensor] = None,
                    env_rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global finish of deferred bands: shade_and_query, then the env
    composite of :func:`render_image` (collision and delta: rgb + T0 * env;
    reference: the env on a miss or a throughput of 1). env_rgb: the
    precomputed direct env radiance per pixel (pose-static); sampled from
    ``rd`` when None. Returns the final rgb (N, 3)."""
    rgb = shade_and_query(scene, cfg, rgb, q_pos, q_dir, q_w, query_fn,
                          events)
    with profiling.span("render.finish"):
        if env_rgb is None:
            env_rgb = envmap_ops.sample_direct(scene.env, rd, hpm=False)
        return _env_composite(cfg, ro, rd, rgb, trans, env_rgb)
