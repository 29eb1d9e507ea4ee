"""The port's banded render against the JAX package's ``render_banded`` in
every branch the CLI reaches: the cache off (``render_image`` per band)
with each sampler, the cached reference sampler (the walk that shades in
the band, then the reference composite) and the delta sampler shading in
the band (quadrature light transmittance), the delta sampler's deferred
shade (packed and unpacked) and spp > 1 by virtual-ray expansion, at
32x32 in 8-row bands from one state, the same numpy scene and the JAX
package's own per-band draws (band key ``fold_in(key, y0)``, y0 = band x
band_rows, over spp sample-major copies; packed: ``fold_in(key, i)``).
Also ``finish_deferred``'s reference composite alone and
``shade_deferred`` for every sampler and light mode.

The JAX side is compiled by XLA:CPU's LLVM backend at -O0 (see
tests/test_torch_render.py). Bounds, each with its reason: f32 fields
throughout, so the slice bound of tests/test_torch_tiled.py -- >= 99.5% of
pixels within 1e-4 + 1e-3 |ref| and the image mean within 1e-4 relative
(a one-ulp difference can flip a field bucket, a delta acceptance or a
reference ``density > 0`` test and change that ray wholesale); the
composite alone: every pixel within 1e-6 + 1e-6 |ref| (the same selects
of the same values, the query's MLP in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.render import pathtrace as jpt
from neuralradiancecaching_tpu.render import tiled as jtiled
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import volume as tvol
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.render import tiled as ttiled
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from tests.test_torch_oracle import jax_path_uniforms
from tests.test_torch_tiled import (build, close_rows, frame_cfg, jax_o0,
                                    port_cfg, to_t)

R = dataclasses.replace
SIDE, BAND = 32, 8
N_BANDS, BAND_N = SIDE // BAND, BAND * SIDE
PIXEL_FRAC_OK, REL_MEAN = 0.995, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """Config 5's test cut (tests/test_torch_tiled.py:frame_cfg, f32 fields,
    the fused f32 query) at 32x32, both packages' scenes and state."""
    cfg = frame_cfg(w=SIDE, h=SIDE)
    return (cfg, *build(cfg))


def case_cfg(cfg, sampler, use_nn=True, spp=1, packed=False):
    """The frame config of one branch: 12 bounces, so the cache-off walks
    take their march splits (collision and delta after slot 8)."""
    return R(cfg, path=R(cfg.path, sampler=sampler, max_bounces=12),
             render=R(cfg.render, use_nn=use_nn, spp=spp,
                      live_pack_fraction=0.75 if packed else 0.0))


def band_keys(key, n, fold):
    return [jax.random.fold_in(key, fold(i)) for i in range(n)]


def jax_band_uniforms(cfg, key, packed=False, n_packed=0):
    """The JAX bands' draws in the port's seam, one entry per band: the
    cache off, what render_image takes (spp samples from split(band key));
    the cache on, one PathUniforms per sample-major copy of the bands."""
    spp = cfg.render.spp
    if not cfg.render.use_nn:
        out = []
        for k in band_keys(key, N_BANDS, lambda i: i * BAND):
            us = [jax_path_uniforms(cfg, ks, BAND_N, False)
                  for ks in (jax.random.split(k, spp) if spp > 1 else [k])]
            out.append(us if spp > 1 else us[0])
        return out
    n = spp * (n_packed if packed else N_BANDS)
    keys = band_keys(key, n, (lambda i: i) if packed else
                     (lambda i: i * BAND))
    return [jax_path_uniforms(cfg, k, BAND_N, True) for k in keys]


def assert_frame_close(out, ref):
    assert out.shape == ref.shape == (SIDE, SIDE, 3)
    assert np.isfinite(out).all() and ref.mean() > 0.0
    out, ref = out.reshape(-1, 3), ref.reshape(-1, 3)
    ok = close_rows(out, ref)
    rel = abs(out.mean() - ref.mean()) / abs(ref.mean())
    assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)


def run_both(scene, cfg, key, packed=False):
    """(port image, JAX image) of render_banded from the same draws."""
    _, js, ts, jstate, tstate = scene
    ref = np.asarray(jax_o0(lambda s, sc: jtiled.render_banded(
        s, sc, key, cfg, band_rows=BAND), jstate, js))
    tc = port_cfg(cfg)
    pack = ttiled.frame_live_pack(ts, tc, BAND) if packed else None
    u = jax_band_uniforms(cfg, key, packed,
                          pack.ro_p.shape[0] if packed else 0)
    out = ttiled.render_banded(tstate, ts, None, tc, BAND, pack=pack,
                               uniforms=u).numpy()
    return out, ref


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("sampler", ["reference", "collision", "delta"])
def test_cache_off_bands_match_jax(scene, sampler, spp):
    cfg = case_cfg(scene[0], sampler, use_nn=False, spp=spp)
    out, ref = run_both(scene, cfg, jax.random.PRNGKey(40 + spp))
    assert_frame_close(out, ref)


@pytest.mark.parametrize("spp", [1, 2])
def test_cached_reference_bands_match_jax(scene, spp):
    """The walk that shades in the band (two-phase march, compacted shade),
    then the frame-global query and the reference composite."""
    cfg = case_cfg(scene[0], "reference", spp=spp)
    assert not tpt.shade_deferred(port_cfg(cfg))
    out, ref = run_both(scene, cfg, jax.random.PRNGKey(50 + spp))
    assert_frame_close(out, ref)


def test_cached_delta_in_band_shade_matches_jax(scene):
    """The delta sampler with quadrature light transmittance: not deferred
    (the band walk shades its own events), then the analytic composite."""
    cfg = case_cfg(scene[0], "delta")
    cfg = R(cfg, path=R(cfg.path, transmittance_mode="quadrature"))
    assert not tpt.shade_deferred(port_cfg(cfg))
    out, ref = run_both(scene, cfg, jax.random.PRNGKey(55))
    assert_frame_close(out, ref)


@pytest.mark.parametrize("sampler,spp,packed", [
    ("delta", 1, False), ("delta", 1, True),
    ("collision", 2, False), ("collision", 2, True)])
def test_deferred_bands_match_jax(scene, sampler, spp, packed):
    """The collect walk as one batch over the (copies of the) bands, the
    deferred shade and query, and the mean over the copies."""
    cfg = case_cfg(scene[0], sampler, spp=spp, packed=packed)
    assert tpt.shade_deferred(port_cfg(cfg))
    out, ref = run_both(scene, cfg, jax.random.PRNGKey(60 + spp),
                        packed=packed)
    assert_frame_close(out, ref)


def test_finish_deferred_reference_composite_matches_jax(scene):
    """The reference composite alone: the env where a ray misses the box or
    its throughput is 1, else the shaded rgb plus the weighted cache."""
    cfg, js, ts, jstate, tstate = scene
    cfg = case_cfg(cfg, "reference")
    tc = port_cfg(cfg)
    n = SIDE * SIDE
    rng = np.random.default_rng(5)
    rgb = rng.random((n, 3), dtype=np.float32)
    trans = np.where(rng.random(n) < 0.3, 1.0,
                     rng.random(n)).astype(np.float32)
    qp = ((rng.random((n, 3)) - 0.5) * 0.9
          * np.asarray(cfg.volume.box_size)).astype(np.float32)
    qd = rng.standard_normal((n, 3)).astype(np.float32)
    qd /= np.linalg.norm(qd, axis=-1, keepdims=True)
    qw = np.where(rng.random(n) < 0.5, rng.random(n), 0.0).astype(np.float32)
    ev = np.zeros((n, 0, 7), np.float32)
    jro, jrd = jcam.pixel_rays(js.camera, SIDE, SIDE)
    ref = np.asarray(jax_o0(lambda s, sc, o, d: jpt.finish_deferred(
        sc, cfg, o, d, jnp.asarray(rgb), jnp.asarray(trans), jnp.asarray(qp),
        jnp.asarray(qd), jnp.asarray(qw), jnrc.make_baked_query_fn(
            s, jnrc.bake(s, cfg), cfg), events=jnp.asarray(ev)),
        jstate, js, jro, jrd))
    tro, trd = tcam.pixel_rays(ts.camera, SIDE, SIDE)
    qfn = tnrc.make_baked_query_fn(tstate, tnrc.bake(tstate, tc), tc)
    out = tpt.finish_deferred(ts, tc, tro, trd, *(torch.tensor(x) for x in (
        rgb, trans, qp, qd, qw)), qfn, events=torch.tensor(ev)).numpy()
    assert np.all(close_rows(out, ref, 1e-6, 1e-6))
    _, _, hit = tvol.ray_aabb(tro, trd, tc.volume.box_size,
                              tc.volume.box_center)
    see = ~hit.numpy() | (trans >= 1.0)
    assert 0 < see.sum() < n  # both sides of the select are held
    env = ttiled.frame_env_color(ts, tc).numpy()
    np.testing.assert_array_equal(out[see], env[see])


@pytest.mark.parametrize("sampler", ["reference", "collision", "delta"])
@pytest.mark.parametrize("modes", [("field", "field", True),
                                   ("ratio", "field", True),
                                   ("field", "mc", True),
                                   ("field", "field", False)])
def test_shade_deferred_matches_jax(scene, sampler, modes):
    cfg = scene[0]
    path_t, env_mode, defer = modes
    cfg = R(cfg, path=R(cfg.path, sampler=sampler, transmittance_mode=path_t,
                        defer_shade=defer),
            env_map=R(cfg.env_map, in_scatter_mode=env_mode))
    assert tpt.shade_deferred(port_cfg(cfg)) == jpt.shade_deferred(cfg)
    assert tpt.shade_deferred(port_cfg(cfg)) == (
        sampler != "reference" and modes == ("field", "field", True))


@pytest.mark.parametrize("packed", [False, True])
def test_collect_split_bands_match_jax(scene, packed):
    """The collect-mode march split through ``render_banded`` (JAX's
    test_collision_collect_split_banded_parity: p1 = 2, live fraction 0.5):
    each band walks alone, its phase-2 events shaded in the band at the
    packed m1 lanes and their sums riding the band's rgb into the finish,
    the finish shading only the phase-1 slots."""
    cfg, *_ = scene
    cfg = case_cfg(cfg, "collision", packed=packed)
    cfg = R(cfg, path=R(cfg.path, coll_phase1_steps=2,
                        coll_live_fraction=0.5))
    assert len(tpt.walk_uniform_shapes(port_cfg(cfg), BAND_N, True,
                                       collect_events=True)) == 2
    assert_frame_close(*run_both(scene, cfg, jax.random.PRNGKey(31),
                                 packed))


def test_collect_walk_takes_delta(scene):
    """The delta collect walk returns prefix-shaped events of shape (N, K,
    7) and no in-walk shade, as the collision one does."""
    cfg, _, ts, _, _ = scene
    tc = port_cfg(case_cfg(cfg, "delta"))
    ro, rd = tcam.pixel_rays(ts.camera, SIDE, SIDE)
    res, ev = tpt.trace_path_collision(
        ts, tc, ro, rd, torch.Generator().manual_seed(0), use_nn=True,
        collect_events=True)
    assert tuple(ev.shape) == (SIDE * SIDE, tc.path.coll_max_events, 7)
    assert not res.scattered.any()
    w = ev[..., 6].numpy()
    assert (w > 0).any()
    assert not np.any((w[:, 1:] > 0) & ~(w[:, :-1] > 0))
    assert np.isin(res.transmittance.numpy(), [0.0, 1.0]).all()
