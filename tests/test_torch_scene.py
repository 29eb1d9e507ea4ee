"""The port's camera, volume sampling, env map, baked fields, collision
sampling and compaction against the JAX package, at a small size (grid
(16, 12, 20), field_shape (6, 5, 8), 8 collision steps, (8, 16) scatter quadrature
directions), from the same numpy inputs.

The JAX scene is built by the jitted ``make_scene`` compiled with XLA:CPU's
LLVM backend at -O0 (``jax_o0``). At the default level the backend contracts
multiply-adds differently in duplicated fused expressions, so a floor() and
its fraction can disagree and the trilinear sampler lands one cell off: ~1.6%
of the scatter bake's transmittances then differ from the op-by-op JAX result
by > 1e-5 (up to 8% relative), while -O0, op-by-op JAX and the port agree to
~1e-6. Tolerances are fp32 ones, stated per check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as cfg_mod
from neuralradiancecaching_tpu.io import assets
from neuralradiancecaching_tpu.ops import collision as jcoll
from neuralradiancecaching_tpu.ops import compact as jcompact
from neuralradiancecaching_tpu.ops import envmap as jenv
from neuralradiancecaching_tpu.ops import lightfield as jlf
from neuralradiancecaching_tpu.ops import phase as jphase
from neuralradiancecaching_tpu.ops import volume as jvol
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch.ops import collision as tcoll
from neuralradiancecaching_tpu_torch.ops import compact as tcompact
from neuralradiancecaching_tpu_torch.ops import envmap as tenv
from neuralradiancecaching_tpu_torch.ops import lightfield as tlf
from neuralradiancecaching_tpu_torch.ops import phase as tphase
from neuralradiancecaching_tpu_torch.ops import scan
from neuralradiancecaching_tpu_torch.ops import volume as tvol
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene

R = dataclasses.replace


def small_cfg():
    cfg = cfg_mod.nrc_online_config(32, 32)
    return R(cfg,
             path=R(cfg.path, sampler="collision", collision_field_steps=8),
             mlp=R(cfg.mlp, fused_inference=True),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)))


def t(a):
    return torch.tensor(np.array(a))


def jax_o0(fn, *args):
    """Run ``jax.jit(fn)(*args)`` compiled with XLA:CPU's LLVM backend at
    -O0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@pytest.fixture(scope="module")
def scenes():
    cfg = small_cfg()
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    js = jax_o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)
    ts = tscene.make_scene(cfg, torch.tensor(dens), torch.tensor(env))
    return cfg, js, ts


def _unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _points(rng, n, vol, margin=1.0):
    return ((rng.random((n, 3)) - 0.5) * margin
            * np.asarray(vol.box_size)).astype(np.float32)


@pytest.mark.parametrize("frame", [0, 3])
def test_camera_rays_match(frame):
    cfg = cfg_mod.CameraConfig()
    pos, vdir = jcam.orbit_position(frame, 8)
    tpos, tvdir = tcam.orbit_position(frame, 8)
    np.testing.assert_array_equal(pos, tpos)
    np.testing.assert_array_equal(vdir, tvdir)
    jc = jcam.make_camera(cfg, pos, vdir)
    tc = tcam.make_camera(cfg, "cpu", tpos, tvdir)
    np.testing.assert_array_equal(tc.inv_proj_view.numpy(),
                                  np.asarray(jc.inv_proj_view))
    ro_j, rd_j = jcam.pixel_rays(jc, 48, 32)
    ro_t, rd_t = tcam.pixel_rays(tc, 48, 32)
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    # fp32 projective divide, products summed in another order: 1e-6
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=1e-6,
                               atol=1e-6)


def test_corner_table_and_ray_box_match(scenes):
    cfg, js, ts = scenes
    np.testing.assert_array_equal(ts.density.numpy(), np.asarray(js.density))
    rng = np.random.default_rng(1)
    ro = _points(rng, 1000, cfg.volume, margin=3.0)
    rd = _unit(rng, 1000)
    for a, b in zip(jvol.entry_exit_points(jnp.asarray(ro), jnp.asarray(rd),
                                           cfg.volume.box_size,
                                           cfg.volume.box_center),
                    tvol.entry_exit_points(t(ro), t(rd), cfg.volume.box_size,
                                           cfg.volume.box_center)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-5)


def test_density_and_transmittance_match(scenes):
    cfg, js, ts = scenes
    rng = np.random.default_rng(2)
    a = _points(rng, 512, cfg.volume, margin=1.1)
    b = _points(rng, 512, cfg.volume, margin=1.1)
    dj = np.asarray(jvol.density_at(js.density, jnp.asarray(a), cfg.volume))
    dt = tvol.density_at(ts.density, t(a), cfg.volume).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=1e-7)
    tj = np.asarray(jvol.transmittance(js.density, jnp.asarray(a),
                                       jnp.asarray(b), 32, cfg.volume))
    tt = tvol.transmittance(ts.density, t(a), t(b), 32, cfg.volume).numpy()
    # exp of a 32-term fp32 sum: 1e-5 relative
    np.testing.assert_allclose(tt, tj, rtol=1e-5, atol=1e-7)


def test_env_map_and_sample_direct_match(scenes):
    _, js, ts = scenes
    np.testing.assert_array_equal(ts.env.corner.numpy(),
                                  np.asarray(js.env.corner))
    np.testing.assert_array_equal(ts.env.inv_cdf_y.numpy(),
                                  np.asarray(js.env.inv_cdf_y))
    # per-row sums in another order can move a conditional-CDF threshold
    # across a tie: at most one bin
    assert np.abs(ts.env.inv_cdf_x.numpy()
                  - np.asarray(js.env.inv_cdf_x)).max() <= 1.0 / 64 + 1e-7
    d = _unit(np.random.default_rng(3), 2048)
    for hpm in (False, True):
        ref = np.asarray(jenv.sample_direct(js.env, jnp.asarray(d), hpm))
        out = tenv.sample_direct(ts.env, t(d), hpm).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_scan_cumsum_matches_jnp_bitwise():
    rng = np.random.default_rng(4)
    for n in (1, 7, 16, 17, 48, 128, 1000):
        x = rng.random((9, n), dtype=np.float32)
        x[:, n // 2:] *= rng.random((9, n - n // 2)) < 0.3
        ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
        np.testing.assert_array_equal(scan.cumsum(t(x), dim=1).numpy(), ref)


def test_field_bakes_match(scenes):
    """The three field bakes (tau, HG scatter, collision) from the same
    corner table: tau/knots within 1e-5 relative (fp32 quadrature sums)."""
    _, js, ts = scenes
    for name in ("env_t_field", "env_s_field", "coll_field"):
        ref, out = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert out.shape == ref.shape, name
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_env_cell_integrals_match():
    env = assets.synthesize_sky(32, 64)
    pj, cj = jlf.env_cell_integrals(jnp.asarray(env), 4, 8)
    pt_, ct = tlf.env_cell_integrals(t(env), 4, 8)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), rtol=1e-6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)


def test_field_queries_match(scenes):
    """Queries read the SAME (JAX-baked) rows in both packages, so only the
    lookup arithmetic is compared: 1e-5."""
    cfg, js, _ = scenes
    vol = cfg.volume
    rng = np.random.default_rng(5)
    p = _points(rng, 4096, vol, margin=1.05)
    q = _points(rng, 4096, vol, margin=1.05)
    d = _unit(rng, 4096)
    jp, jd, jq = jnp.asarray(p), jnp.asarray(d), jnp.asarray(q)
    tf, sf, cf = (t(js.env_t_field), t(js.env_s_field), t(js.coll_field))
    pairs = [
        (jlf.query_tau_field(js.env_t_field, jp, jd, vol),
         tlf.query_tau_field(tf, t(p), t(d), vol)),
        (jlf.segment_transmittance_field(js.env_t_field, jp, jq, vol),
         tlf.segment_transmittance_field(tf, t(p), t(q), vol)),
        (jlf.query_radiance_field(js.env_s_field, jp, jd, vol),
         tlf.query_radiance_field(sf, t(p), t(d), vol)),
        *zip(jcoll.query_collision_rows(js.coll_field, jp, jd, vol),
             tcoll.query_collision_rows(cf, t(p), t(d), vol)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_knots_to_distance_matches():
    rng = np.random.default_rng(6)
    tau = (rng.random(4096) * 5).astype(np.float32)
    tau[:64] = 0.0
    knots = np.sort(rng.random((4096, 4)) * 30, axis=-1).astype(np.float32)
    u = rng.random(4096, dtype=np.float32)
    ref = np.asarray(jcoll.knots_to_distance(jnp.asarray(tau),
                                             jnp.asarray(knots),
                                             jnp.asarray(u)))
    out = tcoll.knots_to_distance(t(tau), t(knots), t(u)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_hg_direction_matches():
    rng = np.random.default_rng(7)
    d = _unit(rng, 4096)
    u1, u2 = rng.random((2, 4096), dtype=np.float32)
    ref = np.asarray(jphase.hg_direction_from_uniforms(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(d), 0.7))
    out = tphase.hg_direction_from_uniforms(t(u1), t(u2), t(d), 0.7).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)
    cos = np.clip(np.sum(d * _unit(rng, 4096), -1), -1, 1)
    np.testing.assert_allclose(
        tphase.hg_phase(t(cos), 0.7).numpy(),
        np.asarray(jphase.hg_phase(jnp.asarray(cos), 0.7)), rtol=1e-6)


def _counts(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, size=1000).astype(np.int32)
    counts[rng.random(1000) < 0.4] = 0
    return rng, counts  # sums to ~1400


@pytest.mark.parametrize("cap", [2048, 1200, 37])
def test_compact_prefix_bitwise_incl_overflow(cap):
    _, counts = _counts(cap)
    assert (counts.sum() > cap) == (cap < 2048)  # overflow where intended
    ref = jax.jit(jcompact.compact_prefix, static_argnums=1)(
        jnp.asarray(counts), cap)
    out = tcompact.compact_prefix(t(counts), cap)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("cap", [2048, 1200, 37])
def test_prefix_segment_sum_matches_up_to_add_order(cap):
    rng, counts = _counts(cap + 1)
    row, slot, valid = jax.jit(jcompact.compact_prefix, static_argnums=1)(
        jnp.asarray(counts), cap)
    contrib = rng.standard_normal((cap, 3)).astype(np.float32)
    contrib = np.where(np.asarray(valid)[:, None], contrib, 0.0)
    ref = np.asarray(jax.jit(jcompact.prefix_segment_sum)(
        jnp.asarray(contrib), jnp.asarray(counts), slot))
    out = tcompact.prefix_segment_sum(t(contrib), t(counts),
                                      t(slot)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
