"""The port's unbiased ground-truth oracle against the JAX package: the
metrics of the quality protocol, ratio-tracking transmittance, the local
majorant grid, env importance sampling, the exit-transmittance field, the
shade's 'quadrature'/'ratio' light transmittance and 'mc' env in-scatter,
the delta sampler's walk (global and local majorant, march split on and
off, cache on and off) and the oracle's whole render (delta + ratio + MC,
the bench's ground-truth configuration, bench.py:755-772).

Every stochastic piece takes its uniforms from the caller; the helpers
below rebuild the JAX package's own draws from its keys, so both packages
compute the same deterministic function. The jitted JAX references are
compiled with XLA:CPU's LLVM backend at -O0 (see tests/test_torch_render.py).

Tolerances, each with its reason:
- the metrics to 1e-12 relative (float64 numpy on both sides, the same
  code);
- ``majorant_grid`` and the importance sample's CDF lookups bit for bit
  (max pooling and integer truncation);
- ``transmittance_ratio``, the exit-transmittance field and the importance
  sample's direction and radiance 1e-5 + 1e-5 |ref| (fp32 logs, sines
  and products in another order);
- the shade and the walks per lane, as the render test holds pixels: a
  one-ulp difference in a transcendental can flip a bucket, an acceptance
  test or a texel and change that lane wholesale, so >= 99% of lanes
  (99.5% of pixels for the render) within 1e-4 + 1e-3 |ref| and the mean
  within 1e-4 relative (the delta walk's binary see-through: >= 99% of
  lanes equal);
- the statistical case: the port's own generator against JAX's own keys,
  the oracle's mean radiance within 3 sigma of the two means' difference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.ops import envmap as jenv
from neuralradiancecaching_tpu.ops import lightfield as jlf
from neuralradiancecaching_tpu.ops import volume as jvol
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.render import pathtrace as jpt
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu.utils import metrics as jmetrics
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import envmap as tenv
from neuralradiancecaching_tpu_torch.ops import lightfield as tlf
from neuralradiancecaching_tpu_torch.ops import volume as tvol
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import metrics as tmetrics

R = dataclasses.replace
LANE_FRAC_OK, PIXEL_FRAC_OK, REL_MEAN = 0.99, 0.995, 1e-4
SIDE = 16          # the oracle render's image side
WALK_SIDE = 48     # 2304 walk lanes: above the 1024-lane floor of the caps


def port_cfg(obj):
    """The port's config equal field for field to a JAX config object."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tcfg_mod, type(obj).__name__)
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def o0(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` by XLA:CPU's LLVM backend at
    -O0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def jax_o0(fn, *args):
    return o0(fn, *args)(*args)


def base_cfg(side=SIDE):
    """Config 5 as the bench derives its quality legs from it (square view,
    cache off), cut to test size: coarse grid and fields, 8 bounces."""
    cfg = jcfg_mod.progressive_1080p_config()
    return R(cfg,
             camera=R(cfg.camera, aspect=1.0),
             render=R(cfg.render, width=side, height=side, use_nn=False),
             path=R(cfg.path, collision_field_steps=8, max_bounces=8),
             volume=R(cfg.volume, field_dtype="float32",
                      grid_shape=(16, 12, 20), field_shape=(6, 5, 8),
                      field_dir_buckets=(8, 16)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)))


def oracle_cfg(side=SIDE):
    """The bench's unbiased oracle (bench.py:765-771) on the test cut."""
    cfg = base_cfg(side)
    return R(cfg,
             path=R(cfg.path, sampler="delta", transmittance_mode="ratio"),
             env_map=R(cfg.env_map, in_scatter_mode="mc",
                       transmittance_mode="ratio"))


def with_lights(cfg):
    return R(cfg,
             dir_light=R(cfg.dir_light, enabled=True, strength=2.0,
                         zenith=-1.0, azimuth=0.5),
             point_light=R(cfg.point_light, enabled=True, strength=3.0,
                           position=(5.0, 3.0, -2.0), color=(1.0, 0.5, 0.25)))


def to_t(x):
    return torch.tensor(np.asarray(x))


def jax_scene_uniforms(cfg, key, n, env_samples):
    """The draws of one JAX trace_scene(key) call over n rows
    (pathtrace.py:49-148, ops/phase.py:80, ops/envmap.py:179-181,
    ops/volume.py:240) as the port's SceneUniforms."""
    shapes = tpt.scene_uniform_shapes(port_cfg(cfg), n, env_samples)
    if shapes is None:
        return None
    steps = cfg.path.ratio_tracking_steps

    def u(k, shape):
        return np.asarray(jax.random.uniform(k, shape))

    def pairs(first, count):
        return to_t(np.stack([np.stack([u(k, (n,)) for k in jax.random.split(
            jax.random.fold_in(key, first + s))]) for s in range(count)]))

    return tpt.SceneUniforms(
        dir_ratio=(to_t(u(jax.random.fold_in(key, 9101), (steps, n)))
                   if shapes.dir_ratio else None),
        point_ratio=(to_t(u(jax.random.fold_in(key, 9102), (steps, n)))
                     if shapes.point_ratio else None),
        env_hg=pairs(0, shapes.env_hg[0]) if shapes.env_hg else None,
        env_cdf=(pairs(shapes.env_hg[0] if shapes.env_hg else 0,
                       shapes.env_cdf[0]) if shapes.env_cdf else None),
        env_ratio=(to_t(np.stack([u(jax.random.fold_in(
            jax.random.fold_in(key, s), 9201), (steps, n))
            for s in range(env_samples)])) if shapes.env_ratio else None))


def jax_path_uniforms(cfg, key, n, use_nn, env_samples=None,
                      max_bounces=None):
    """The draws of one JAX trace_path(key) walk as PathUniforms: the march
    phases fold_in(key, 0/1/2) and the shade calls -- collision and delta:
    k_scene = fold_in(key, k_steps + 1), then fold_in(k_scene, 1/2)
    (pathtrace.py:478-596), or per slot fold_in(k_scene, slot) with
    coll_shade_cap <= 0 (:597-611); reference: fold_in(key, max_bounces +
    1), compacted once or per slot fold_in(k_scene, slot) (:831-885)."""
    tcfg = port_cfg(cfg)
    env = cfg.env_map.n_samples if env_samples is None else env_samples
    walk_shapes, rows = tpt.path_uniform_shapes(tcfg, n, use_nn, env,
                                                max_bounces)
    walk = [to_t(jax.random.uniform(jax.random.fold_in(key, i), sh))
            for i, sh in enumerate(walk_shapes)]
    steps = sum(sh[0] for sh in walk_shapes)
    k_scene = jax.random.fold_in(key, steps + 1)
    if (cfg.path.sampler == "reference" and not (
            use_nn and cfg.path.compact_events > 0)) or (
            cfg.path.sampler != "reference"
            and cfg.path.coll_shade_cap <= 0.0):
        # the dense shade: one call per slot, fold_in(k_scene, slot)
        keys = [jax.random.fold_in(k_scene, k) for k in range(len(rows))]
    else:
        keys = [k_scene] + [jax.random.fold_in(k_scene, i)
                            for i in range(1, len(rows))]
    return tpt.PathUniforms(walk, [jax_scene_uniforms(cfg, k, r, env)
                                   for k, r in zip(keys, rows)])


def lanes_close(out, ref):
    """Per lane: within 1e-4 + 1e-3 |ref|, or NaN on both sides (the
    ``raw_envmap_dir`` quirk's unnormalized directions push the HG phase's
    base below 0 in both packages); the relative difference of the means
    over the finite lanes."""
    out = np.asarray(out).reshape(ref.shape[0], -1)
    ref = np.asarray(ref).reshape(ref.shape[0], -1)
    both_nan = np.isnan(out) & np.isnan(ref)
    ok = np.all((np.abs(out - ref) <= 1e-4 + 1e-3 * np.abs(ref)) | both_nan,
                axis=-1)
    fin = np.all(np.isfinite(ref), axis=-1)
    return ok, (abs(out[fin].mean() - ref[fin].mean())
                / max(abs(ref[fin].mean()), 1e-12))


@pytest.fixture(scope="module")
def setup():
    """One scene of both packages with every field baked (the field modes'
    config); the ratio and MC modes read only its corner table and env."""
    cfg = base_cfg()
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = jassets.synthesize_sky(32, 64)
    js = jax_o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)
    ts = tscene.make_scene(port_cfg(cfg), dens, env, device="cpu")
    # the conditional env CDF's row sums run in another fp32 order than
    # XLA's reduction, which moves thresholds that sit on ties by one bin
    # (tests/test_torch_scene.py bounds it): the CDF draws are compared on
    # the JAX package's own tables
    assert np.abs(ts.env.inv_cdf_x.numpy()
                  - np.asarray(js.env.inv_cdf_x)).max() <= 1.0 / 64 + 1e-7
    ts = dataclasses.replace(ts, env=dataclasses.replace(
        ts.env, inv_cdf_x=to_t(js.env.inv_cdf_x)))
    return cfg, js, ts


def inner_points(cfg, n, seed):
    rng = np.random.default_rng(seed)
    pos = ((rng.random((n, 3)) - 0.5) * 0.9
           * np.asarray(cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d


# -- 1. the metrics of the quality protocol ---------------------------------

def test_metrics_equal_the_jax_packages():
    rng = np.random.default_rng(3)
    imgs = [rng.random((24, 20, 3)) * 2.0 for _ in range(4)]
    for name in ("rmse", "relative_rmse", "psnr"):
        np.testing.assert_allclose(getattr(tmetrics, name)(*imgs[:2]),
                                   getattr(jmetrics, name)(*imgs[:2]),
                                   rtol=1e-12)
    for name in ("noise_subtracted_bias", "noise_subtracted_bias_err"):
        np.testing.assert_allclose(getattr(tmetrics, name)(*imgs),
                                   getattr(jmetrics, name)(*imgs),
                                   rtol=1e-12)
    log = tmetrics.MetricsLogger()
    row = log.log(3, mse=np.float32(0.5), tag="x")
    assert row["step"] == 3 and row["mse"] == 0.5 and row["tag"] == "x"


def test_noise_subtracted_bias_recovers_known_bias():
    """tests/test_workloads.py:172 on the port's copy: a planted 2% bias
    through much larger noise, ~0 when there is none."""
    rng = np.random.default_rng(0)
    shape = (128, 128, 3)
    truth = 2.0 + rng.random(shape)
    bias_field = 0.02 * truth
    sigma = 0.5

    def noisy(base):
        return base + rng.normal(0, sigma, shape)

    bias, floor = tmetrics.noise_subtracted_bias(
        noisy(truth + bias_field), noisy(truth + bias_field), noisy(truth),
        noisy(truth))
    true_bias = np.sqrt(np.mean(bias_field ** 2)) / np.sqrt(np.mean(truth**2))
    assert abs(bias - true_bias) < 0.4 * true_bias, (bias, true_bias)
    assert floor > 5 * true_bias
    b0, _ = tmetrics.noise_subtracted_bias(noisy(truth), noisy(truth),
                                           noisy(truth), noisy(truth))
    assert b0 < 0.5 * true_bias, b0


def test_noise_subtracted_bias_err_interval_covers_truth():
    """tests/test_workloads.py:198 on the port's copy: the +-2 sigma
    interval covers the planted bias in >= 10 of 12 runs."""
    rng = np.random.default_rng(1)
    shape = (96, 96, 3)
    truth = 2.0 + rng.random(shape)
    bias_field = 0.02 * truth
    true_bias = np.sqrt(np.mean(bias_field ** 2)) / np.sqrt(np.mean(truth**2))

    def run(seed):
        r = np.random.default_rng(seed)

        def noisy(base):
            return base + r.normal(0, 0.25, shape)

        return tmetrics.noise_subtracted_bias_err(
            noisy(truth + bias_field), noisy(truth + bias_field),
            noisy(truth), noisy(truth))

    results = [run(s) for s in range(12)]
    assert sum(lo <= true_bias <= hi for _, _, lo, hi in results) >= 10
    for b, _, lo, hi in results:
        assert lo <= b <= hi


# -- 2-5. the volume, env and field primitives -------------------------------

def test_transmittance_ratio_matches_jax(setup):
    cfg, js, ts = setup
    vol = cfg.volume
    a, _ = inner_points(cfg, 2048, 1)
    b, _ = inner_points(cfg, 2048, 2)
    b[:64] = a[:64]  # zero-length segments
    key = jax.random.PRNGKey(6)
    steps = 48
    sig = float(vol.density_factor * js.density_grid.max() + 1e-8)
    ref = np.asarray(jax_o0(lambda t, x, y: jvol.transmittance_ratio(
        t, x, y, key, steps, jnp.float32(sig), vol), js.density, a, b))
    u = jax.random.uniform(key, (steps, 2048))
    out = tvol.transmittance_ratio(ts.density, torch.tensor(a),
                                   torch.tensor(b), to_t(u), sig,
                                   port_cfg(vol)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert (out[:64] == 1.0).all() and (ref[:64] == 1.0).all()
    assert 0.05 < out[64:].mean() < 0.95  # the segments cross density
    # an empty batch and a bare zero-length segment
    empty = tvol.transmittance_ratio(ts.density, torch.zeros((0, 3)),
                                     torch.zeros((0, 3)),
                                     torch.rand((steps, 0)), sig,
                                     port_cfg(vol))
    assert empty.shape == (0,)
    one = tvol.transmittance_ratio(ts.density, torch.ones((3,)),
                                   torch.ones((3,)), torch.rand((steps,)),
                                   sig, port_cfg(vol))
    assert float(one) == 1.0


def test_majorant_grid_bitwise_and_bounds_the_density():
    """Bit for bit against JAX, and tests/test_collision.py:506's contract:
    maj[cell(q)] bounds the trilinear density within one cell edge of q."""
    rng = np.random.default_rng(11)
    grid = (rng.random((25, 17, 31)) * 2.0).astype(np.float32)
    vol = jcfg_mod.VolumeConfig(grid_shape=(25, 17, 31),
                                box_size=(12.5, 8.5, 15.5),
                                density_factor=1.0)
    cells = (5, 4, 6)
    ref = np.asarray(jvol.majorant_grid(jnp.asarray(grid), cells))
    maj = tvol.majorant_grid(torch.tensor(grid), cells).numpy()
    np.testing.assert_array_equal(maj, ref)
    vox = [b / g for b, g in zip(vol.box_size, vol.grid_shape)]
    fpc = [-(-g // c) for g, c in zip(vol.grid_shape, cells)]
    cell_sz = np.asarray([v * f for v, f in zip(vox, fpc)], np.float32)
    half = np.asarray(vol.box_size, np.float32) / 2
    q = ((rng.random((4096, 3)) - 0.5) * np.asarray(vol.box_size)).astype(
        np.float32)
    off = ((rng.random((4096, 3)) * 2.0 - 1.0) * cell_sz.min()).astype(
        np.float32)
    p = np.clip(q + off, -half, half)
    table = tvol.build_corner_table(torch.tensor(grid))
    dens = tvol.density_at(table, torch.tensor(p), port_cfg(vol)).numpy()
    idx = np.clip(((q + half) / cell_sz).astype(np.int32), 0,
                  np.asarray(cells) - 1)
    assert (dens <= maj[idx[:, 0], idx[:, 1], idx[:, 2]] + 1e-5).all()


@pytest.mark.parametrize("raw_dir", [False, True])
def test_importance_sample_matches_jax(setup, raw_dir):
    _, js, ts = setup
    quirks = jcfg_mod.QuirkFlags(raw_envmap_dir=raw_dir)
    key = jax.random.PRNGKey(9)
    n = 4096
    ref_d, ref_r = jax_o0(lambda e: jenv.importance_sample(e, key, (n,),
                                                           quirks), js.env)
    k1, k2 = jax.random.split(key)  # the draw of ops/envmap.py:179-181
    u1, u2 = (np.asarray(jax.random.uniform(k, (n,))) for k in (k1, k2))
    out_d, out_r = tenv.importance_sample(ts.env, torch.tensor(u1),
                                          torch.tensor(u2), port_cfg(quirks))
    # the CDF lookups, bit for bit: the same tables (see setup), the same
    # truncations
    inv_y, inv_x = np.asarray(js.env.inv_cdf_y), np.asarray(js.env.inv_cdf_x)
    np.testing.assert_array_equal(ts.env.inv_cdf_y.numpy(), inv_y)
    h, w = inv_x.shape
    theta = inv_y[np.clip((u1 * h).astype(np.int32), 0, h - 1)]
    phi = inv_x[np.clip((theta * h).astype(np.int32), 0, h - 1),
                np.clip((u2 * w).astype(np.int32), 0, w - 1)]
    t_theta = ts.env.inv_cdf_y[torch.clamp(
        (torch.tensor(u1) * h).to(torch.int64), 0, h - 1)]
    np.testing.assert_array_equal(t_theta.numpy(), theta)
    uv = tenv.dir_to_equirect_uv(out_d).numpy()
    if not raw_dir:  # the direction's own equirect uv is (phi, theta)
        np.testing.assert_allclose(uv[:, 1], theta, atol=1e-4)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(ref_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tenv.bilinear_lookup(ts.env, torch.tensor(np.stack([phi, theta], -1)))
        .numpy(), np.asarray(ref_r), rtol=1e-5, atol=1e-5)


def test_query_transmittance_field_matches_jax(setup):
    cfg, js, ts = setup
    pos, d = inner_points(cfg, 4096, 4)
    ref = np.asarray(jax_o0(lambda f, p, dd: jlf.query_transmittance_field(
        f, p, dd, cfg.volume), js.env_t_field, pos, d))
    out = tlf.query_transmittance_field(ts.env_t_field, torch.tensor(pos),
                                        torch.tensor(d),
                                        port_cfg(cfg.volume)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert 0.0 < out.min() and out.max() <= 1.0


# -- 6. the shade's light estimators -----------------------------------------

SHADE_MODES = {
    "lights_quadrature": dict(path="quadrature", lights=True, env="field"),
    "lights_ratio": dict(path="ratio", lights=True, env="field"),
    "mc_field": dict(path="field", lights=False, env="mc", exit="field"),
    "mc_quadrature_cdf": dict(path="field", lights=False, env="mc",
                              exit="quadrature", cdf=0.5),
    "mc_ratio_cdf_raw": dict(path="ratio", lights=True, env="mc",
                             exit="ratio", cdf=0.5, raw=True),
}


def shade_cfg(mode):
    m = SHADE_MODES[mode]
    cfg = base_cfg()
    cfg = R(cfg, path=R(cfg.path, transmittance_mode=m["path"],
                        ratio_tracking_steps=48),
            env_map=R(cfg.env_map, in_scatter_mode=m["env"],
                      transmittance_mode=m.get("exit", "field"),
                      cdf_fraction=m.get("cdf", 0.0)),
            quirks=R(cfg.quirks, raw_envmap_dir=m.get("raw", False)))
    return with_lights(cfg) if m["lights"] else cfg


@pytest.mark.parametrize("mode", sorted(SHADE_MODES))
def test_trace_scene_estimators_match_jax(setup, mode):
    """trace_scene per event, given the JAX shade key's own draws."""
    _, js, ts = setup
    cfg = shade_cfg(mode)
    tcfg = port_cfg(cfg)
    js = js._replace(dir_light=jscene.make_dir_light(cfg.dir_light),
                     point_light=jscene.make_point_light(cfg.point_light))
    ts = dataclasses.replace(
        ts, dir_light=tscene.make_dir_light(tcfg.dir_light, "cpu"),
        point_light=tscene.make_point_light(tcfg.point_light, "cpu"))
    n, n_env = 1024, cfg.env_map.n_samples
    pos, d = inner_points(cfg, n, 5)
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jax_o0(lambda sc, p, dd: jpt.trace_scene(
        sc, cfg, p, dd, key, n_env), js, pos, d))
    u = jax_scene_uniforms(cfg, key, n, n_env)
    assert (u is None) == (mode == "lights_quadrature")
    out = tpt.trace_scene(ts, tcfg, torch.tensor(pos), torch.tensor(d),
                          n_env, u).numpy()
    ok, rel = lanes_close(out, ref)
    assert ok.mean() >= LANE_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)
    assert np.nanmean(ref) > 0.0
    if u is not None:
        with pytest.raises(ValueError, match="SceneUniforms"):
            tpt.trace_scene(ts, tcfg, torch.tensor(pos), torch.tensor(d),
                            n_env)


def test_trace_scene_chunks_change_nothing(setup, monkeypatch):
    """The ratio and quadrature estimators run in row chunks: a chunk of
    1,024 rows of 48 candidates gives the unchunked values bit for bit."""
    _, _, ts = setup
    cfg = port_cfg(shade_cfg("mc_ratio_cdf_raw"))
    ts = dataclasses.replace(
        ts, dir_light=tscene.make_dir_light(cfg.dir_light, "cpu"),
        point_light=tscene.make_point_light(cfg.point_light, "cpu"))
    n = 2500
    pos, d = (torch.tensor(x) for x in inner_points(cfg, n, 6))
    u = tpt.draw_scene_uniforms(cfg, n, cfg.env_map.n_samples,
                                torch.Generator().manual_seed(0))
    whole = tpt.trace_scene(ts, cfg, pos, d, cfg.env_map.n_samples, u)
    monkeypatch.setattr(tpt, "SHADE_CHUNK_SAMPLES", 1024 * 48)
    chunked = tpt.trace_scene(ts, cfg, pos, d, cfg.env_map.n_samples, u)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0,
                               equal_nan=True)


# -- 7. the delta walk ---------------------------------------------------------

DELTA_CASES = {
    "global_nonn": dict(majorant="global", use_nn=False, p1=0),
    "global_nonn_split": dict(majorant="global", use_nn=False, p1=3),
    "local_nonn_split_oracle": dict(majorant="local", use_nn=False, p1=3,
                                    oracle=True),
    "local_nn": dict(majorant="local", use_nn=True, p1=3),
    "global_nn_quirk": dict(majorant="global", use_nn=True, p1=0,
                            quirk=True),
}


def delta_cfg(case):
    c = DELTA_CASES[case]
    cfg = oracle_cfg(WALK_SIDE) if c.get("oracle") else base_cfg(WALK_SIDE)
    return R(cfg,
             path=R(cfg.path, sampler="delta", delta_majorant=c["majorant"],
                    delta_null_steps=16, delta_phase1_steps=c["p1"],
                    delta_live_fraction=0.25, ratio_tracking_steps=48),
             env_map=R(cfg.env_map, n_samples=4),
             quirks=R(cfg.quirks, query_dir_phase=c.get("quirk", False)))


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_delta_walk_matches_jax(setup, case):
    """trace_path_collision with sampler='delta' per lane from the JAX
    walk's own draws (tests/test_collision.py:369-680): the shade sum, the
    binary T0 and the RR cut."""
    _, js, ts = setup
    cfg = delta_cfg(case)
    tcfg = port_cfg(cfg)
    use_nn = DELTA_CASES[case]["use_nn"]
    jro, jrd = jcam.pixel_rays(js.camera, WALK_SIDE, WALK_SIDE)
    tro, trd = tcam.pixel_rays(ts.camera, WALK_SIDE, WALK_SIDE)
    n = WALK_SIDE * WALK_SIDE
    shapes = tpt.walk_uniform_shapes(tcfg, n, use_nn)
    assert all(sh[1] == 4 + 2 * 16 for sh in shapes)
    if DELTA_CASES[case]["p1"] and not use_nn:
        assert shapes == [(3, 36, n), (5, 36, 1024)]  # the split shrinks
    key = jax.random.PRNGKey(21)
    ref = jax_o0(lambda sc, o, d: jpt.trace_path_collision(
        sc, cfg, o, d, key, use_nn=use_nn), js, jro, jrd)
    out = tpt.trace_path_collision(
        ts, tcfg, tro, trd, None, use_nn=use_nn,
        uniforms=jax_path_uniforms(cfg, key, n, use_nn))
    ok = np.ones(n, bool)
    for a, b in zip(ref, out):
        lane_ok, _ = lanes_close(b.numpy(), np.asarray(a))
        ok &= lane_ok
    assert ok.mean() >= LANE_FRAC_OK, ok.mean()
    tr = out.transmittance.numpy()
    assert np.isin(tr, [0.0, 1.0]).all()  # binary escape
    assert (tr == np.asarray(ref.transmittance)).mean() >= LANE_FRAC_OK
    _, rel = lanes_close(out.scattered.numpy(), np.asarray(ref.scattered))
    if use_nn:
        assert float((out.query_weight > 0).float().mean()) > 0.05
    else:
        assert rel <= REL_MEAN and float(out.scattered.mean()) > 0.0


def test_delta_local_majorant_coverage_raises(setup):
    """Too few midpoint samples to cover the box diagonal at one coarse
    cell edge is refused at trace time (tests/test_collision.py:600)."""
    _, _, ts = setup
    cfg = port_cfg(delta_cfg("local_nn"))
    cfg = R(cfg, path=R(cfg.path, delta_majorant_samples=2))
    ro, rd = tcam.pixel_rays(ts.camera, 4, 4)
    with pytest.raises(ValueError, match="cover the box diagonal"):
        tpt.trace_path_collision(ts, cfg, ro, rd, torch.Generator(),
                                 use_nn=False)


# -- the oracle's whole render ------------------------------------------------

@pytest.fixture(scope="module")
def oracle(setup):
    """The oracle's render_only_step of both packages at 16x16: the JAX
    program compiled once for every key."""
    _, js, ts = setup
    cfg = oracle_cfg()
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    step = o0(lambda s, sc, k: jframe.render_only_step(s, sc, k, cfg),
              jstate, js, jax.random.PRNGKey(0))
    return cfg, js, ts, jstate, tstate, step


def test_oracle_render_matches_jax(oracle):
    """The bench's ground truth (delta + ratio + MC) pixel for pixel, from
    the JAX render's own draws; the cache is off, so the port neither bakes
    nor queries it."""
    cfg, js, ts, jstate, tstate, step = oracle
    key = jax.random.PRNGKey(30)
    ref = np.asarray(step(jstate, js, key))
    u = jax_path_uniforms(cfg, key, SIDE * SIDE, use_nn=False)
    assert len(u.shade) == 1 and u.shade[0].env_ratio is not None
    out = tframe.render_only_step(tstate, ts, None, port_cfg(cfg),
                                  uniforms=u).numpy()
    assert out.shape == ref.shape == (SIDE, SIDE, 3)
    ok, rel = lanes_close(out.reshape(-1, 3), ref.reshape(-1, 3))
    assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)
    assert ref.mean() > 0.0


def test_oracle_mean_agrees_with_jax_statistically(oracle):
    """The port's own generator against JAX's own keys: the mean radiance
    of 12 oracle frames each agrees within 3 sigma of the difference of
    the two means (sigma from each side's frame-to-frame spread)."""
    cfg, js, ts, jstate, tstate, step = oracle
    tcfg = port_cfg(cfg)
    g = torch.Generator().manual_seed(7)
    frames = 12
    jm = [float(np.asarray(step(jstate, js, jax.random.PRNGKey(500 + i)))
                .mean()) for i in range(frames)]
    tm = [float(tframe.render_only_step(tstate, ts, g, tcfg).mean())
          for _ in range(frames)]
    sigma = np.sqrt(np.var(jm, ddof=1) / frames
                    + np.var(tm, ddof=1) / frames)
    assert sigma > 0.0
    assert abs(np.mean(jm) - np.mean(tm)) <= 3.0 * sigma, (jm, tm)
