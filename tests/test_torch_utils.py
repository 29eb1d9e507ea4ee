"""The port's last public functions against the JAX package: the raw-grid
trilinear sampler and the raw-grid ``density_at`` (with the transmittance
estimators and the offline tracer on either kind of field),
``collision.sample_collision``, ``lightfield.precompute_for_scene``,
``scene.lightfield_row_width``, ``parallel.default_mesh``, the host band
loop ``tiled.render_tiled``, and ``utils/`` (``log``, ``debug``,
``profiling``).

The same numpy inputs from a seed go to both packages; the JAX functions
run as the package runs them (eagerly where the package calls them
eagerly), the banded renders compiled at -O0 (tests/test_torch_render.py).

Tolerances, each with its reason:
- the port's raw-grid fetch equals its corner-table fetch bit for bit
  (the same eight corner values summed by the same reduction), and so do
  the densities, transmittances and offline traces built on them;
- the fetches against JAX within 1e-6 + 1e-5 |ref| (JAX's own bound for
  its two samplers, tests/test_volume_phase.py:127: eight corners summed
  in another order);
- ``sample_collision`` and the transmittance field within 1e-6 + 1e-5
  |ref| (fp32 logs and quadrature sums, tests/test_torch_scene.py); the
  inverse-CDF check at JAX's own bound (tests/test_collision.py:104);
- the banded frames per pixel as the banded tests hold them: >= 99.5% of
  pixels within 1e-4 + 1e-3 |ref| and the mean within 1e-4 relative (a
  one-ulp difference in a transcendental can flip a texel and change a
  pixel wholesale); ``render_tiled`` against the port's ``render_banded``
  on the cache-off path bit for bit (the same band walk).
"""

import collections
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.ops import collision as jcoll
from neuralradiancecaching_tpu.ops import lightfield as jlf
from neuralradiancecaching_tpu.ops import volume as jvol
from neuralradiancecaching_tpu.render import tiled as jtiled
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu.utils import log as jlog
from neuralradiancecaching_tpu_torch import parallel as tparallel
from neuralradiancecaching_tpu_torch.config import VolumeConfig
from neuralradiancecaching_tpu_torch.ops import collision as tcoll
from neuralradiancecaching_tpu_torch.ops import lightfield as tlf
from neuralradiancecaching_tpu_torch.ops import volume as tvol
from neuralradiancecaching_tpu_torch.parallel import mesh as tmesh
from neuralradiancecaching_tpu_torch.render import offline_pathtracer as topt
from neuralradiancecaching_tpu_torch.render import tiled as ttiled
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import debug as tdebug
from neuralradiancecaching_tpu_torch.utils import log as tlog
from neuralradiancecaching_tpu_torch.utils import profiling as tprof
from tests.test_torch_oracle import jax_path_uniforms
from tests.test_torch_tiled import (build, close_rows, frame_cfg, jax_o0,
                                    port_cfg)

R = dataclasses.replace
SIDE, BAND = 16, 8
PIXEL_FRAC_OK, REL_MEAN = 0.995, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# -- the raw-grid sampler ---------------------------------------------------

def test_sample_grid_trilinear_matches_jax_and_the_corner_table():
    """Random samples in and around the box (uvw in [-0.3, 1.3]): equal to
    the port's corner-table fetch bitwise, and to JAX's raw-grid fetch."""
    rng = np.random.default_rng(1)
    grid = rng.random((9, 7, 11)).astype(np.float32)
    uvw = rng.uniform(-0.3, 1.3, size=(4096, 3)).astype(np.float32)
    out = tvol.sample_grid_trilinear(t(grid), t(uvw))
    table = tvol.sample_corner_trilinear(tvol.build_corner_table(t(grid)),
                                         t(uvw), grid.shape)
    assert torch.equal(out, table)
    close(out, jvol.sample_grid_trilinear(jnp.asarray(grid),
                                          jnp.asarray(uvw)))
    assert float((out == 0).float().mean()) > 0.1  # outside samples: 0


@pytest.mark.parametrize("case", ["constant_interior", "outside", "face",
                                  "manual_lerp"])
def test_sample_grid_trilinear_jax_cases(case):
    """JAX's own cases (tests/test_volume_phase.py:34-59): a constant grid
    inside, a sample just outside (black), one on the face texel boundary
    (half border) and one between two known texels."""
    rng = np.random.default_rng(0)
    lerp = rng.random((5, 6, 7)).astype(np.float32)
    grid, uvw, want = {
        "constant_interior": (np.ones((8, 8, 8), np.float32),
                              [[0.5, 0.5, 0.5], [0.3, 0.6, 0.4]], 1.0),
        "outside": (np.ones((4, 4, 4), np.float32), [[-0.2, 0.5, 0.5]], 0.0),
        "face": (np.ones((4, 4, 4), np.float32), [[0.0, 0.5, 0.5]], 0.5),
        "manual_lerp": (lerp, [[0.5, 0.5, 0.5]],
                        0.5 * lerp[2, 2, 3] + 0.5 * lerp[2, 3, 3]),
    }[case]
    uvw = np.asarray(uvw, np.float32)
    out = tvol.sample_grid_trilinear(t(grid), t(uvw)).numpy()
    close(out, jvol.sample_grid_trilinear(jnp.asarray(grid),
                                          jnp.asarray(uvw)))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-7)


def test_density_at_and_transmittance_take_either_field():
    """density_at dispatches on rank as JAX does; on the raw grid it
    equals the corner table bitwise, and so do the quadrature and the
    ratio-tracked transmittance; the raw grid against JAX's."""
    rng = np.random.default_rng(2)
    vol = VolumeConfig(grid_shape=(10, 8, 12), box_size=(5.0, 4.0, 6.0),
                       density_factor=0.8)
    grid = rng.random(vol.grid_shape).astype(np.float32)
    table = tvol.build_corner_table(t(grid))
    pos = ((rng.random((2048, 3)) - 0.5) * 1.2
           * np.asarray(vol.box_size)).astype(np.float32)
    raw = tvol.density_at(t(grid), t(pos), vol)
    assert torch.equal(raw, tvol.density_at(table, t(pos), vol))
    close(raw, jvol.density_at(jnp.asarray(grid), jnp.asarray(pos), vol))
    a, b = t(pos[:256]), t(pos[256:512])
    quad = tvol.transmittance(t(grid), a, b, 32, vol)
    assert torch.equal(quad, tvol.transmittance(table, a, b, 32, vol))
    close(quad, jvol.transmittance(jnp.asarray(grid), jnp.asarray(pos[:256]),
                                   jnp.asarray(pos[256:512]), 32, vol))
    u = t(rng.random((24, 256)).astype(np.float32))
    sigma = 0.8 * float(grid.max()) + 1e-6
    assert torch.equal(tvol.transmittance_ratio(t(grid), a, b, u, sigma, vol),
                       tvol.transmittance_ratio(table, a, b, u, sigma, vol))


def test_transmittance_on_the_raw_grid_analytic():
    """JAX's analytic cases (tests/test_volume_phase.py:62-78): a uniform
    grid gives exp(-sigma * length), a zero-length segment 1."""
    vol = VolumeConfig(grid_shape=(16, 16, 16), box_size=(4.0, 4.0, 4.0),
                       density_factor=0.5)
    grid = torch.ones(vol.grid_shape)
    tr = tvol.transmittance(grid, torch.tensor([[-1.0, 0.0, 0.0]]),
                            torch.tensor([[1.0, 0.0, 0.0]]), 64, vol)
    np.testing.assert_allclose(float(tr[0]), math.exp(-1.0), rtol=1e-4)
    p = torch.zeros((1, 3))
    assert float(tvol.transmittance(grid, p, p, 8, vol)[0]) == 1.0


def test_offline_tracer_takes_the_raw_grid():
    """The offline tracer through the raw grid equals its trace through
    the corner table (its JAX parity is tests/test_torch_offline.py)."""
    from tests.test_torch_offline import (SUN, jax_offline_uniforms,
                                          port_cfg as opt_cfg, setup_scene)
    grid, vol, cfg, ro, rd = setup_scene(0.5)
    u = t(jax_offline_uniforms(jax.random.PRNGKey(3), cfg, len(ro)))
    args = (opt_cfg(vol), opt_cfg(cfg), SUN, 1.0, t(ro), t(rd), u)
    a = topt.trace(t(grid), *args)
    b = topt.trace(tvol.build_corner_table(t(grid)), *args)
    assert float(a.color.max()) > 0.0
    for name in ("color", "export_pos", "export_dir"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# -- sample_collision, the transmittance field, the row width ---------------

@pytest.fixture(scope="module")
def blob_field():
    """JAX's inverse-CDF scene (tests/test_collision.py:75-85): a smooth
    blob of density 2 in an 8^3 box, its collision field at 8^3 voxels
    baked by the port (its bake's parity is tests/test_torch_scene.py)."""
    vol = VolumeConfig(grid_shape=(16, 16, 16), box_size=(8.0, 8.0, 8.0))
    x = np.linspace(-1, 1, 16)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    grid = np.exp(-4 * (gx ** 2 + gy ** 2 + gz ** 2)).astype(np.float32) * 2
    field = tcoll.build_collision_field(tvol.build_corner_table(t(grid)),
                                        vol, steps=64, field_shape=(8, 8, 8))
    return vol, grid, field


def test_sample_collision_matches_jax(blob_field):
    vol, _, field = blob_field
    rng = np.random.default_rng(4)
    pos = ((rng.random((4096, 3)) - 0.5) * 1.1
           * np.asarray(vol.box_size)).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.random(4096).astype(np.float32)
    dist, p_sc = tcoll.sample_collision(field, t(pos), t(d), t(u), vol,
                                        field_shape=(8, 8, 8))
    jd, jp = jcoll.sample_collision(jnp.asarray(field.numpy()),
                                    jnp.asarray(pos), jnp.asarray(d),
                                    jnp.asarray(u), vol, field_shape=(8, 8, 8))
    close(dist, jd)
    close(p_sc, jp)
    tau, _ = tcoll.query_collision_rows(field, t(pos), t(d), vol, (8, 8, 8))
    assert torch.equal(p_sc, -torch.expm1(-tau))
    assert float((p_sc > 0).float().mean()) > 0.5
    # rows that see no density: (0, 0)
    dist, p_sc = tcoll.sample_collision(torch.zeros_like(field), t(pos),
                                        t(d), t(u), vol, field_shape=(8, 8, 8))
    assert not bool(dist.any()) and not bool(p_sc.any())


def test_sample_collision_inverts_the_cdf(blob_field):
    """JAX's check (tests/test_collision.py:75-119) on the port: from a
    voxel centre along a bucket-centre direction, the optical depth to the
    sampled distance (a 96-step quadrature on the raw grid) equals the
    truncated-exponential draw -log1p(-u p_scatter)."""
    vol, grid, field = blob_field
    n_theta, n_phi = vol.field_dir_buckets
    th = torch.tensor((8 + 0.5) / n_theta * math.pi)
    ph = torch.tensor(((20 + 0.5) / n_phi * 2.0 - 1.0) * math.pi)
    d = tlf._dir_from_theta_phi(th, ph).reshape(1, 3).to(torch.float32)
    vc = ((np.floor((np.array([0.07, -0.12, 0.19])
                     / np.asarray(vol.box_size) + 0.5) * 8) + 0.5) / 8
          - 0.5) * np.asarray(vol.box_size)
    pos = torch.tensor(vc, dtype=torch.float32)[None]
    tau = float(tcoll.query_collision_rows(field, pos, d, vol, (8, 8, 8))[0])
    assert tau > 0.3  # the blob is in the way
    for u in (0.05, 0.3, 0.6, 0.9, 0.99):
        dist, p_sc = tcoll.sample_collision(field, pos, d, torch.tensor([u]),
                                            vol, field_shape=(8, 8, 8))
        tau_star = -math.log1p(-u * float(p_sc[0]))
        seg = tvol.transmittance(t(grid), pos, pos + dist[:, None] * d, 96,
                                 vol)
        tau_meas = -math.log(float(seg[0]))
        assert abs(tau_meas - tau_star) < 0.12 * tau + 0.03, (u, tau_meas,
                                                              tau_star)


def test_precompute_for_scene_and_row_width_match_jax():
    cfg = R(frame_cfg(), env_map=R(frame_cfg().env_map, transmittance_steps=8))
    rng = np.random.default_rng(5)
    dens = (rng.random(cfg.volume.grid_shape) * 0.5).astype(np.float32)
    table = tvol.build_corner_table(t(dens))
    scene = collections.namedtuple("S", "density")(table)
    out = tlf.precompute_for_scene(scene, port_cfg(cfg))
    ref = jax_o0(lambda d: jlf.precompute_for_scene(
        jscene.Scene(*([d] + [None] * 9)), cfg),
        jnp.asarray(table.numpy()))
    assert out.shape == ref.shape
    close(out, ref)
    assert tscene.lightfield_row_width() == jscene.lightfield_row_width()
    assert out.shape[1] == tscene.lightfield_row_width()


def test_default_mesh_is_make_mesh_with_its_defaults(monkeypatch):
    """JAX's default_mesh is make_mesh() (parallel/mesh.py:21-22): the
    port's is its make_mesh() with no argument -- every rank the launcher
    started, on its card -- and is exported beside it."""
    assert tparallel.default_mesh is tmesh.default_mesh
    calls = []
    monkeypatch.setattr(tmesh, "make_mesh", lambda *a, **kw: calls.append(
        (a, kw)) or "mesh")
    assert tparallel.default_mesh() == "mesh"
    assert calls == [((), {})]


# -- render_tiled ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiled_scene():
    """Config 5's test cut (tests/test_torch_tiled.py:frame_cfg, f32 fields,
    the fused f32 query, no live pack) at 16x16."""
    cfg = frame_cfg(w=SIDE, h=SIDE)
    cfg = R(cfg, render=R(cfg.render, live_pack_fraction=0.0))
    return (cfg, *build(cfg))


def band_uniforms(cfg, key):
    """The JAX band loop's draws, one entry per band: band key
    fold_in(key, y0 * band_rows), what render_image (cache off) or the
    band walk (cache on) takes."""
    return [jax_path_uniforms(cfg, jax.random.fold_in(key, i * BAND),
                              BAND * SIDE, cfg.render.use_nn)
            for i in range(SIDE // BAND)]


@pytest.mark.parametrize("sampler,use_nn", [("collision", False),
                                            ("collision", True),
                                            ("reference", True)])
def test_render_tiled_matches_jax_and_render_banded(tiled_scene, sampler,
                                                    use_nn):
    """The cache off (render_image per band), the collision sampler's
    deferred shade and the reference sampler's in-band shade: JAX's
    render_tiled and the port's from the same per-band draws, and the
    port's render_banded on them (JAX's tests/test_render_nrc.py:196)."""
    cfg, js, ts, jstate, tstate = tiled_scene
    cfg = R(cfg, path=R(cfg.path, sampler=sampler),
            render=R(cfg.render, use_nn=use_nn))
    tc = port_cfg(cfg)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_o0(lambda s, sc: jtiled.render_tiled(
        s, sc, key, cfg, band_rows=BAND), jstate, js))
    u = band_uniforms(cfg, key)
    out = ttiled.render_tiled(tstate, ts, None, tc, BAND, uniforms=u)
    banded = ttiled.render_banded(tstate, ts, None, tc, BAND, uniforms=u)
    assert out.shape == ref.shape == (SIDE, SIDE, 3)
    for img, want in ((out.numpy(), ref), (banded.numpy(), out.numpy())):
        assert np.isfinite(img).all() and want.mean() > 0.0
        ok = close_rows(img.reshape(-1, 3), want.reshape(-1, 3))
        rel = abs(img.mean() - want.mean()) / abs(want.mean())
        assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(),
                                                                rel)
    if not use_nn:
        assert torch.equal(out, banded)


def test_render_tiled_checks(tiled_scene):
    cfg, _, ts, _, tstate = tiled_scene
    tc = port_cfg(cfg)
    with pytest.raises(ValueError, match="multiple of band_rows"):
        ttiled.render_tiled(tstate, ts, None, tc, band_rows=5)
    spp2 = R(tc, render=R(tc.render, spp=2))
    with pytest.raises(ValueError, match="spp"):
        ttiled.render_tiled(tstate, ts, None, spp2, band_rows=BAND)
    img = ttiled.render_tiled(tstate, ts, torch.Generator().manual_seed(0),
                              tc, band_rows=BAND)
    assert img.shape == (SIDE, SIDE, 3) and bool(torch.isfinite(img).all())


# -- utils -----------------------------------------------------------------

def test_log_is_the_jax_packages(capsys):
    tlog.Log.info("hello")
    tlog.Log.warn("careful")
    out = capsys.readouterr()
    assert "INFO  hello" in out.out and "WARN  careful" in out.err
    for log in (tlog.Log, jlog.Log):
        with pytest.raises(RuntimeError, match="boom"):
            log.error("boom")


def test_assert_all_finite_names_the_path():
    Pair = collections.namedtuple("Pair", "a b")
    good = {"w": [torch.ones(2), Pair(torch.zeros(1), torch.arange(3))],
            "n": None}
    tdebug.assert_all_finite(good, "state")
    bad = {"w": [torch.ones(2), Pair(torch.zeros(1),
                                     torch.tensor([1.0, math.inf]))]}
    with pytest.raises(AssertionError, match=r"state\['w'\]\[1\]\.b"):
        tdebug.assert_all_finite(bad, "state")
    st = tscene.DirLight(torch.ones(3), torch.tensor([math.nan]),
                         torch.ones(()))
    with pytest.raises(AssertionError, match=r"light\.color"):
        tdebug.assert_all_finite(st, "light")


def test_nan_check_raises_inside_the_context_only():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match="div"):
        with tdebug.nan_check():
            _ = x * 2.0
            _ = x / 0.0
    assert bool(torch.isnan(x / 0.0).any())  # outside: no raise
    with tdebug.nan_check():  # inf, allocations and autograd pass
        _ = torch.tensor([1.0]) / 0.0
        torch.empty(64).fill_(1.0)
        w = torch.randn(4, requires_grad=True)
        (w * w).sum().backward()
    with pytest.raises(FloatingPointError):  # NaN only in the backward
        with tdebug.nan_check():
            w = torch.zeros(2, requires_grad=True)
            torch.where(w > 0, torch.sqrt(w), 0.0).sum().backward()


def test_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / "tr" / files[0]) > 0
    assert any("mm" in e.key for e in prof.key_averages())
