"""The port's whole serving slice against the JAX package: the 32x32
collision render with the cache query (``render_only_step``), from the same
numpy density and env map, the same converted cache state, and the JAX
walk's own uniforms -- so the two renders are the same deterministic
function and are compared pixel by pixel.

The JAX scene and the jitted ``render_only_step`` are compiled with
XLA:CPU's LLVM backend at -O0 (see tests/test_torch_scene.py): at the
default level the backend's inconsistent multiply-add contraction makes a
floor() and its fraction disagree in fused expressions, and ~2% of the
32x32 image's cache lookups (query points clamped onto the box faces sit
exactly on grid planes) land one hash cell off -- a difference of XLA:CPU
from the op-by-op JAX result, not of the port.

Tolerance: >= 99.5% of pixels within 1e-4 + 1e-3 * |ref| (a one-ulp
difference in a transcendental can flip a voxel or direction bucket; all
pixels pass as measured) and mean radiance within 1e-4 relative (measured
~5e-7).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as cfg_mod
from neuralradiancecaching_tpu.io import assets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.render import pathtrace as jpt
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene

R = dataclasses.replace
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32


def jax_o0(fn, *args):
    """Run ``jax.jit(fn)(*args)`` compiled with XLA:CPU's LLVM backend at
    -O0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def slice_cfg():
    """Config 4 + the collision sampler + the fused query MLP (the slice),
    cut to test size."""
    cfg = cfg_mod.nrc_online_config(W, H)
    return R(cfg,
             path=R(cfg.path, sampler="collision", collision_field_steps=8),
             mlp=R(cfg.mlp, fused_inference=True),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)))


@pytest.fixture(scope="module")
def setup():
    cfg = slice_cfg()
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    js = jax_o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)
    ts = tscene.make_scene(cfg, torch.tensor(dens), torch.tensor(env))
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    # rescale the MLP so the cache term is visible in the image (the 0.01
    # init makes it ~1e-8): same numpy weights into both packages
    p_rng = np.random.default_rng(1)
    params = {k: (p_rng.standard_normal(v.shape) * (0.25 if k[0] == "w"
                                                    else 0.05))
              .astype(np.float32) for k, v in jstate.mlp_params.items()}
    jstate = jstate._replace(
        mlp_params={k: jnp.asarray(v) for k, v in params.items()})
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    return cfg, js, ts, jstate, tstate


def _uniforms(key, cfg, n):
    k_steps = min(cfg.path.coll_max_events, cfg.path.max_bounces)
    # the draw of trace_path_collision (render/pathtrace.py:480-481)
    return np.asarray(jax.random.uniform(jax.random.fold_in(key, 0),
                                         (k_steps, 4, n), dtype=jnp.float32))


def _close_enough(out, ref):
    ok = np.all(np.abs(out - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    rel_mean = abs(out.mean() - ref.mean()) / abs(ref.mean())
    return ok.mean(), rel_mean


@pytest.mark.parametrize("frame", [0, 2])
def test_render_only_step_matches_jax(setup, frame):
    cfg, js, ts, jstate, tstate = setup
    pos, vdir = jcam.orbit_position(frame, 8, radius=48.0)
    js = js._replace(camera=jcam.make_camera(cfg.camera, pos, vdir))
    ts = dataclasses.replace(ts, camera=tcam.make_camera(cfg.camera, "cpu",
                                                         pos, vdir))
    key = jax.random.PRNGKey(10 + frame)
    ref = np.asarray(jax_o0(
        lambda s, sc, k: jframe.render_only_step(s, sc, k, cfg), jstate, js,
        key))
    u = torch.tensor(_uniforms(key, cfg, W * H))
    out = tframe.render_only_step(tstate, ts, None, cfg, uniforms=u).numpy()
    assert out.shape == ref.shape == (H, W, 3)
    assert np.isfinite(out).all()
    frac_ok, rel_mean = _close_enough(out, ref)
    assert frac_ok >= 0.995, frac_ok
    assert rel_mean <= 1e-4, rel_mean


def test_trace_path_outputs_match_jax(setup):
    """The walk's per-ray outputs (shade sum, T0, RR-cut query and weight)
    from the same uniforms; a ray whose bucket flips diverges wholesale, so
    the check is per ray like the image's."""
    cfg, js, ts, _, _ = setup
    jro, jrd = jcam.pixel_rays(js.camera, W, H)
    tro, trd = tcam.pixel_rays(ts.camera, W, H)
    key = jax.random.PRNGKey(3)
    ref = jax_o0(lambda sc, o, d, k: jpt.trace_path(sc, cfg, o, d, k,
                                                     use_nn=True),
                 js, jro, jrd, key)
    out = tpt.trace_path(ts, cfg, tro, trd, None, use_nn=True,
                         uniforms=torch.tensor(_uniforms(key, cfg, W * H)))
    ok = np.ones(W * H, bool)
    for a, b in zip(ref, out):
        a, b = np.asarray(a).reshape(W * H, -1), b.numpy().reshape(W * H, -1)
        ok &= np.all(np.abs(b - a) <= 1e-4 + 1e-3 * np.abs(a), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert float(out.query_weight.gt(0).float().mean()) > 0.05  # cuts happen


@pytest.mark.parametrize("lights", ["dir", "point", "both"])
def test_trace_scene_with_lights_matches_jax(setup, lights):
    """The shade's light branches (off in the slice's config), with field
    transmittance: per event within the image tolerance."""
    cfg, js, ts, _, _ = setup
    cfg = R(cfg,
            dir_light=R(cfg.dir_light, enabled=lights != "point",
                        strength=2.0, zenith=-1.0, azimuth=0.5),
            point_light=R(cfg.point_light, enabled=lights != "dir",
                          strength=3.0, position=(5.0, 3.0, -2.0),
                          color=(1.0, 0.5, 0.25)))
    js = js._replace(dir_light=jscene.make_dir_light(cfg.dir_light),
                     point_light=jscene.make_point_light(cfg.point_light))
    ts = dataclasses.replace(
        ts, dir_light=tscene.make_dir_light(cfg.dir_light, "cpu"),
        point_light=tscene.make_point_light(cfg.point_light, "cpu"))
    rng = np.random.default_rng(5)
    pos = ((rng.random((2048, 3)) - 0.5)
           * np.asarray(cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n_env = cfg.env_map.n_samples
    ref = np.asarray(jax_o0(lambda sc, p, dd: jpt.trace_scene(
        sc, cfg, p, dd, jax.random.PRNGKey(0), n_env), js, pos, d))
    out = tpt.trace_scene(ts, cfg, torch.tensor(pos), torch.tensor(d),
                          n_env).numpy()
    ok = np.all(np.abs(out - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    assert ok.mean() >= 0.995, ok.mean()


def test_render_on_cpu_takes_plain_mlp_and_no_launch(setup):
    cfg, _, ts, _, tstate = setup
    before = fused_mlp.LAUNCHES
    g = torch.Generator().manual_seed(0)
    img = tframe.render_only_step(tstate, ts, g, cfg)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert fused_mlp.LAUNCHES == before


@pytest.mark.parametrize("change", [
    {"path": {"sampler": "reference"}},
    {"path": {"sampler": "delta"}},
    {"render": {"spp": 2}},
    {"render": {"query_cap_fraction": 0.5}},
    {"path": {"coll_phase1_steps": 2}},
])
def test_unported_modes_raise(setup, change):
    cfg, _, ts, _, tstate = setup
    for section, kw in change.items():
        cfg = R(cfg, **{section: R(getattr(cfg, section), **kw)})
    with pytest.raises(NotImplementedError):
        tframe.render_only_step(tstate, ts, torch.Generator(), cfg)


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import sys, dataclasses
        import numpy as np, torch
        import neuralradiancecaching_tpu_torch
        from neuralradiancecaching_tpu import config as C
        from neuralradiancecaching_tpu.io import assets
        from neuralradiancecaching_tpu_torch.models import nrc
        from neuralradiancecaching_tpu_torch.render import frame
        from neuralradiancecaching_tpu_torch.scene import scene
        R = dataclasses.replace
        cfg = C.nrc_online_config(16, 16)
        cfg = R(cfg, path=R(cfg.path, sampler="collision",
                            collision_field_steps=4),
                mlp=R(cfg.mlp, fused_inference=True),
                volume=R(cfg.volume, grid_shape=(8, 6, 10),
                         field_shape=(3, 2, 4), field_dir_buckets=(4, 8),
                         field_out_buckets=(4, 8)),
                env_map=R(cfg.env_map, scatter_quad_dirs=(4, 8),
                          scatter_bake_steps=8))
        dens = np.random.default_rng(0).random((8, 6, 10), dtype=np.float32)
        sc = scene.make_scene(cfg, torch.tensor(dens),
                              torch.tensor(assets.synthesize_sky(16, 32)))
        g = torch.Generator().manual_seed(0)
        img = frame.render_only_step(nrc.init_state(g, cfg), sc, g, cfg)
        assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
