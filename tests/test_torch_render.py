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

The same bounds hold the walks' branches that no preset sets against
JAX's (``test_walk_branch_matches_jax``): the NN-mode march split of the
collision and delta walks, the dense per-slot shade, the reference march's
entry kill and the premultiplied env mode (its radiance field at the field
bakes' bound).

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
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import profiling
from tests.test_torch_oracle import jax_path_uniforms

R = dataclasses.replace
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors: the
    suite runs several test workers on the same cores, and thread pools
    per tiny op oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(obj):
    """The port's config equal field for field to a JAX config object."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tcfg_mod, type(obj).__name__)
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


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
    ts = tscene.make_scene(port_cfg(cfg), torch.tensor(dens),
                           torch.tensor(env))
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
    ts = dataclasses.replace(ts, camera=tcam.make_camera(
        port_cfg(cfg.camera), "cpu", pos, vdir))
    key = jax.random.PRNGKey(10 + frame)
    ref = np.asarray(jax_o0(
        lambda s, sc, k: jframe.render_only_step(s, sc, k, cfg), jstate, js,
        key))
    u = torch.tensor(_uniforms(key, cfg, W * H))
    out = tframe.render_only_step(tstate, ts, None, port_cfg(cfg),
                                  uniforms=u).numpy()
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
    out = tpt.trace_path(ts, port_cfg(cfg), tro, trd, None, use_nn=True,
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
    tcfg = port_cfg(cfg)
    ts = dataclasses.replace(
        ts, dir_light=tscene.make_dir_light(tcfg.dir_light, "cpu"),
        point_light=tscene.make_point_light(tcfg.point_light, "cpu"))
    rng = np.random.default_rng(5)
    pos = ((rng.random((2048, 3)) - 0.5)
           * np.asarray(cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n_env = cfg.env_map.n_samples
    ref = np.asarray(jax_o0(lambda sc, p, dd: jpt.trace_scene(
        sc, cfg, p, dd, jax.random.PRNGKey(0), n_env), js, pos, d))
    out = tpt.trace_scene(ts, tcfg, torch.tensor(pos), torch.tensor(d),
                          n_env).numpy()
    ok = np.all(np.abs(out - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    assert ok.mean() >= 0.995, ok.mean()


def test_render_on_cpu_takes_plain_mlp_and_no_launch(setup):
    cfg, _, ts, _, tstate = setup
    g = torch.Generator().manual_seed(0)
    with profiling.tracing("cpu") as rec, rec.frame(0):
        img = tframe.render_only_step(tstate, ts, g, port_cfg(cfg))
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert not [r for r in rec.records()
                if r.name == "k1" or "k1_f32_launches" in r.counts]


WALK_SIDE = 48  # 2304 lanes: the packs and the kill act above their
# 1024-lane floor

# each walk branch: (entry point compared, config changes)
BRANCHES = {
    "nn_split_collision": ("walk", {"path": {"coll_phase1_steps": 2}}),
    "nn_split_delta": ("walk", {"path": {"sampler": "delta",
                                         "coll_phase1_steps": 2}}),
    "dense_collision": ("render", {"path": {"coll_shade_cap": 0.0}}),
    "dense_delta": ("render", {"path": {"sampler": "delta",
                                        "coll_shade_cap": 0.0}}),
    "entry_kill": ("walk", {"path": {"sampler": "reference",
                                     "march_entry_fraction": 0.25}}),
    "premultiplied": ("render", {"env_map": {
        "in_scatter_mode": "mc", "transmittance_mode": "premultiplied"}}),
}


def branch_cfg(cfg, change):
    for section, kw in change.items():
        cfg = R(cfg, **{section: R(getattr(cfg, section), **kw)})
    return cfg


@pytest.fixture(scope="module")
def premultiplied(setup):
    """Both packages' scenes with the premultiplied radiance field."""
    cfg = branch_cfg(setup[0], BRANCHES["premultiplied"][1])
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    js = jax_o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)
    ts = tscene.make_scene(port_cfg(cfg), torch.tensor(dens),
                           torch.tensor(env))
    return js, ts


def test_build_radiance_field_matches_jax(premultiplied):
    """The premultiplied T * Env field of both packages' scene bakes, at the
    field bakes' bound (tests/test_torch_scene.py)."""
    js, ts = premultiplied
    ref = np.asarray(js.env_l_field)
    out = ts.env_l_field.numpy()
    assert out.shape == ref.shape and ref.shape[0] > 1
    assert ref.max() > 0.0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_walk_branch_matches_jax(setup, premultiplied, branch):
    """The walks' branches the port once left out, each against JAX from
    the JAX package's own draws (tests/test_torch_oracle.py:
    jax_path_uniforms): the NN-mode march split of the collision and delta
    walks and the reference march's entry kill through ``trace_path`` at
    48x48 (per lane, as test_trace_path_outputs_match_jax), the dense
    per-slot shade of the collision and delta walks and the premultiplied
    env mode through ``render_only_step`` at 32x32 (per pixel and the
    mean, as test_render_only_step_matches_jax)."""
    cfg, js, ts, jstate, tstate = setup
    kind, change = BRANCHES[branch]
    cfg = branch_cfg(cfg, change)
    tcfg = port_cfg(cfg)
    if branch == "premultiplied":
        js, ts = premultiplied
    key = jax.random.PRNGKey(40)
    if kind == "render":
        ref = np.asarray(jax_o0(
            lambda s, sc, k: jframe.render_only_step(s, sc, k, cfg),
            jstate, js, key))
        out = tframe.render_only_step(
            tstate, ts, None, tcfg,
            uniforms=jax_path_uniforms(cfg, key, W * H, True)).numpy()
        assert np.isfinite(out).all()
        frac_ok, rel_mean = _close_enough(out, ref)
        assert frac_ok >= 0.995 and rel_mean <= 1e-4, (frac_ok, rel_mean)
        return
    n = WALK_SIDE * WALK_SIDE
    shapes = tpt.walk_uniform_shapes(tcfg, n, use_nn=True)
    assert len(shapes) == 2 and shapes[0][2] + shapes[1][2] < 2 * n, shapes
    jro, jrd = jcam.pixel_rays(js.camera, WALK_SIDE, WALK_SIDE)
    tro, trd = tcam.pixel_rays(ts.camera, WALK_SIDE, WALK_SIDE)
    ref = jax_o0(lambda sc, o, d: jpt.trace_path(sc, cfg, o, d, key,
                                                  use_nn=True), js, jro, jrd)
    out = tpt.trace_path(ts, tcfg, tro, trd, None, use_nn=True,
                         uniforms=jax_path_uniforms(cfg, key, n, True))
    ok = np.ones(n, bool)
    for a, b in zip(ref, out):
        a, b = np.asarray(a).reshape(n, -1), b.numpy().reshape(n, -1)
        ok &= np.all(np.abs(b - a) <= 1e-4 + 1e-3 * np.abs(a), axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert float(out.query_weight.gt(0).float().mean()) > 0.05


def test_port_never_imports_jax():
    """The port's online frame (train + render), the progressive frame of
    config 5 with bf16 fields and the bf16 query (train, bake, the
    hoists and ``render_banded``), the unbiased oracle's render (delta,
    ratio tracking, MC in-scatter) and a reference-sampler online frame,
    its config and its assets, the CLI's banded nrc-online (with a
    checkpoint) and progressive runs, both again data-parallel on a gloo
    group of one (``--mesh 1``: ``dp_train_banded_frame``, the per-shard
    cap probe), the ``parallel`` package and its job runner, its mnist (on
    labels written here) and image-fit runs, the offline path tracer (on
    the corner table and on the raw grid), ``render_tiled``, ``utils``
    (``debug``, ``log``, ``profiling``), the port's quality tool
    (``bench_torch.run_bench``, every quality leg at a toy size, with the
    cap probes of ``benchmark/caps.py``) and the native
    asset library (``utils.setup_cache``, then ``assets.load_env_map`` on an
    RLE ``.hdr`` written here, decoded by ``io/native.py`` over
    ``csrc/nrcio.cpp``, built at first use) on the CPU load no
    module of JAX and none of the JAX package: the port's own
    ``neuralradiancecaching_tpu_torch*`` modules are the only ones of this
    repository in the process."""
    code = textwrap.dedent("""
        import sys, dataclasses
        import numpy as np, torch
        import neuralradiancecaching_tpu_torch
        from neuralradiancecaching_tpu_torch import config as C
        from neuralradiancecaching_tpu_torch.io import assets
        from neuralradiancecaching_tpu_torch.models import nrc
        from neuralradiancecaching_tpu_torch.ops import matmul
        from neuralradiancecaching_tpu_torch.render import frame, tiled
        from neuralradiancecaching_tpu_torch.scene import scene
        R = dataclasses.replace
        import tempfile
        from neuralradiancecaching_tpu_torch.utils import setup_cache
        setup_cache()
        rgbe = np.random.default_rng(1).integers(0, 256, (4, 16, 4),
                                                 dtype=np.uint8)
        payload = b"".join(bytes([2, 2, 0, 16]) + b"".join(
            bytes([16]) + rgbe[y, :, c].tobytes() for c in range(4))
            for y in range(4))
        with tempfile.TemporaryDirectory() as d:
            with open(d + "/sky.hdr", "wb") as f:
                f.write(b"#?RADIANCE\\n\\n-Y 4 +X 16\\n" + payload)
            env = assets.load_env_map(d + "/sky.hdr")
        assert env.shape == (4, 16, 3) and np.isfinite(env).all()
        assert np.array_equal(env, assets.hdr_decode_plain(payload, 16, 4))
        cfg = C.nrc_online_config(16, 16)
        cfg = R(cfg, path=R(cfg.path, sampler="collision",
                            collision_field_steps=4),
                mlp=R(cfg.mlp, fused_inference=True),
                volume=R(cfg.volume, grid_shape=(8, 6, 10),
                         field_shape=(3, 2, 4), field_dir_buckets=(4, 8),
                         field_out_buckets=(4, 8)),
                env_map=R(cfg.env_map, scatter_quad_dirs=(4, 8),
                          scatter_bake_steps=8),
                train=R(cfg.train, train_width=8, train_height=8,
                        target_bounces=8))
        dens = np.random.default_rng(0).random((8, 6, 10), dtype=np.float32)
        sc = scene.make_scene(cfg, dens, assets.synthesize_sky(16, 32),
                              device="cpu")
        g = torch.Generator().manual_seed(0)
        st = nrc.init_state(g, cfg, device="cpu")
        st, out = frame.frame_step(st, sc, g, cfg, train=True)
        img = out.image
        assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
        assert bool(torch.isfinite(out.mse)) and int(st.opt_step) == 1
        matmul.matmul(torch.ones(2, 3), torch.ones(3, 4))
        c5 = R(cfg, volume=R(cfg.volume, field_dtype="bfloat16"),
               mlp=R(cfg.mlp, inference_dtype="bfloat16"),
               render=R(cfg.render, live_pack_fraction=0.5,
                        live_tau_threshold=0.005, shade_slot0_dense=True))
        sc = scene.make_scene(c5, dens, assets.synthesize_sky(16, 32),
                              device="cpu")
        st, _ = frame.train_only_step(nrc.init_state(g, c5, device="cpu"),
                                      sc, g, c5)
        img = tiled.render_banded(
            st, sc, g, c5, 4, env_rgb=tiled.frame_env_color(sc, c5),
            baked=nrc.bake(st, c5), pack=tiled.frame_live_pack(sc, c5, 4))
        assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
        oracle = R(cfg, render=R(cfg.render, use_nn=False),
                   path=R(cfg.path, sampler="delta", max_bounces=8,
                          transmittance_mode="ratio",
                          delta_majorant_cells=(4, 3, 5)),
                   env_map=R(cfg.env_map, in_scatter_mode="mc",
                             transmittance_mode="ratio", n_samples=2))
        sc = scene.make_scene(oracle, dens, assets.synthesize_sky(16, 32),
                              device="cpu")
        img = frame.render_only_step(st, sc, g, oracle)
        assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
        ref = R(cfg, path=R(cfg.path, sampler="reference", max_bounces=8),
                mlp=R(cfg.mlp, fused_inference=True))
        sc = scene.make_scene(ref, dens, assets.synthesize_sky(16, 32),
                              device="cpu")
        st, out = frame.frame_step(nrc.init_state(g, ref, device="cpu"), sc,
                                   g, ref)
        assert bool(torch.isfinite(out.image).all())
        assert bool(torch.isfinite(out.mse))
        from neuralradiancecaching_tpu_torch import cli
        for name in ("nrc_online_config", "progressive_1080p_config"):
            full = getattr(C, name)
            setattr(C, name, lambda *a, full=full, **k: R(
                full(*a, **k), volume=cfg.volume, env_map=cfg.env_map,
                train=cfg.train, path=R(full(*a, **k).path,
                                        collision_field_steps=4)))
        assets.load_cloud = lambda path=None: dens
        assets.load_env_map = lambda path=None: assets.synthesize_sky(16, 32)
        cli._band_rows = lambda w, h, n_dev=1: 4
        with tempfile.TemporaryDirectory() as out:
            for argv in (["nrc-online", "--frames", "1", "--checkpoint",
                          out + "/ck"], ["progressive", "--frames", "1"],
                         ["nrc-online", "--frames", "1", "--mesh", "1"],
                         ["progressive", "--frames", "1", "--mesh", "1"]):
                cli.main(["--device", "cpu", *argv, "--width", "16",
                          "--height", "16", "--out", out])
            import struct
            rng = np.random.default_rng(0)
            for name, n in (("train", 256), ("t10k", 64)):
                with open(f"{out}/{name}-labels-idx1-ubyte", "wb") as f:
                    f.write(struct.pack(">ii", 2049, n) + rng.integers(
                        0, 10, n).astype(np.uint8).tobytes())
            assets.MNIST_DIRS = (out,)
            cli.main(["--device", "cpu", "mnist", "--steps", "2", "--out",
                      out])
            cli.main(["--device", "cpu", "image-fit", "--steps", "2",
                      "--out", out])
        from neuralradiancecaching_tpu_torch import parallel
        from neuralradiancecaching_tpu_torch.parallel import job
        from neuralradiancecaching_tpu_torch.ops import volume
        from neuralradiancecaching_tpu_torch.render import (
            offline_pathtracer as opt)
        ocfg = opt.OfflinePTConfig(max_bounces=4, transmittance_steps=4,
                                   shadow_samples=4)
        ro = torch.zeros((8, 3)) + torch.tensor([0.0, 0.0, -400.0])
        rd = torch.tensor([[0.0, 0.0, 1.0]]).expand(8, 3)
        res = opt.trace(volume.build_corner_table(torch.tensor(dens)),
                        cfg.volume, ocfg, [0.0, -1.0, 0.0], 1.0, ro, rd,
                        opt.draw_offline_uniforms(g, ocfg, 8))
        assert bool(torch.isfinite(res.color).all())
        from neuralradiancecaching_tpu_torch.utils import (debug, log,
                                                           profiling)
        with profiling.tracing("cpu") as rec:
            with rec.frame(0):
                img = tiled.render_tiled(st, sc, g, ref, 4)
        debug.assert_all_finite({"image": img}, "render_tiled")
        with debug.nan_check():
            res = opt.trace(torch.tensor(dens), cfg.volume, ocfg,
                            [0.0, -1.0, 0.0], 1.0, ro, rd,
                            opt.draw_offline_uniforms(g, ocfg, 8))
        log.Log.info(", ".join(r.name for r in rec.records()))
        import os
        import bench_torch
        os.environ.update(
            BENCH_QUALITY_SIZE="8", BENCH_QUALITY_TRAIN="1",
            BENCH_QUALITY_SPP="2", BENCH_QUALITY_REF_SPP="2",
            BENCH_QUALITY_GT_SPP="2", BENCH_QUALITY_GT_SIZE="8",
            BENCH_QUALITY_TRACK_STEPS="1", BENCH_QUALITY_CADENCE_FRAMES="1",
            BENCH_TWIN_CACHE="0")
        bench_torch.WIDTH = bench_torch.HEIGHT = 16
        bench_torch.CACHE_POINTS, bench_torch.CACHE_CHUNK = 32, 16
        bench_torch.CACHE_SAMPLES = bench_torch.WARM_TRAIN_STEPS = 1
        res = bench_torch.run_bench("cpu")
        assert res["fused_inference"] and res["cache_probe_points"] > 0, res
        ours = "neuralradiancecaching_tpu_torch"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0].startswith("jax")
                     or (m.startswith("neuralradiancecaching_tpu")
                         and m != ours and not m.startswith(ours + ".")))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")
