"""The port's image-quality tool (``bench_torch.py``) against
``bench.py``'s protocol on the CPU: the orbit poses of the quality legs
against the JAX package's cameras, the cap arithmetic of the probes it
takes from ``benchmark/caps.py`` against ``bench.py``'s formulas,
``cache_quality``'s binning and error against ``bench.py``'s
``jax.ops.segment_sum`` form, every quality leg at a toy size through
``run_bench``, the twin cache's replay and misses (another config, pose,
seed, cloud or sky), and the exit without CUDA. Bounds, each with its reason:
- the orbit cameras: within 1e-6 (+ 1e-6 relative): both build the matrices
  in float32 from the same float32 pose, numpy against jnp;
- the caps: equal (the same float64 expressions);
- the binned error: within 1e-6 relative (float32 bin sums in index order
  on both sides; the bins used and the point count equal);
- the twin cache: the replay bit for bit (it is the stored array).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from benchmark import caps
from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.io import assets
from neuralradiancecaching_tpu_torch.scene.scene import make_scene

R = dataclasses.replace
REPO = Path(__file__).resolve().parents[1]
STEP = 0.015625

# bench.py's quality keys (its result from relative_rmse on: the keys
# before it are the timed legs', which the benchmark's cells measure), the
# caps the legs ran under and the device fields
R05 = list(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])
QUALITY_KEYS = R05[R05.index("relative_rmse"):]
PORT_KEYS = ("query_cap", "shade_cap", "live_pack", "event_mean",
             "entry_live_fraction", "device", "power_limit_w", "devices",
             "cloud_source", "env_source", "fused_inference", "oracle_mean")
# bench.py emits null for these (bench.py:965-970, :888); on the CPU the
# port has no power limit to read
NULL_OK = {"cache_rel_err_binned", "cadence_cache_err"}
NULL_ON_CPU = {"power_limit_w"}
# the toy run: the tests' small config 5, its probes at 32x18, the quality
# legs at 16^2 with 2 spp, cache_quality at 256 points
TOY_ENV = dict(BENCH_QUALITY_SIZE=16, BENCH_QUALITY_TRAIN=4,
               BENCH_QUALITY_SPP=2, BENCH_QUALITY_REF_SPP=2,
               BENCH_QUALITY_GT_SPP=2, BENCH_QUALITY_GT_SIZE=16,
               BENCH_QUALITY_TRACK_STEPS=2, BENCH_QUALITY_CADENCE_FRAMES=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
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


# the preset itself: the toy fixture replaces the module's with the cut
FULL_CONFIG5 = tcfg_mod.progressive_1080p_config


def small_config5():
    """Config 5 cut to the tests' size (tests/test_torch_tiled.py): the
    (16, 12, 20) grid, (6, 5, 8) fields at (8, 16) buckets, a 16x16 train
    grid of 16-slot target walks."""
    cfg = FULL_CONFIG5()
    return R(cfg, path=R(cfg.path, collision_field_steps=8),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8), field_dir_buckets=(8, 16)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


def ball_cloud(shape, seed: int = 0) -> np.ndarray:
    """A seeded random ball of density: rays miss the box, graze it below
    the live threshold, or cross it."""
    rng = np.random.default_rng(seed)
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in shape]
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(*axes, indexing="ij")))
    return (rng.random(shape, dtype=np.float32) * 0.6 * (r < 0.4)).astype(
        np.float32)


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """The bench at the toy size on the CPU: the small config 5, the ball
    cloud, the synthesized sky, the caches in tmp_path."""
    monkeypatch.setattr(tcfg_mod, "progressive_1080p_config", small_config5)
    dens = ball_cloud((16, 12, 20))
    monkeypatch.setattr(assets, "load_cloud", lambda path=None: dens)
    monkeypatch.setattr(assets, "CLOUD_FILES", ())
    monkeypatch.setattr(bench_torch, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(bench_torch, "CACHE_POINTS", 256)
    monkeypatch.setattr(bench_torch, "CACHE_CHUNK", 128)
    monkeypatch.setattr(bench_torch, "CACHE_SAMPLES", 4)
    monkeypatch.setattr(bench_torch, "WIDTH", 32)
    monkeypatch.setattr(bench_torch, "HEIGHT", 18)
    monkeypatch.setattr(bench_torch, "WARM_TRAIN_STEPS", 1)
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in TOY_ENV.items():
        monkeypatch.setenv(k, str(v))
    return dens


# -- the orbit poses ----------------------------------------------------------

@pytest.mark.parametrize("aspect", [1920.0 / 1080.0, 1.0])
@pytest.mark.parametrize("frame_i,n", [(i, 360) for i in range(11)]
                         + [(1, 64)])
def test_orbit_camera_matches_jax(aspect, frame_i, n):
    """bench.py's orbit scenes (``orbit_position(i, n, radius=64)`` +
    ``make_camera``; the quality legs at aspect 1, the frame's aspect as
    bench.py's moving leg takes it) equal the JAX package's cameras."""
    jc = R(jcfg_mod.progressive_1080p_config().camera, aspect=aspect)
    pos, view_dir = jcam.orbit_position(frame_i, n, radius=64.0)
    ref = jcam.make_camera(jc, position=pos, view_dir=view_dir)
    got = bench_torch.orbit_camera(port_cfg(jc), frame_i, n, "cpu")
    for field in ("position", "inv_proj_view", "proj_view"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


# -- the caps ----------------------------------------------------------------

def _near_steps(offset: float, scale: float) -> list:
    """Values whose capped form lands on, just below and just above a 1/64
    step, and 0 and 1."""
    out = [0.0, 1.0]
    for k in (1, 13, 14, 40, 63):
        x = (k * STEP - offset) / scale
        out += [x, np.nextafter(x, -1.0), np.nextafter(x, 2.0), x - 1e-9,
                x + 1e-9]
    return [v for v in out if v >= 0.0]


@pytest.mark.parametrize("qfrac", _near_steps(0.005, 1.05))
def test_query_and_pack_caps_match_bench(qfrac):
    """The pack cap of bench.py:258-259 (the formula of the query cap at
    :202-203, which the pack always overrides to 1.0 at :266-267)."""
    ref = min(1.0, float(np.ceil((qfrac * 1.05 + 0.005) / 0.015625)
                         * 0.015625))
    assert caps.pack_cap(qfrac) == ref
    assert ref >= STEP


@pytest.mark.parametrize("worst", _near_steps(0.005, 1.08))
def test_moving_cap_matches_bench(worst):
    # bench.py:472-474
    ref = min(1.0, float(np.ceil((worst * 1.08 + 0.005) / 0.015625)
                         * 0.015625))
    assert caps.moving_cap(worst) == ref


@pytest.mark.parametrize("slot0_dense", [True, False])
@pytest.mark.parametrize("tail", _near_steps(0.01, 1.05) + [2.5])
def test_shade_cap_matches_bench(tail, slot0_dense):
    ev0_mean, k_slots = 0.8125, 2.0
    ev_mean = tail + ev0_mean if slot0_dense else tail
    # bench.py:240-244
    cap_mean = ev_mean - ev0_mean if slot0_dense else ev_mean
    ref = min(k_slots, float(np.ceil((cap_mean * 1.05 + 0.01) / 0.015625)
                             * 0.015625))
    assert caps.shade_cap(ev_mean, ev0_mean, k_slots, slot0_dense) == ref


# -- cache_quality's binning --------------------------------------------------

def jax_bin(pos, d, val, target, pred, center, bins=16):
    """bench.py:947-976 restated: the segment sums of ``pred_and_bin`` and
    the host reduction."""
    ctr = jnp.asarray(center)
    bits = ((pos > ctr).astype(jnp.int32) * jnp.asarray([1, 2, 4])).sum(-1)
    bin_id = jnp.where(val, bits + 8 * (d[:, 2] > 0), bins)
    t_bin = jax.ops.segment_sum(jnp.where(val[:, None], target, 0.0),
                                bin_id, num_segments=bins + 1)[:bins]
    p_bin = jax.ops.segment_sum(jnp.where(val[:, None], pred, 0.0),
                                bin_id, num_segments=bins + 1)[:bins]
    cnt = jax.ops.segment_sum(val.astype(jnp.float32), bin_id,
                              num_segments=bins + 1)[:bins]
    keep = np.asarray(cnt) >= 64
    t_m = np.asarray(t_bin)[keep] / np.asarray(cnt)[keep][:, None]
    p_m = np.asarray(p_bin)[keep] / np.asarray(cnt)[keep][:, None]
    if not keep.any():
        return {"cache_rel_err_binned": None, "cache_bins_used": 0,
                "cache_probe_points": int(np.asarray(val.sum()))}
    rel = float(np.sqrt(np.mean((p_m - t_m) ** 2))
                / max(np.sqrt(np.mean(t_m ** 2)), 1e-9))
    return {"cache_rel_err_binned": rel, "cache_bins_used": int(keep.sum()),
            "cache_probe_points": int(np.asarray(val.sum()))}


@pytest.mark.parametrize("n", [4096, 400])
def test_bin_cache_error_matches_bench(n):
    """n = 4096: most bins hold >= 64 points; n = 400: none does, and both
    give null."""
    rng = np.random.default_rng(n)
    center = (0.0, 0.5, -1.0)
    pos = (rng.normal(size=(n, 3)) + np.asarray(center)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    val = rng.random(n) < 0.9
    target = rng.random((n, 3), dtype=np.float32)
    pred = (target + 0.05 * rng.normal(size=(n, 3))).astype(np.float32)
    ref = jax_bin(jnp.asarray(pos), jnp.asarray(d), jnp.asarray(val),
                  jnp.asarray(target), jnp.asarray(pred), center)
    got = bench_torch.bin_cache_error(pos, d, val, target, pred, center)
    assert got["cache_bins_used"] == ref["cache_bins_used"]
    assert got["cache_probe_points"] == ref["cache_probe_points"]
    if n == 400:
        assert ref["cache_rel_err_binned"] is None
        assert got["cache_rel_err_binned"] is None
    else:
        assert ref["cache_bins_used"] >= 12
        assert got["cache_rel_err_binned"] == pytest.approx(
            ref["cache_rel_err_binned"], rel=1e-6, abs=1e-5)


# -- cache_quality's parts against the JAX package --------------------------

def test_cache_quality_parts_match_jax(toy):
    """On the same probe points (the port's ``probe_points`` at 32x32, 256
    of them) and the same state (JAX's init state): the MC targets of the
    port's ``mc_targets`` in 2 chunks of 128 rows and JAX's
    ``cache_targets_collision`` with 16 samples over the same 2 chunks
    (bench.py:933-940 chunks the same way; the estimate depends on the
    chunk, since the target walk's caps scale with its lane count) agree
    per point up to MC noise (the mean per-point difference within 4
    standard errors of itself, per channel), and the cache's predictions
    agree within 1e-3 +
    1e-2 |ref| (the bf16 query: torch rounds the encode at other places
    than XLA:CPU, tests/test_torch_bf16.py)."""
    from neuralradiancecaching_tpu.models import nrc as jnrc
    from neuralradiancecaching_tpu.render import targets as jtargets
    from neuralradiancecaching_tpu.scene import scene as jscene
    from neuralradiancecaching_tpu_torch.models import nrc as tnrc
    jcfg = jcfg_mod.progressive_1080p_config()
    jcfg = R(jcfg, path=R(jcfg.path, collision_field_steps=8),
             volume=R(jcfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8), field_dir_buckets=(8, 16)),
             env_map=R(jcfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(jcfg.train, train_width=16, train_height=16,
                     target_bounces=16),
             camera=R(jcfg.camera, aspect=1.0),
             render=R(jcfg.render, width=32, height=32, use_nn=True,
                      query_cap_fraction=0.375),
             mlp=R(jcfg.mlp, inference_dtype="bfloat16"))
    pcfg = port_cfg(jcfg)
    sky = assets.synthesize_sky()
    jsc = jscene.make_scene(jcfg, toy, sky)
    tsc = make_scene(pcfg, toy, sky, device="cpu")
    jst = jnrc.init_state(jax.random.PRNGKey(0), jcfg)
    tst = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst)._asdict(), "cpu")
    pos, d, val = bench_torch.probe_points(pcfg, tsc, 256,
                                           torch.Generator().manual_seed(11))
    v = val.numpy()
    assert v.sum() > 100
    got = bench_torch.mc_targets(pcfg, tsc, pos, d, 16,
                                 torch.Generator().manual_seed(12)).numpy()
    jp, jd = jnp.asarray(pos.numpy()), jnp.asarray(d.numpy())
    one_chunk = jax.jit(lambda p, dd, k: jtargets.cache_targets_collision(
        jsc, jcfg, p, dd, k, samples=16))
    ref = np.concatenate([np.asarray(one_chunk(
        jp[i:i + 128], jd[i:i + 128], jax.random.PRNGKey(12 + i)))
        for i in (0, 128)])
    diff = (got - ref)[v]
    se = diff.std(axis=0, ddof=1) / np.sqrt(diff.shape[0])
    assert np.all(np.abs(diff.mean(axis=0)) <= 4 * se), (diff.mean(0), se)
    jpred = np.asarray(jnrc.query_baked(jst, jnrc.bake(jst, jcfg), jp, jd,
                                        jcfg))
    tpred = tnrc.query_baked(tst, tnrc.bake(tst, pcfg), pos, d, pcfg).numpy()
    np.testing.assert_allclose(tpred[v], jpred[v], rtol=1e-2, atol=1e-3)


# -- the whole bench at a toy size -------------------------------------------

def test_run_bench_toy_has_every_key(toy, tmp_path):
    """Every quality leg through ``run_bench`` on the CPU: bench.py's
    quality keys and the port's, and no other (no timed leg's), every
    number finite, null only where bench.py emits null (or, on the CPU,
    for the card's power limit)."""
    res = bench_torch.run_bench("cpu")
    assert set(res) == set(QUALITY_KEYS) | set(PORT_KEYS), sorted(
        set(res) ^ (set(QUALITY_KEYS) | set(PORT_KEYS)))
    for k, v in res.items():
        if v is None:
            assert k in NULL_OK | NULL_ON_CPU, k
        elif isinstance(v, (int, float)):
            assert np.isfinite(v), (k, v)
    assert res["fused_inference"] is True and res["device"] == "cpu"
    assert res["query_cap"] == 1.0 and res["live_pack"] >= STEP
    assert res["cloud_source"] == "unknown"
    assert res["env_source"] == "synthesized"
    # the cap A/B is exact: the caps change no draw
    assert res["cap_bias_rmse"] == 0.0
    assert 0 < res["cache_probe_points"] <= 256
    # no twin cache in the repository: it went to tmp_path
    assert list((tmp_path / "bench_twins").glob("*.npz"))


def test_twin_cache_replays_and_misses(toy, monkeypatch, tmp_path):
    """A second no-cache accumulation replays from the cache bit for bit
    without rendering; a changed config field, pose or seed misses."""
    cfg = small_config5()
    cfg = R(cfg, camera=R(cfg.camera, aspect=1.0),
            render=R(cfg.render, width=16, height=16, use_nn=False))
    scene = make_scene(cfg, toy, assets.synthesize_sky(), device="cpu")
    first = bench_torch.accumulate_cached(cfg, scene, 2, 3000, "ref", "cpu")
    renders = []
    plain = bench_torch.accumulate

    def counted(*args, **kw):
        renders.append(args[3:5])
        return plain(*args, **kw)

    monkeypatch.setattr(bench_torch, "accumulate", counted)
    again = bench_torch.accumulate_cached(cfg, scene, 2, 3000, "ref", "cpu")
    assert renders == []
    assert again.dtype == first.dtype and again.tobytes() == first.tobytes()
    other = R(cfg, path=R(cfg.path, max_bounces=cfg.path.max_bounces - 1))
    bench_torch.accumulate_cached(other, scene, 2, 3000, "ref", "cpu")
    bench_torch.accumulate_cached(cfg, scene, 2, 3000, "ref", "cpu",
                                  pose="orbit1")
    bench_torch.accumulate_cached(cfg, scene, 2, 7000, "ref", "cpu")
    assert renders == [(2, 3000), (2, 3000), (2, 7000)]
    assert len(list((tmp_path / "bench_twins").glob("ref_*.npz"))) == 4
    monkeypatch.setenv("BENCH_TWIN_CACHE", "0")
    bench_torch.accumulate_cached(cfg, scene, 2, 3000, "ref", "cpu")
    assert len(renders) == 4
    with pytest.raises(ValueError):
        bench_torch.accumulate_cached(
            R(cfg, render=R(cfg.render, use_nn=True)), scene, 2, 3000,
            "nn", "cpu")


@pytest.mark.parametrize("changed", ["cloud", "sky"])
def test_twin_cache_misses_on_another_scene(toy, monkeypatch, tmp_path,
                                            changed):
    """The twin cache keys on the scene: a cloud with one voxel changed, or
    another sky, renders anew under its own file."""
    cfg = small_config5()
    cfg = R(cfg, camera=R(cfg.camera, aspect=1.0),
            render=R(cfg.render, width=16, height=16, use_nn=False))
    sky = assets.synthesize_sky()
    scene = make_scene(cfg, toy, sky, device="cpu")
    first = bench_torch.accumulate_cached(cfg, scene, 2, 3000, "ref", "cpu")
    if changed == "cloud":
        dens = toy.copy()
        dens[8, 6, 10] += 0.25
        other = make_scene(cfg, dens, sky, device="cpu")
    else:
        other = make_scene(cfg, toy, sky * 1.5, device="cpu")
    renders = []
    plain = bench_torch.accumulate

    def counted(*args, **kw):
        renders.append(args[3:5])
        return plain(*args, **kw)

    monkeypatch.setattr(bench_torch, "accumulate", counted)
    again = bench_torch.accumulate_cached(cfg, other, 2, 3000, "ref", "cpu")
    assert renders == [(2, 3000)]
    assert again.tobytes() != first.tobytes()
    assert len(list((tmp_path / "bench_twins").glob("ref_*.npz"))) == 2


def test_no_cuda_exits_2_without_a_result():
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
