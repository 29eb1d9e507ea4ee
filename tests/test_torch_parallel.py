"""The port's data parallel (``neuralradiancecaching_tpu_torch/parallel``)
against the JAX package's ``shard_map`` steps on ``make_mesh(2)`` of the 8
virtual CPU devices, at the tiny configs of tests/test_parallel.py.

The port's world-size-2 runs are two gloo ranks in their own processes
(``parallel.spawn`` of ``parallel.job``: a FileStore in ``tmp_path``, no
TCP port), which import nothing of JAX; their inputs (the scene's numpy
arrays, the configs, the states and every draw) go in and their results
come back as ``torch.save`` files. World size 1 runs in this process on a
gloo group of one. The JAX side is computed here, each program compiled
once by XLA:CPU's LLVM backend at -O0 (see tests/test_torch_render.py),
and its draws are rebuilt key by key: the pool jitter ``fold_in(k_pool,
i)``, each device's train batch from ``fold_in(k_train, d)`` and its
pixels' walk from ``fold_in(k_render, d)`` (JAX's ``_device_key``).

Tolerances, each with its reason:
- ``dp_train_step`` and the states of ``dp_frame_step``: the MLP within
  1e-6, >= 99.9% of hash entries within 1e-6 and every other within
  2 x lr, the mse within 1e-5 relative -- tests/test_torch_train.py's
  bounds (Adam's eps 1e-15 turns a rounding-level gradient whose sign
  differs between XLA's scatter-add order and ``index_add_``'s into an
  +-lr step);
- the ranks' states, images and mse: bitwise equal (one ring sum on
  every rank, the same optimizer step);
- ``dp_frame_step``'s image: >= 99.5% of pixels within 1e-4 + 1e-3 |ref|
  and the mean within 1e-4 relative (the whole-frame parity tests' bound:
  a one-ulp difference can flip a bucket and change a ray wholesale);
- the banded DP renders against ``render_banded`` on the same per-band
  draws: within 1e-6 + 1e-6 |ref| -- each rank's finish runs the query MLP
  on its own rows, and a matmul over another row count may round
  differently (measured: bitwise at world size 1);
- ``frame_live_pack(multiple_of=2)``: sel, val and inv bitwise, the rays
  and entry tau within 1e-5 (fp32 camera math in another order), as
  tests/test_torch_tiled.py holds the pack;
- ``probe_dp_caps``: the caps equal JAX's, the fractions within 1e-6
  (the same lanes query and scatter on both sides: float64 sums in
  another order); the tight caps' image within 1e-6 / 1e-7 of the
  drop-free one, as JAX's test_probe_dp_caps_tight_and_drop_free.
"""

import dataclasses
import json
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.parallel import data_parallel as jdp
from neuralradiancecaching_tpu.parallel import make_mesh as jmake_mesh
from neuralradiancecaching_tpu.render import tiled as jtiled
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch import cli as tcli
from neuralradiancecaching_tpu_torch import parallel as tpar
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.parallel import data_parallel as tdp
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.render import targets as ttargets
from neuralradiancecaching_tpu_torch.render import tiled as ttiled
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from tests.test_parallel import dp_collision_config
from tests.test_render_nrc import tiny_config
from tests.test_torch_oracle import jax_path_uniforms, jax_scene_uniforms
from tests.test_torch_tiled import port_cfg, to_t

R = dataclasses.replace
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DEV = 2
O0 = {"xla_backend_optimization_level": 0}
SAMPLERS = ("collision", "delta", "reference")
PROBE_SIDE, PROBE_BAND = 128, 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_fields(cfg):
    """f32 baked fields: lane-level parity (bf16 rounds at other places in
    torch than in XLA:CPU, tests/test_torch_tiled.py)."""
    return R(cfg, volume=R(cfg.volume, field_dtype="float32"))


def sampler_cfg(sampler):
    """tests/test_parallel.py's configs: the collision pipeline
    (dp_collision_config), its delta variant
    (test_dp_delta_frame_step_end_to_end) and the reference sampler's
    tiny config (with the others' (4, 4, 4) field voxels); all 16x16
    frames of 8x4 train grids, the camera moved in to z = -12 (as
    tests/test_collision.py's) so that the box fills most of the frame
    instead of ~1 pixel."""
    cfg = f32_fields(dp_collision_config())
    if sampler == "delta":
        cfg = R(cfg, path=R(cfg.path, sampler="delta", delta_null_steps=8,
                            delta_majorant="local",
                            delta_majorant_cells=(4, 4, 4),
                            delta_majorant_samples=8))
    elif sampler == "reference":
        ref = tiny_config(use_nn=True)
        cfg = R(ref, train=R(ref.train, train_width=8, train_height=4),
                render=R(ref.render, width=16, height=16),
                volume=R(ref.volume, field_shape=(4, 4, 4)))
    return R(cfg, camera=R(cfg.camera, position=(0.0, 0.0, -12.0)))


def probe_cfg():
    """JAX's skewed probe scene (test_probe_dp_caps_tight_and_drop_free):
    the camera pushed down-left, 128x128, here in 32-row bands over 2
    ranks."""
    cfg = f32_fields(dp_collision_config())
    return R(cfg, camera=R(cfg.camera, position=(6.0, 9.0, -14.0)),
             render=R(cfg.render, width=PROBE_SIDE, height=PROBE_SIDE))


def compile_o0(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=O0)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def state_np(state) -> dict:
    """A port state's fields (NRCState or the job's dict) as numpy."""
    d = (state if isinstance(state, dict) else
         {f.name: getattr(state, f.name) for f in dataclasses.fields(state)})
    return jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, d)


def jax_pool_jitter(k_pool, cfg):
    """train_ray_pool(k_pool)'s jitters (targets.py:304-332)."""
    over = (max(1, cfg.train.vertex_oversample)
            if cfg.path.sampler in ("collision", "delta") else 1)
    tw, th = cfg.train.train_width, cfg.train.train_height
    return to_t(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(k_pool, i), (2, th, tw))) for i in range(over)]))


def jax_shard_train_uniforms(kd, cfg, n):
    """The draws of generate_train_batch_for_rays(kd) over one device's
    share of the pool, n batch rows (targets.py:333-443), as the port's
    TrainUniforms of ``draw_train_uniforms(..., rays=n)``."""
    tcfg = port_cfg(cfg)
    k_v, k_t = jax.random.split(kd)
    n_t = cfg.train.target_samples * n
    tb = cfg.train.target_bounces
    rows = ttargets.train_shade_rows(tcfg, n)
    if cfg.path.sampler == "reference":
        steps = min(cfg.train.vertex_walk_steps or tb, tb)
        return ttargets.TrainUniforms(
            jitter=None,
            vertex=[to_t(jax.random.uniform(k_v, (steps, 4, n)))],
            perm=None, hg=None,
            target=[to_t(jax.random.uniform(jax.random.fold_in(k_t, 0),
                                            (tb, 4, n_t)))],
            shade=[jax_scene_uniforms(cfg, jax.random.fold_in(k_t, 1), r,
                                      cfg.train.env_samples) for r in rows])
    assert not rows  # the collision and delta tests' shades draw nothing
    over = cfg.train.vertex_oversample
    wcfg = ttargets._train_walk_cfg(tcfg)
    vertex = [to_t(jax.random.uniform(jax.random.fold_in(k_v, i), sh))
              for i, sh in enumerate(tpt.walk_uniform_shapes(
                  wcfg, over * n, use_nn=True))]
    perm = torch.tensor(np.asarray(jax.random.permutation(
        jax.random.fold_in(k_v, 1), over * n)), dtype=torch.int64)
    _, k_dirs, k_w = jax.random.split(k_t, 3)
    hg = to_t(np.stack([np.asarray(jax.random.uniform(k, (n_t,)))
                        for k in jax.random.split(k_dirs)]))
    target = [to_t(jax.random.uniform(jax.random.fold_in(k_w, i), sh))
              for i, sh in enumerate(tpt.walk_uniform_shapes(
                  wcfg, n_t, use_nn=False, max_bounces=tb))]
    return ttargets.TrainUniforms(None, vertex, perm, hg, target, [])


def jax_train_draws(key, cfg):
    """dp_train_step(key)'s draws: (jitter, one TrainUniforms per
    device)."""
    k_pool, k_train = jax.random.split(key)
    n = cfg.train.n_rays // N_DEV
    return (jax_pool_jitter(k_pool, cfg),
            [jax_shard_train_uniforms(jax.random.fold_in(k_train, d), cfg, n)
             for d in range(N_DEV)])


def jax_frame_draws(key, cfg):
    """dp_frame_step(key)'s draws: split(key, 3) into the pool, train and
    render keys, each device's keys folded with its index."""
    k_pool, k_train, k_render = jax.random.split(key, 3)
    n = cfg.train.n_rays // N_DEV
    n_px = cfg.render.width * cfg.render.height // N_DEV
    return dict(
        jitter=jax_pool_jitter(k_pool, cfg),
        train_uniforms=[jax_shard_train_uniforms(
            jax.random.fold_in(k_train, d), cfg, n) for d in range(N_DEV)],
        uniforms=[jax_path_uniforms(cfg, jax.random.fold_in(k_render, d),
                                    n_px, True) for d in range(N_DEV)])


def band_draws(cfg, n_bands, band_n, seed):
    """One PathUniforms per band from a seeded CPU generator (the port
    alone: the DP render against render_banded on the same list)."""
    g = torch.Generator().manual_seed(seed)
    return [tpt.draw_path_uniforms(port_cfg(cfg), band_n, True, g)
            for _ in range(n_bands)]


@pytest.fixture(scope="module")
def world():
    """The numpy scene of tests/test_parallel.py (tiny_scene: density 0.5
    everywhere, the 16x32 synthesized sky), each sampler's JAX scene and
    JAX init state with O(1) MLP weights (the 0.01 init makes the cache
    term ~1e-8), and the port's copies."""
    dens = np.full((16, 16, 16), 0.5, np.float32)
    env = jassets.synthesize_sky(16, 32)
    out = {}
    for name in SAMPLERS:
        cfg = sampler_cfg(name)
        js = compile_o0(lambda d, e: jscene.make_scene(cfg, d, e),
                        dens, env)(dens, env)
        jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
        rng = np.random.default_rng(1)
        jstate = jstate._replace(mlp_params={
            k: jnp.asarray((rng.standard_normal(v.shape)
                            * (0.25 if k[0] == "w" else 0.05))
                           .astype(np.float32))
            for k, v in jstate.mlp_params.items()})
        out[name] = (cfg, js, jstate, to_np(jstate)._asdict())
    return dens, env, out


@pytest.fixture(scope="module")
def jax_runs(world):
    """The JAX package's steps on make_mesh(2), and the draws they made."""
    _, _, scenes = world
    mesh = jmake_mesh(N_DEV)
    cfg, js, jstate, _ = scenes["collision"]
    key = jax.random.PRNGKey(7)
    step = compile_o0(lambda s, sc, k: jdp.dp_train_step(s, sc, k, cfg, mesh),
                      jstate, js, key)
    runs = {"train": (to_np(step(jstate, js, key)),
                      jax_train_draws(key, cfg))}
    key = jax.random.PRNGKey(13)
    render = compile_o0(lambda s, sc, k: jdp.dp_render(s, sc, k, cfg, mesh),
                        jstate, js, key)
    n_px = cfg.render.width * cfg.render.height // N_DEV
    runs["render"] = (np.asarray(render(jstate, js, key)), dict(
        uniforms=[jax_path_uniforms(cfg, jax.random.fold_in(key, d), n_px,
                                    True) for d in range(N_DEV)]))
    for name in SAMPLERS:
        cfg, js, jstate, _ = scenes[name]
        key = jax.random.PRNGKey(11)
        frame = compile_o0(
            lambda s, sc, k: jdp.dp_frame_step(s, sc, k, cfg, mesh),
            jstate, js, key)
        runs["frame_" + name] = (to_np(frame(jstate, js, key)),
                                 jax_frame_draws(key, cfg))
    return runs


@pytest.fixture(scope="module")
def probe(world):
    """The per-shard cap probe of both packages on the skewed scene
    (stride 1: every lane), from the JAX probe's own draws (key 97)."""
    dens, env, _ = world
    cfg = probe_cfg()
    js = compile_o0(lambda d, e: jscene.make_scene(cfg, d, e),
                    dens, env)(dens, env)
    cfg_j, rep_j = jdp.probe_dp_caps(js, cfg, N_DEV, band_rows=PROBE_BAND,
                                     stride=1)
    tcfg = port_cfg(cfg)
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    u = jax_path_uniforms(cfg, jax.random.PRNGKey(97), PROBE_SIDE ** 2,
                          True).walk
    cfg_t, rep_t = tdp.probe_dp_caps(ts, tcfg, N_DEV, band_rows=PROBE_BAND,
                                     stride=1, uniforms=u)
    return cfg, cfg_j, rep_j, cfg_t, rep_t


def packed_cfg():
    cfg = sampler_cfg("collision")
    """169 of the 256 rays are live: 0.68 packs them drop-free into 11
    one-row bands."""
    return R(cfg, render=R(cfg.render, live_pack_fraction=0.68))


def banded_cases(ts, tcfg):
    """The banded renders compared with render_banded: (step name, fn,
    cfg, kwargs) -- 2-row bands unpacked, 1-row bands over the live pack of
    multiple_of=2 (11 packed bands rounded up to 12, one of them
    padding)."""
    pcfg = port_cfg(packed_cfg())
    pack = ttiled.frame_live_pack(ts, pcfg, 1, multiple_of=N_DEV)
    n_p = pack.ro_p.shape[0]
    return [
        ("banded", "dp_render_banded", tcfg,
         dict(band_rows=2, uniforms=band_draws(tcfg, 8, 32, 3))),
        ("packed", "dp_render_banded_packed", pcfg,
         dict(band_rows=1, pack=pack, uniforms=band_draws(pcfg, n_p, 16,
                                                          4)))]


@pytest.fixture(scope="module")
def port_runs(world, jax_runs, probe, tmp_path_factory):
    """Every world-size-2 step of the port in one spawned gloo group."""
    dens, env, scenes = world
    steps = []
    cfg, _, _, st = scenes["collision"]
    jitter, tu = jax_runs["train"][1]
    steps.append(dict(name="train", fn="dp_train_step", cfg=port_cfg(cfg),
                      state=st, kwargs=dict(jitter=jitter,
                                            train_uniforms=tu)))
    steps.append(dict(name="render", fn="dp_render", cfg=port_cfg(cfg),
                      state=st, kwargs=jax_runs["render"][1]))
    for name in SAMPLERS:
        cfg, _, _, st = scenes[name]
        steps.append(dict(name="frame_" + name, fn="dp_frame_step",
                          cfg=port_cfg(cfg), state=st,
                          kwargs=jax_runs["frame_" + name][1]))
    # the same step again, from a generator: a run repeats itself
    for name in ("seeded", "seeded_again"):
        steps.append(dict(name=name, fn="dp_frame_step",
                          cfg=port_cfg(cfg), state=st, seed=21))
    tcfg = port_cfg(scenes["collision"][0])
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    for name, fn, c, kw in banded_cases(ts, tcfg):
        steps.append(dict(name=name, fn=fn, cfg=c, state=st, kwargs=kw))
    cfg, _, _, cfg_t, rep = probe
    n_bands = PROBE_SIDE // PROBE_BAND
    u = band_draws(cfg, n_bands, PROBE_BAND * PROBE_SIDE, 5)
    mean_cap = min(float(rep.event_mean.max()), tdp._round_cap(
        float(rep.event_mean.mean()), 1.05, 0.01))
    cfg_m = R(cfg_t, render=R(cfg_t.render, shade_cap_fraction=mean_cap))
    for name, c in (("probe_free", port_cfg(cfg)), ("probe_tight", cfg_t),
                    ("probe_mean", cfg_m)):
        steps.append(dict(name=name, fn="dp_render_banded", cfg=c,
                          state=scenes["collision"][3],
                          kwargs=dict(band_rows=PROBE_BAND, uniforms=u)))
    d = tmp_path_factory.mktemp("dp")
    torch.save(dict(density=dens, env=env, steps=steps), d / "job.pt")
    tpar.spawn(["-m", "neuralradiancecaching_tpu_torch.parallel.job",
                str(d / "job.pt"), str(d), "--device", "cpu"], N_DEV,
               d / "group", env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
               timeout=300)
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(N_DEV)], mean_cap


@pytest.fixture(scope="module")
def mesh1():
    """A gloo group of one in this process."""
    mesh = tpar.make_mesh(1, "cpu")
    yield mesh
    tpar.close_mesh()


# -- the train step and the frames ---------------------------------------

def assert_state_close(out, ref, cfg):
    for k in ref["mlp_params"]:
        np.testing.assert_allclose(out["mlp_params"][k], ref["mlp_params"][k],
                                   rtol=0, atol=1e-6, err_msg=k)
    diff = np.abs(out["hash_table"] - ref["hash_table"])
    assert (diff <= 1e-6).mean() >= 0.999, (diff <= 1e-6).mean()
    assert diff.max() <= 2 * cfg.mrhe.learning_rate * 1.0001, diff.max()
    assert (out["opt_step"] is None) == (ref["opt_step"] is None)
    if ref["opt_step"] is not None:
        assert int(out["opt_step"]) == int(ref["opt_step"])


def test_dp_train_step_matches_jax(world, jax_runs, port_runs):
    """One dp_train_step on two ranks against JAX's on make_mesh(2), with
    JAX's per-device draws."""
    (ref_state, ref_mse), _ = jax_runs["train"]
    state, mse = port_runs[0][0]["train"]
    cfg = world[2]["collision"][0]
    np.testing.assert_allclose(float(mse), float(ref_mse), rtol=1e-5)
    assert_state_close(state_np(state), ref_state._asdict(), cfg)


def test_dp_ranks_bitwise_equal(port_runs):
    """Every step's outputs -- states, images, mse -- are the same bits on
    both ranks."""
    (r0, r1), _ = port_runs
    assert r0.keys() == r1.keys()
    for name in r0:
        a = jax.tree_util.tree_leaves(r0[name])
        b = jax.tree_util.tree_leaves(r1[name])
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_dp_frame_step_matches_jax(world, jax_runs, port_runs, sampler):
    """dp_frame_step: the sharded train pass, the replicated step and the
    sharded render, against JAX's from the same per-device draws."""
    (ref_state, ref_img, ref_mse), _ = jax_runs["frame_" + sampler]
    state, img, mse = port_runs[0][0]["frame_" + sampler]
    cfg = world[2][sampler][0]
    np.testing.assert_allclose(float(mse), float(ref_mse), rtol=1e-5)
    assert_state_close(state_np(state), ref_state._asdict(), cfg)
    img, ref_img = img.numpy(), np.asarray(ref_img)
    assert img.shape == ref_img.shape == (16, 16, 3)
    assert np.isfinite(img).all() and ref_img.mean() > 0.0
    ok = np.all(np.abs(img - ref_img) <= 1e-4 + 1e-3 * np.abs(ref_img),
                axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(img.mean() - ref_img.mean()) <= 1e-4 * abs(ref_img.mean())


def test_dp_render_matches_jax(jax_runs, port_runs):
    """dp_render: each rank's contiguous share of the pixels, gathered,
    against JAX's from the same per-device draws."""
    ref, _ = jax_runs["render"]
    img = port_runs[0][0]["render"].numpy()
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all() and ref.mean() > 0.0
    ok = np.all(np.abs(img - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(img.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


def test_dp_frame_step_repeats_itself(port_runs):
    """The same dp_frame_step (the reference sampler's) from the same
    generator seed, twice: the same state, image and mse (the port's
    counterpart of JAX's determinism test)."""
    (r0, _), _ = port_runs
    a, b = r0["seeded"], r0["seeded_again"]
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
    assert np.isfinite(float(a[2])) and a[1].isfinite().all()


# -- the banded renders -----------------------------------------------------

@pytest.mark.parametrize("world_size", [1, 2])
@pytest.mark.parametrize("case", ["banded", "packed"])
def test_dp_banded_renders_equal_render_banded(world, port_runs, mesh1,
                                               world_size, case):
    """dp_render_banded and dp_render_banded_packed at world sizes 1 and 2
    equal the port's render_banded fed the same per-band draws (band g's
    entry is the global band's, so the image does not depend on the world
    size)."""
    dens, env, scenes = world
    _, _, _, st = scenes["collision"]
    tcfg = port_cfg(scenes["collision"][0])
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    tstate = tnrc.state_from_numpy(st, "cpu")
    name, fn, cfg, kw = next(c for c in banded_cases(ts, tcfg)
                             if c[0] == case)
    ref = ttiled.render_banded(tstate, ts, None, cfg, **kw).numpy()
    if world_size == 1:
        out = getattr(tdp, fn)(tstate, ts, None, cfg, mesh1, **kw).numpy()
        np.testing.assert_array_equal(out, ref)
    else:
        out = port_runs[0][0][name].numpy()
    assert out.shape == (16, 16, 3) and np.isfinite(out).all()
    assert ref.mean() > 0.0
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_frame_live_pack_multiple_of_matches_jax(world):
    """frame_live_pack(multiple_of=2) against JAX's, and a prefix of the
    multiple_of=1 pack plus one padding band."""
    dens, env, _ = world
    cfg = packed_cfg()
    tcfg = port_cfg(cfg)
    js = compile_o0(lambda d, e: jscene.make_scene(cfg, d, e),
                    dens, env)(dens, env)
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    ref = compile_o0(lambda sc: jtiled.frame_live_pack(sc, cfg, 1, N_DEV),
                     js)(js)
    out = ttiled.frame_live_pack(ts, tcfg, 1, multiple_of=N_DEV)
    for name, a, b in zip(ttiled.LivePack._fields, ref, out):
        assert tuple(b.shape) == a.shape, name
        if name in ("sel", "val", "inv"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    one = ttiled.frame_live_pack(ts, tcfg, 1)
    assert int(out.val.sum()) == int(one.val.sum()) == 169
    assert one.ro_p.shape[0] == 11 and out.ro_p.shape[0] == 12
    k = one.sel.shape[0]
    for a, b in zip(one, out):
        if a.shape[0] == k:  # per packed slot
            assert torch.equal(b[:k], a)
        elif a.dim() > 1:    # per packed band
            assert torch.equal(b[:one.ro_p.shape[0]], a)
    assert not out.val[k:].any()
    # the same slot of every packed ray; the sentinel is each pack's size
    assert torch.equal(out.inv, torch.where(one.inv == k, out.sel.shape[0],
                                            one.inv))


# -- the per-shard cap probe ------------------------------------------------

def test_probe_dp_caps_matches_jax_tight_and_drop_free(probe, port_runs):
    """probe_dp_caps on the skewed scene: the report and caps equal JAX's;
    the worst-shard caps are tighter than the defaults yet drop-free on two
    ranks (the same image as the default caps), while the frame-mean cap
    drops events on the skewed shard."""
    cfg, cfg_j, rep_j, cfg_t, rep_t = probe
    for f in ("query_frac", "event_mean", "live_frac"):
        np.testing.assert_allclose(getattr(rep_t, f), getattr(rep_j, f),
                                   rtol=0, atol=1e-6, err_msg=f)
    assert rep_t.query_cap == rep_j.query_cap == \
        cfg_t.render.query_cap_fraction == cfg_j.render.query_cap_fraction
    assert rep_t.shade_cap == rep_j.shade_cap == \
        cfg_t.render.shade_cap_fraction == cfg_j.render.shade_cap_fraction
    assert rep_t.query_frac.shape == (N_DEV,)
    assert rep_t.event_mean.max() > 1.5 * max(rep_t.event_mean.mean(), 1e-9)
    assert cfg_t.render.shade_cap_fraction < cfg.render.shade_cap_fraction
    (r0, _), mean_cap = port_runs
    free, tight = r0["probe_free"].numpy(), r0["probe_tight"].numpy()
    assert np.isfinite(free).all() and free.mean() > 0.0
    np.testing.assert_allclose(tight, free, rtol=1e-6, atol=1e-7)
    assert mean_cap < rep_t.event_mean.max()
    assert float(np.abs(r0["probe_mean"].numpy() - free).max()) > 0.0


# -- the CLI --------------------------------------------------------------

CLI_RANK = textwrap.dedent("""
    import dataclasses, os, sys
    import numpy as np
    from neuralradiancecaching_tpu_torch import cli, config as C
    from neuralradiancecaching_tpu_torch.io import assets
    R = dataclasses.replace
    GRID = (16, 12, 20)
    for name in ("nrc_online_config", "progressive_1080p_config"):
        full = getattr(C, name)
        setattr(C, name, lambda *a, full=full, **k: R(
            full(*a, **k),
            path=R(full(*a, **k).path, collision_field_steps=8),
            volume=R(full(*a, **k).volume, grid_shape=GRID,
                     field_shape=(6, 5, 8), field_dir_buckets=(8, 16)),
            env_map=R(full(*a, **k).env_map, scatter_quad_dirs=(8, 16)),
            train=R(full(*a, **k).train, train_width=16, train_height=16,
                    target_bounces=16)))
    dens = np.random.default_rng(0).random(GRID, dtype=np.float32) * 0.5
    assets.load_cloud = lambda path=None: dens
    assets.load_env_map = lambda path=None: assets.synthesize_sky(32, 64)
    cli._band_rows = lambda w, h, n_dev=1: 8 // n_dev
    out, store = sys.argv[1], os.environ["NRC_DIST_STORE"]
    common = ["--width", "32", "--height", "32", "--mesh", "2"]
    cli.main(["--device", "cpu", "nrc-online", "--frames", "2", *common,
              "--out", out + "/online", "--metrics", out + "/online.jsonl",
              "--checkpoint", out + "/ck"])
    os.environ["NRC_DIST_STORE"] = store + ".progressive"
    cli.main(["--device", "cpu", "progressive", "--frames", "2",
              "--probe-caps", "auto", *common, "--out", out + "/prog",
              "--metrics", out + "/prog.jsonl"])
    bad = [m for m in sys.modules if m.split(".")[0].startswith("jax")
           or m.split(".")[0] == "neuralradiancecaching_tpu"]
    assert not bad, bad
""")


def test_cli_mesh_two_ranks_on_cpu(tmp_path):
    """``nrc-online --mesh 2`` (banded: dp_train_banded_frame) and
    ``progressive --mesh 2 --probe-caps auto`` (the probe, the packed DP
    frame) as two gloo ranks on a reduced preset: only rank 0 writes, the
    images are finite, the metrics rows and the checkpoint exist."""
    from neuralradiancecaching_tpu_torch.io import exr
    outs = tpar.spawn(["-c", CLI_RANK, str(tmp_path)], N_DEV,
                      tmp_path / "group",
                      env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
                      timeout=300)
    assert "probe-caps: query_cap=" in outs[0]
    assert outs[1].strip() == ""  # rank 1 prints nothing
    for sub, name in (("online", "nrc_online"), ("prog", "progressive")):
        img = exr.read_exr(str(tmp_path / sub / f"{name}.exr"))
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
        assert img.mean() > 0.0
        rows = [json.loads(x) for x in open(tmp_path / f"{sub}.jsonl")]
        assert rows and all(np.isfinite(r["mse"]) for r in rows)
    assert len([x for x in open(tmp_path / "online.jsonl")]) == 2
    assert (tmp_path / "ck").exists() or (tmp_path / "ck.npz").exists()


def test_cli_mesh_size_must_match_world_size(monkeypatch, capsys):
    """--mesh 3 under a launcher of 2 ranks exits 2 before any work."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as exc:
        tcli.main(["--device", "cpu", "nrc-online", "--mesh", "3",
                   "--width", "16", "--height", "16"])
    assert exc.value.code == 2
    assert "--mesh 3" in capsys.readouterr().err


def test_band_rows_mesh_divisor_matches_jax():
    from neuralradiancecaching_tpu import cli as jcli
    for n_dev in (1, 2, 4, 8):
        for w, h in [(800, 800), (1920, 1080), (512, 512), (1000, 999)]:
            assert tcli._band_rows(w, h, n_dev) == jcli._band_rows(w, h,
                                                                   n_dev)
    assert tcli._band_rows(1920, 1080, 8) == 27
    assert tcli._band_rows(800, 800, 8) == 25


def test_make_mesh_rejects_a_wrong_size():
    with pytest.raises(ValueError, match="needs 3 ranks"):
        tpar.make_mesh(3, "cpu")


def test_dp_checks_keep_jax_messages(world, mesh1):
    """The divisibility checks raise with the JAX package's messages."""
    dens, env, scenes = world
    tcfg = port_cfg(scenes["collision"][0])
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    st = tnrc.state_from_numpy(scenes["collision"][3], "cpu")
    with pytest.raises(ValueError, match="must divide into 1 devices x "
                                         "5-row bands"):
        tdp.dp_render_banded(st, ts, torch.Generator(), tcfg, mesh1,
                             band_rows=5)
    with pytest.raises(ValueError, match="NN path"):
        tdp.dp_render_banded(st, ts, torch.Generator(),
                             R(tcfg, render=R(tcfg.render, use_nn=False)),
                             mesh1, band_rows=2)
