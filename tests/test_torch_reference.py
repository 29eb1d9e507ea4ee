"""The port's reference sampler against the JAX package: the sequential
march of nrc-forward.frag (``trace_path`` with ``sampler='reference'``: the
K-slot march, the two-phase march, the compacted and the dense per-slot
shade, the cumprod throughput and the cut weight), the render pass
(``render_image``: the miss / see-through composite, spp > 1, the capped
cache query), the train targets (``choose_train_vertices``,
``trace_target_paths`` dense and packed by a stable sort, the batch), the
delta sampler's train batch, config 3's render as it ships, and three
whole ``frame_step``s of config 4 as it ships -- both presets cut only in
scale (grid, fields, image, train grid, walk lengths).

Every draw comes from the JAX package's own keys (the helpers of
tests/test_torch_oracle.py and tests/test_torch_train.py rebuild them);
the jitted JAX references are compiled with XLA:CPU's LLVM backend at -O0
(see tests/test_torch_render.py).

Tolerances, each with its reason:
- walks, targets and images per lane or pixel: a one-ulp difference in a
  transcendental can flip a density test, a bucket or a texel and change
  that lane wholesale, so >= 99% of lanes (99.5% of pixels) within
  1e-4 + 1e-3 |ref| and the mean within 1e-4 relative;
- the three frames: the mse trajectory within 1e-3 relative, the last
  image under the pixel bound, MLP parameters within 1e-6 + 1e-5 |ref|
  (three Adam steps on gradients summed in another order: one entry in
  4096 measured 1.1e-6 off at 7.8e-6 relative), >= 99.9% of hash entries
  within 1e-6 and every other within 2 lr (Adam's eps turns a
  rounding-level gradient of either sign into a step of +-lr,
  tests/test_torch_train.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.render import pathtrace as jpt
from neuralradiancecaching_tpu.render import targets as jtargets
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.render import targets as ttargets
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from tests.test_torch_oracle import (jax_path_uniforms, jax_scene_uniforms,
                                     lanes_close, o0, port_cfg, to_t)
from tests.test_torch_train import jax_train_uniforms

R = dataclasses.replace
LANE_FRAC_OK, PIXEL_FRAC_OK, REL_MEAN = 0.99, 0.995, 1e-4
W = H = 32
WALK_SIDE = 48  # 2304 lanes: the two-phase march's 1024-lane cap shrinks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cut(cfg, side=W):
    """A preset cut only in scale: image, grid and fields, 8 bounces, a
    16x16 train grid of 16-step target walks."""
    return R(cfg,
             camera=R(cfg.camera, aspect=1.0),
             render=R(cfg.render, width=side, height=side),
             path=R(cfg.path, max_bounces=8, collision_field_steps=8),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


def config4(side=W):
    """nrc_online_config as it ships (sampler 'reference'), cut in scale."""
    return cut(jcfg_mod.nrc_online_config(side, side), side)


def config3(side=W):
    """pathtrace_config as it ships (reference sampler, cache off)."""
    return cut(jcfg_mod.pathtrace_config(side, side), side)


@pytest.fixture(scope="module")
def setup():
    cfg = config4()
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = jassets.synthesize_sky(32, 64)
    js = o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)(dens, env)
    ts = tscene.make_scene(port_cfg(cfg), dens, env, device="cpu")
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    # O(1) MLP weights so the cache term is visible in the image (the 0.01
    # init makes it ~1e-8): the same numpy weights into both packages
    p_rng = np.random.default_rng(1)
    params = {k: (p_rng.standard_normal(v.shape) * (0.25 if k[0] == "w"
                                                    else 0.05))
              .astype(np.float32) for k, v in jstate.mlp_params.items()}
    jstate = jstate._replace(mlp_params={k: jax.numpy.asarray(v)
                                         for k, v in params.items()})
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    return cfg, js, ts, jstate, tstate


def per_lane_all(ref, out):
    ok = np.ones(np.asarray(ref[0]).shape[0], bool)
    for a, b in zip(ref, out):
        lane_ok, _ = lanes_close(b.numpy(), np.asarray(a))
        ok &= lane_ok
    return ok.mean()


# -- 8. the reference march and shade ----------------------------------------

MARCH_CASES = {
    # config 4: RR cuts, two-phase march, compacted shade, field modes
    "nn_two_phase_compacted": dict(use_nn=True),
    "nn_dense_quirk": dict(use_nn=True, compact_events=0.0, quirk=True),
    # config 3: no RR, every slot shaded dense
    "nonn_dense": dict(use_nn=False),
    # the per-slot shade keys: MC in-scatter, quadrature transmittance
    "nonn_dense_mc_quadrature": dict(use_nn=False, mc=True),
    "nn_compacted_mc_ratio": dict(use_nn=True, mc=True, ratio=True),
}


def march_cfg(case):
    c = MARCH_CASES[case]
    cfg = config4(WALK_SIDE)
    cfg = R(cfg, path=R(cfg.path,
                        compact_events=c.get("compact_events", 2.6),
                        transmittance_mode=("quadrature" if c.get("mc")
                                            and not c.get("ratio")
                                            else "field"),
                        transmittance_steps=8, ratio_tracking_steps=32),
            quirks=R(cfg.quirks, query_dir_phase=c.get("quirk", False)))
    if c.get("mc"):
        cfg = R(cfg, env_map=R(cfg.env_map, in_scatter_mode="mc",
                               n_samples=2, transmittance_steps=8,
                               transmittance_mode=("ratio" if c.get("ratio")
                                                   else "quadrature")))
    return cfg


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_reference_trace_path_matches_jax(setup, case):
    """trace_path per lane from the JAX walk's own draws: the shade sum,
    the final throughput, the RR cut and its weight."""
    _, js, ts, _, _ = setup
    cfg = march_cfg(case)
    tcfg = port_cfg(cfg)
    use_nn = MARCH_CASES[case]["use_nn"]
    n = WALK_SIDE * WALK_SIDE
    jro, jrd = jcam.pixel_rays(js.camera, WALK_SIDE, WALK_SIDE)
    tro, trd = tcam.pixel_rays(ts.camera, WALK_SIDE, WALK_SIDE)
    walk_shapes, rows = tpt.path_uniform_shapes(tcfg, n, use_nn)
    if use_nn and cfg.path.transmittance_mode == "field":
        assert walk_shapes == [(6, 4, n), (2, 4, 1024)]  # two-phase march
    else:
        assert walk_shapes == [(8, 4, n)]
    assert len(rows) == (0 if not MARCH_CASES[case].get("mc")
                         else 1 if use_nn else 8)
    key = jax.random.PRNGKey(40)
    ref = o0(lambda sc, o, d: jpt.trace_path(sc, cfg, o, d, key,
                                             use_nn=use_nn),
             js, jro, jrd)(js, jro, jrd)
    out = tpt.trace_path(ts, tcfg, tro, trd, None, use_nn=use_nn,
                         uniforms=jax_path_uniforms(cfg, key, n, use_nn))
    frac = per_lane_all(ref, out)
    assert frac >= LANE_FRAC_OK, frac
    _, rel = lanes_close(out.scattered.numpy(), np.asarray(ref.scattered))
    assert rel <= REL_MEAN and float(out.scattered.mean()) > 0.0
    if use_nn:
        assert float((out.query_weight > 0).float().mean()) > 0.05


# -- 9. the render pass --------------------------------------------------------

def jax_render_uniforms(cfg, key, n, use_nn):
    """render_image's draws: spp 1 walks with the key itself, spp > 1 with
    split(key, spp) (pathtrace.py:1163-1169)."""
    if cfg.render.spp == 1:
        return jax_path_uniforms(cfg, key, n, use_nn)
    return [jax_path_uniforms(cfg, k, n, use_nn)
            for k in jax.random.split(key, cfg.render.spp)]


RENDER_CASES = {
    "config3": dict(preset=config3),
    "config3_spp2": dict(preset=config3, spp=2),
    "config4": dict(preset=config4),
    "config4_capped_spp2": dict(preset=config4, spp=2, cap=0.375),
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_only_step_matches_jax(setup, case):
    """The whole render of config 3 (cache off: the port neither bakes nor
    queries) and config 4 (the cache query uncapped, and capped at the
    bench's 0.375 with spp 2) pixel for pixel."""
    _, js, ts, jstate, tstate = setup
    c = RENDER_CASES[case]
    cfg = c["preset"]()
    cfg = R(cfg, render=R(cfg.render, spp=c.get("spp", 1),
                          query_cap_fraction=c.get("cap", 1.0)))
    key = jax.random.PRNGKey(50)
    ref = np.asarray(o0(lambda s, sc, k: jframe.render_only_step(s, sc, k,
                                                                 cfg),
                        jstate, js, key)(jstate, js, key))
    use_nn = cfg.render.use_nn
    u = jax_render_uniforms(cfg, key, W * H, use_nn)
    out = tframe.render_only_step(tstate, ts, None, port_cfg(cfg),
                                  uniforms=u).numpy()
    assert out.shape == ref.shape == (H, W, 3)
    ok, rel = lanes_close(out.reshape(-1, 3), ref.reshape(-1, 3))
    assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)


def test_cache_off_render_skips_the_bake(setup, monkeypatch):
    """render_only_step without the cache runs neither nrc.bake nor the
    query (the JAX program drops them as dead code)."""
    _, _, ts, _, tstate = setup

    def no_bake(*args, **kw):
        raise AssertionError("baked without the cache")
    monkeypatch.setattr(tnrc, "bake", no_bake)
    img = tframe.render_only_step(tstate, ts, torch.Generator().manual_seed(0),
                                  port_cfg(config3()))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    with pytest.raises(AssertionError, match="baked"):
        tframe.render_only_step(tstate, ts, torch.Generator(),
                                port_cfg(config4()))


def test_render_image_spp_uniforms_rejected(setup):
    _, _, ts, _, _ = setup
    tcfg = port_cfg(config3())
    tcfg = R(tcfg, render=R(tcfg.render, spp=2))
    ro, rd = tcam.pixel_rays(ts.camera, 4, 4)
    with pytest.raises(ValueError, match="spp=2"):
        tpt.render_image(ts, tcfg, ro, rd, None, uniforms=[None])


# -- 10. the train targets ------------------------------------------------------

def jax_reference_train_uniforms(key, cfg):
    """The draws of the JAX generate_train_batch(key) with the reference
    sampler (targets.py:298-367): the one jittered grid fold_in(k_j, 0),
    the vertex walk uniform(k_v), the target walk fold_in(k_t, 0) and its
    shade fold_in(k_t, 1)."""
    k_j, key = jax.random.split(key)
    tw, th = cfg.train.train_width, cfg.train.train_height
    n = tw * th
    n_t = cfg.train.target_samples * n
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(k_j, 0),
                                           (2, th, tw)))[None]
    k_v, k_t = jax.random.split(key)
    steps = min(cfg.train.vertex_walk_steps or cfg.train.target_bounces,
                cfg.train.target_bounces)
    rows = ttargets.train_shade_rows(port_cfg(cfg))
    return ttargets.TrainUniforms(
        jitter=to_t(jitter),
        vertex=[to_t(jax.random.uniform(k_v, (steps, 4, n)))],
        perm=None, hg=None,
        target=[to_t(jax.random.uniform(jax.random.fold_in(k_t, 0),
                                        (cfg.train.target_bounces, 4,
                                         n_t)))],
        shade=[jax_scene_uniforms(cfg, jax.random.fold_in(k_t, 1), r,
                                  cfg.train.env_samples) for r in rows])


def test_choose_train_vertices_matches_jax(setup):
    cfg, js, ts, _, _ = setup
    jro, jrd = jcam.pixel_rays(js.camera, WALK_SIDE, WALK_SIDE)
    tro, trd = tcam.pixel_rays(ts.camera, WALK_SIDE, WALK_SIDE)
    key = jax.random.PRNGKey(60)
    ref = o0(lambda sc, o, d: jtargets.choose_train_vertices(sc, cfg, o, d,
                                                             key),
             js, jro, jrd)(js, jro, jrd)
    u = to_t(jax.random.uniform(key, (16, 4, WALK_SIDE * WALK_SIDE)))
    out = ttargets.choose_train_vertices(ts, port_cfg(cfg), tro, trd, u)
    assert per_lane_all(ref, out) >= LANE_FRAC_OK


@pytest.mark.parametrize("compact,mc", [(0.0, False), (6.0, False),
                                        (6.0, True)])
def test_trace_target_paths_matches_jax(setup, compact, mc):
    """The 16-step target walk from interior vertices: dense, and packed
    under train.compact_events by the stable sort (6 events per lane: the
    sort really drops the deepest events), with 'mc' in-scatter draws."""
    cfg, js, ts, _, _ = setup
    cfg = R(cfg, train=R(cfg.train, compact_events=compact))
    if mc:
        cfg = R(cfg, env_map=R(cfg.env_map, in_scatter_mode="mc",
                               n_samples=2))
    tcfg = port_cfg(cfg)
    n = 2048
    rng = np.random.default_rng(7)
    pos = ((rng.random((n, 3)) - 0.5) * 0.9
           * np.asarray(cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(61)
    ref = np.asarray(o0(lambda sc, p, dd: jtargets.trace_target_paths(
        sc, cfg, p, dd, key), js, pos, d)(js, pos, d))
    steps = cfg.train.target_bounces
    cap = ttargets._target_cap(tcfg, n)
    assert cap == (steps * n if not compact else 6 * n)
    shade = jax_scene_uniforms(cfg, jax.random.fold_in(key, 1), cap,
                               cfg.train.env_samples)
    assert (shade is None) != mc
    out = ttargets.trace_target_paths(
        ts, tcfg, torch.tensor(pos), torch.tensor(d),
        to_t(jax.random.uniform(jax.random.fold_in(key, 0), (steps, 4, n))),
        shade).numpy()
    ok, rel = lanes_close(out, ref)
    assert ok.mean() >= LANE_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)
    assert ref.mean() > 0.0


@pytest.mark.parametrize("sampler", ["reference", "delta"])
def test_generate_train_batch_matches_jax(setup, sampler):
    """The whole train batch: reference (vertex walk + target walks) and
    delta (the collision batch's RR cuts and targets at the delta walk's
    row width)."""
    cfg, js, ts, _, _ = setup
    cfg = R(cfg, path=R(cfg.path, sampler=sampler, delta_null_steps=8),
            train=R(cfg.train, vertex_oversample=2))
    tcfg = port_cfg(cfg)
    key = jax.random.PRNGKey(62)
    ref = o0(lambda sc, k: jtargets.generate_train_batch(sc, cfg, k),
             js, key)(js, key)
    if sampler == "reference":
        u = jax_reference_train_uniforms(key, cfg)
    else:
        u = jax_train_uniforms(key, cfg, tcfg)
        assert u.vertex[0].shape[1] == 4 + 2 * 8
    out = ttargets.generate_train_batch(ts, tcfg, None, u)
    assert out.pos.shape[0] == 256
    assert per_lane_all(ref, out) >= LANE_FRAC_OK
    _, rel = lanes_close(out.target.numpy(), np.asarray(ref.target))
    assert rel <= REL_MEAN and float(out.target.mean()) > 0.0


def test_draw_train_uniforms_reference_shapes():
    cfg = port_cfg(R(config4(), env_map=R(config4().env_map,
                                          in_scatter_mode="mc")))
    u = ttargets.draw_train_uniforms(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
    n = 16 * 16
    assert u.jitter.shape == (1, 2, 16, 16)
    assert [tuple(v.shape) for v in u.vertex] == [(16, 4, n)]
    assert [tuple(v.shape) for v in u.target] == [(16, 4, 8 * n)]
    assert u.perm is None and u.hg is None
    assert len(u.shade) == 1 and u.shade[0].env_hg.shape == (8, 2, 16 * 8 * n)


# -- 11. three online frames of config 4 as it ships ----------------------------

def test_config4_frame_steps_match_jax(setup):
    """Three frame_steps of nrc_online_config (reference sampler) from one
    state, the JAX jitted frame and the port fed the same train and render
    draws."""
    cfg, js, ts, jstate, tstate = setup
    tcfg = port_cfg(cfg)
    assert cfg.path.sampler == "reference"
    keys = [jax.random.PRNGKey(70 + i) for i in range(3)]
    step = o0(lambda s, sc, k: jframe.frame_step(s, sc, k, cfg), jstate, js,
              keys[0])
    ref_mse, out_mse = [], []
    for key in keys:
        jstate, ref = step(jstate, js, key)
        k_train, k_render = jax.random.split(key)
        tstate, out = tframe.frame_step(
            tstate, ts, None, tcfg,
            train_uniforms=jax_reference_train_uniforms(k_train, cfg),
            uniforms=jax_path_uniforms(cfg, k_render, W * H, use_nn=True))
        ref_mse.append(float(ref.mse))
        out_mse.append(float(out.mse))
    np.testing.assert_allclose(out_mse, ref_mse, rtol=1e-3)
    img, ref_img = out.image.numpy(), np.asarray(ref.image)
    ok, rel = lanes_close(img.reshape(-1, 3), ref_img.reshape(-1, 3))
    assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)
    for k in tstate.mlp_params:
        np.testing.assert_allclose(tstate.mlp_params[k].numpy(),
                                   np.asarray(jstate.mlp_params[k]),
                                   rtol=1e-5, atol=1e-6)
    diff = np.abs(tstate.hash_table.numpy() - np.asarray(jstate.hash_table))
    assert (diff <= 1e-6).mean() >= 0.999
    assert diff.max() <= 2 * cfg.mrhe.learning_rate * 1.0001
    assert int(tstate.opt_step) == 3
