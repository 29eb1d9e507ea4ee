"""The port's production frame of config 5 against the JAX package: the
live-ray pack and the other pose-static hoists, the collect-mode walk, the
frame-global deferred shade and cache query, and the slice as a whole --
``train_only_step``, then ``bake``, then ``render_banded`` over the hoisted
``env_rgb`` / ``baked`` / ``pack`` -- from one state, the same numpy scene
and the JAX package's own random draws (the JAX walk of band i draws
``uniform(fold_in(fold_in(key, i), 0), (k, 4, band_n))``; the train batch
through tests/test_torch_train.py:jax_train_uniforms).

The JAX side is compiled by XLA:CPU's LLVM backend at -O0 (see
tests/test_torch_render.py). Bounds, each with its reason:
- ``inverse_select`` / ``gather_back`` and the pack's ``sel`` / ``val`` /
  ``inv``: bit for bit (integer cumsums and scatters);
- the packed rays, the entry tau and the env colour: rtol 1e-5 / atol 1e-5
  (f32 transcendentals and a 64-step quadrature in another order);
- the collect-mode walk, f32 or bf16 fields: per ray, every output within
  1e-4 + 1e-3 |ref| on >= 99% of rays, as the render test's walk check (a
  one-ulp difference can flip a field bucket and the ray diverges
  wholesale; measured: all rays). bf16 events are the same f32 values
  rounded once on both sides;
- ``shade_and_query`` on the same events and queries: every pixel within
  1e-4 + 1e-3 |ref| (the same rows, field lookups and MLP; only fp sum
  orders differ, ``index_add_`` against XLA's segmented scan);
- the slice at f32: >= 99.5% of pixels within 1e-4 + 1e-3 |ref| and the
  image mean within 1e-4 relative, the render test's bound (measured: all
  pixels, mean 8e-8). With bf16 fields and the bf16 query: >= 99% of
  pixels within 1e-3 + 1e-3 |ref|, all within 1e-2 + 1e-2 |ref|, the mean
  within 1e-4 relative -- torch rounds the query's bf16 encode at other
  places than XLA:CPU (a few bf16 ulps, tests/test_torch_bf16.py), and
  the cache term carries them (measured: 99.7%, all, 1.8e-6). The train
  step's mse within 1e-3 relative in both (measured <= 6e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as cfg_mod
from neuralradiancecaching_tpu.io import assets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.ops import compact as jcompact
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.render import pathtrace as jpt
from neuralradiancecaching_tpu.render import tiled as jtiled
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import compact as tcompact
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import pathtrace as tpt
from neuralradiancecaching_tpu_torch.render import tiled as ttiled
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import profiling
from tests.test_torch_train import jax_train_uniforms

R = dataclasses.replace
W, H, BAND = 32, 30, 6


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
    """``jax.jit(fn)(*args)`` compiled by XLA:CPU's LLVM backend at -O0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def frame_cfg(field_dtype="float32", w=W, h=H):
    """Config 5 with the JAX bench's production settings (bench.py:86-293:
    live-tau 0.005, slot-0-dense shade, the bf16 query, the uncapped
    packed query) and the fused query MLP, cut to test size: a w x h
    frame, the render tests' scene grid, a 16x16 train grid of 16-slot
    target walks. f32 fields and query for lane-level parity, or config
    5's own bf16 ones."""
    cfg = cfg_mod.progressive_1080p_config()
    bf16 = field_dtype == "bfloat16"
    return R(cfg,
             camera=R(cfg.camera, aspect=w / h),
             render=R(cfg.render, width=w, height=h,
                      live_tau_threshold=0.005, shade_slot0_dense=True,
                      live_pack_fraction=0.75, query_cap_fraction=1.0,
                      shade_cap_fraction=1.0),
             path=R(cfg.path, collision_field_steps=8),
             mlp=R(cfg.mlp, fused_inference=True,
                   inference_dtype="bfloat16" if bf16 else "float32"),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8), field_dtype=field_dtype,
                      field_dir_buckets=(8, 16)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


def cloud(cfg) -> np.ndarray:
    """A seeded random ball of density: rays miss the box, graze it below
    the live threshold, or cross it."""
    g = cfg.volume.grid_shape
    rng = np.random.default_rng(0)
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in g]
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(*axes, indexing="ij")))
    return (rng.random(g, dtype=np.float32) * 0.6 * (r < 0.4)).astype(
        np.float32)


POSE = jcam.orbit_position(1, 8, radius=150.0)


def build(cfg, pose=POSE):
    """(js, ts, jstate, tstate) for cfg: both scenes from the same numpy
    density and env map with the camera at ``pose``, and the JAX init
    state with O(1) MLP weights (the 0.01 init makes the cache term
    ~1e-8) in both packages."""
    dens, env = cloud(cfg), assets.synthesize_sky(32, 64)
    js = jax_o0(lambda d, e: jscene.make_scene(cfg, d, e), dens, env)
    js = js._replace(camera=jcam.make_camera(cfg.camera, *pose))
    ts = tscene.make_scene(port_cfg(cfg), torch.tensor(dens),
                           torch.tensor(env))
    ts = dataclasses.replace(ts, camera=tcam.make_camera(
        port_cfg(cfg.camera), "cpu", *pose))
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    params = {k: (rng.standard_normal(v.shape) * (0.25 if k[0] == "w"
                                                  else 0.05))
              .astype(np.float32) for k, v in jstate.mlp_params.items()}
    jstate = jstate._replace(
        mlp_params={k: jnp.asarray(v) for k, v in params.items()})
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    return js, ts, jstate, tstate


@pytest.fixture(scope="module")
def f32():
    cfg = frame_cfg()
    return (cfg, *build(cfg))


def to_t(x) -> torch.Tensor:
    """A JAX array as a torch tensor (bf16 through its bits)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_np(x) -> np.ndarray:
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def band_uniforms(key, cfg, n_bands, band_n, fold):
    """The JAX band walks' uniforms, one (k, 4, band_n) block per band:
    band i's key is fold_in(key, fold(i))."""
    k_steps = min(cfg.path.coll_max_events, cfg.path.max_bounces)
    return [torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, fold(i)), 0),
        (k_steps, 4, band_n)))) for i in range(n_bands)]


def close_rows(out, ref, atol=1e-4, rtol=1e-3):
    """Per row (leading axis): every value within atol + rtol |ref|."""
    out = np.asarray(out, np.float32).reshape(len(out), -1)
    ref = np.asarray(ref, np.float32).reshape(len(ref), -1)
    return np.all(np.abs(out - ref) <= atol + rtol * np.abs(ref), axis=1)


# -- compaction ------------------------------------------------------------

@pytest.mark.parametrize("seed,cap,p", [(1, 64, 0.4), (3, 16, 0.9),
                                        (4, 48, 0.05)])
def test_inverse_select_gather_back_match_jax(seed, cap, p):
    """Bit for bit, overflow (count > cap) and padding (count < cap)
    included, as tests/test_compact.py:test_gather_back_matches_scatter_
    back holds the JAX pair to scatter_back."""
    mask = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (100,))
                      < p)
    vals = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 10),
                                        (100, 4)))
    jsel, jval = jcompact.compact_select(jnp.asarray(mask), cap)
    packed = np.asarray(vals)[np.asarray(jsel)]
    jinv = jcompact.inverse_select(100, jsel, jval)
    ref = np.asarray(jcompact.gather_back(jinv, jnp.asarray(packed), -2.0))
    tsel, tval = tcompact.compact_select(torch.tensor(mask), cap)
    tinv = tcompact.inverse_select(100, tsel, tval)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    out = tcompact.gather_back(tinv, torch.tensor(packed), -2.0).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, tcompact.scatter_back(
        100, tsel, tval, torch.tensor(packed), -2.0).numpy())


def test_gather_back_fill_row_matches_jax():
    """The per-channel fill row of the fused rgb + trans un-pack."""
    mask = np.array([False, True, False, True])
    fill = [0.0, 0.0, 0.0, 1.0]
    jsel, jval = jcompact.compact_select(jnp.asarray(mask), 2)
    ref = jcompact.gather_back(jcompact.inverse_select(4, jsel, jval),
                               jnp.full((2, 4), 7.0), jnp.asarray(fill))
    tsel, tval = tcompact.compact_select(torch.tensor(mask), 2)
    out = tcompact.gather_back(tcompact.inverse_select(4, tsel, tval),
                               torch.full((2, 4), 7.0), fill)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- pose-static hoists ----------------------------------------------------

def test_frame_env_color_and_entry_tau_match_jax(f32):
    cfg, js, ts, _, _ = f32
    tc = port_cfg(cfg)
    for jfn, tfn in ((jtiled.frame_env_color, ttiled.frame_env_color),
                     (jtiled.frame_entry_tau, ttiled.frame_entry_tau)):
        ref = np.asarray(jax_o0(lambda sc: jfn(sc, cfg), js))
        out = tfn(ts, tc).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    off = R(tc, path=R(tc.path, entry_tau_steps=0))
    assert not ttiled.frame_entry_tau(ts, off).any()


@pytest.mark.parametrize("threshold,pack_frac", [
    (0.005, 0.75),   # the bench's threshold; the pack covers every ray
    (1e-4, 0.75),    # the conservative mask (tests/test_collision.py:940)
    (0.005, 0.2),    # a pack smaller than the live count: rays drop
    (1e6, 0.75),     # nothing live: all padding, every ray pure env
])
def test_live_fraction_and_pack_match_jax(f32, threshold, pack_frac):
    cfg, js, ts, _, _ = f32
    cfg = R(cfg, render=R(cfg.render, live_tau_threshold=threshold,
                          live_pack_fraction=pack_frac))
    tc = port_cfg(cfg)
    frac = ttiled.live_fraction(ts, tc)
    # the same mask (sel / val below); JAX's f32 mean rounds the fraction
    ref_frac = float(jax_o0(lambda sc: jtiled._live_mask_mean(sc, cfg), js))
    assert abs(frac - ref_frac) <= 1e-7, (frac, ref_frac)
    if threshold == 1e6:
        assert frac == 0.0
    else:
        assert 0.1 < frac < 0.9  # some rays miss or graze, some live
    ref = jax_o0(lambda sc: jtiled.frame_live_pack(sc, cfg, BAND), js)
    out = ttiled.frame_live_pack(ts, tc, BAND)
    for name, a, b in zip(ttiled.LivePack._fields, ref, out):
        assert tuple(b.shape) == a.shape, name
        if name in ("sel", "val", "inv"):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    assert out.ro_p.shape[0] * out.ro_p.shape[1] % (BAND * W) == 0


# -- the collect-mode walk -------------------------------------------------

def _walk_inputs(cfg, js, ts, key):
    """Pixel rays, their exact entry tau and the walk's uniforms."""
    jro, jrd = jcam.pixel_rays(js.camera, W, H)
    et = jax_o0(lambda sc: jtiled.frame_entry_tau(sc, cfg), js)
    k_steps = min(cfg.path.coll_max_events, cfg.path.max_bounces)
    u = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0),
                                      (k_steps, 4, W * H)))
    tro, trd = tcam.pixel_rays(ts.camera, W, H)
    return jro, jrd, et, tro, trd, torch.tensor(u)


@pytest.mark.parametrize("field_dtype", ["float32", "bfloat16"])
def test_collect_walk_matches_jax(f32, field_dtype):
    if field_dtype == "float32":
        cfg, js, ts, _, _ = f32
    else:
        cfg = frame_cfg("bfloat16")
        js, ts, _, _ = build(cfg)
    key = jax.random.PRNGKey(7)
    jro, jrd, et, tro, trd, u = _walk_inputs(cfg, js, ts, key)
    jres, jev = jax_o0(lambda sc, o, d, e: jpt.trace_path_collision(
        sc, cfg, o, d, key, use_nn=True, collect_events=True, entry_tau=e),
        js, jro, jrd, et)
    tres, tev = tpt.trace_path_collision(
        ts, port_cfg(cfg), tro, trd, None, use_nn=True, uniforms=u,
        collect_events=True, entry_tau=to_t(et))
    k = min(cfg.path.coll_max_events, cfg.path.max_bounces)
    assert tuple(tev.shape) == jev.shape == (W * H, k, 7)
    assert tev.dtype == (torch.bfloat16 if field_dtype == "bfloat16"
                         else torch.float32)
    assert jev.dtype == (jnp.bfloat16 if field_dtype == "bfloat16"
                         else jnp.float32)
    assert not tres.scattered.any()
    ok = close_rows(to_np(tev), jev)
    for a, b in zip(jres[1:], tres[1:]):  # T0, query pos / dir / weight
        ok &= close_rows(b.numpy(), a)
    assert ok.mean() >= 0.99, ok.mean()
    w = to_np(tev)[..., 6]
    assert (w > 0).any() and (tres.query_weight > 0).any()
    # events are prefix-shaped per ray: a done lane never revives
    assert not np.any((w[:, 1:] > 0) & ~(w[:, :-1] > 0))


def test_collect_split_and_spp_raise(f32):
    """The collect walk's march split returns only its p1 phase-1 slots
    (the phase-2 events shade in the walk, into ``scattered``); a band
    height that does not divide the frame raises."""
    cfg, _, ts, _, tstate = f32
    tc = port_cfg(cfg)
    ro, rd = tcam.pixel_rays(ts.camera, W, H)
    split = R(tc, path=R(tc.path, coll_phase1_steps=2))
    res, ev = tpt.trace_path_collision(ts, split, ro, rd,
                                       torch.Generator().manual_seed(0),
                                       use_nn=True, collect_events=True)
    assert tuple(ev.shape) == (W * H, 2, 7)
    assert torch.isfinite(res.scattered).all()
    assert (res.scattered > 0).any()
    with pytest.raises(ValueError):
        ttiled.render_banded(tstate, ts, torch.Generator(), tc, 7)


# -- the frame-global deferred shade and query -----------------------------

@pytest.mark.parametrize("slot0_dense", [True, False])
@pytest.mark.parametrize("capped", [False, True])
def test_shade_and_query_matches_jax(f32, slot0_dense, capped):
    """On the same events and queries (a JAX collect walk over a 64x64
    frame, 4,096 lanes): the shade cap and, when capped, the query cap lie
    above their 1,024-row floors and below the rows on offer, so both packs
    drop rows and the drops must match."""
    cfg, js, ts, jstate, tstate = f32
    w = h = 64
    cfg = R(cfg, camera=R(cfg.camera, aspect=1.0),
            render=R(cfg.render, width=w, height=h,
                     shade_slot0_dense=slot0_dense,
                     shade_cap_fraction=0.3 if slot0_dense else 0.5,
                     query_cap_fraction=0.3 if capped else 1.0,
                     query_chunk=512))
    # a closer camera: the cloud fills more of the frame
    js = js._replace(camera=jcam.make_camera(
        cfg.camera, *jcam.orbit_position(1, 8, radius=50.0)))
    jro, jrd = jcam.pixel_rays(js.camera, w, h)
    n = w * h
    jres, jev = jax_o0(lambda sc, o, d: jpt.trace_path_collision(
        sc, cfg, o, d, jax.random.PRNGKey(3), use_nn=True,
        collect_events=True), js, jro, jrd)
    rgb0 = jnp.asarray(np.random.default_rng(2).random((n, 3)),
                       jnp.float32)
    ref = np.asarray(jax_o0(lambda s, sc, r, qp, qd, qw, ev: jpt.shade_and_query(
        sc, cfg, r, qp, qd, qw, jnrc.make_baked_query_fn(
            s, jnrc.bake(s, cfg), cfg), events=ev),
        jstate, js, rgb0, jres.query_pos, jres.query_dir,
        jres.query_weight, jev))
    tc = port_cfg(cfg)
    qfn = tnrc.make_baked_query_fn(tstate, tnrc.bake(tstate, tc), tc)
    out = tpt.shade_and_query(ts, tc, to_t(rgb0), to_t(jres.query_pos),
                              to_t(jres.query_dir), to_t(jres.query_weight),
                              qfn, events=to_t(jev)).numpy()
    # the caps bind: rows on offer exceed caps above the floors
    ev_w = np.asarray(jev[..., 6]) > 0
    tail = ev_w[:, 1:] if slot0_dense else ev_w
    cap_e = int(n * cfg.render.shade_cap_fraction)
    assert 1024 < cap_e < tail.sum(), (cap_e, tail.sum())
    if capped:
        capq = -(-int(n * 0.3) // 512) * 512
        assert 1024 < capq < (np.asarray(jres.query_weight) > 0).sum()
    assert np.all(close_rows(out, ref))


# -- the slice as a whole --------------------------------------------------

def _jax_frame(cfg, js, jstate, k_train, k_render, packed):
    """JAX: train_only_step, bake, the pose-static hoists, render_banded
    (the single-device banded branch of cli.py with bench.py's hoists)."""
    def run(s, sc):
        s, mse = jframe.train_only_step(s, sc, k_train, cfg)
        baked = jnrc.bake(s, cfg)
        env = jtiled.frame_env_color(sc, cfg)
        pack = jtiled.frame_live_pack(sc, cfg, BAND) if packed else None
        return jtiled.render_banded(s, sc, k_render, cfg, band_rows=BAND,
                                    env_rgb=env, baked=baked,
                                    pack=pack), mse
    img, mse = jax_o0(run, jstate, js)
    return np.asarray(img), float(mse)


@pytest.mark.parametrize("field_dtype,packed", [("float32", True),
                                                ("bfloat16", True),
                                                ("float32", False)])
def test_progressive_frame_matches_jax(f32, field_dtype, packed):
    if field_dtype == "float32":
        cfg, js, ts, jstate, tstate = f32
    else:
        cfg = frame_cfg("bfloat16")
        js, ts, jstate, tstate = build(cfg)
    if not packed:
        cfg = R(cfg, render=R(cfg.render, live_pack_fraction=0.0))
    tc = port_cfg(cfg)
    k_train, k_render = jax.random.split(jax.random.PRNGKey(11))
    ref, ref_mse = _jax_frame(cfg, js, jstate, k_train, k_render, packed)

    state, mse = tframe.train_only_step(
        tstate, ts, None, tc, jax_train_uniforms(k_train, cfg, tc))
    baked = tnrc.bake(state, tc)
    env = ttiled.frame_env_color(ts, tc)
    pack = ttiled.frame_live_pack(ts, tc, BAND) if packed else None
    n_bands = pack.ro_p.shape[0] if packed else H // BAND
    u = band_uniforms(k_render, cfg, n_bands, BAND * W,
                      (lambda i: i) if packed else (lambda i: i * BAND))
    out = ttiled.render_banded(state, ts, None, tc, BAND, env_rgb=env,
                               baked=baked, pack=pack, uniforms=u).numpy()
    assert out.shape == ref.shape == (H, W, 3) and np.isfinite(out).all()
    assert abs(float(mse) - ref_mse) <= 1e-3 * abs(ref_mse)
    out, ref = out.reshape(-1, 3), ref.reshape(-1, 3)
    if field_dtype == "float32":
        ok = close_rows(out, ref)
        assert ok.mean() >= 0.995, ok.mean()
    else:
        ok = close_rows(out, ref, 1e-3, 1e-3)
        assert ok.mean() >= 0.99, ok.mean()
        assert close_rows(out, ref, 1e-2, 1e-2).all()
    rel_mean = abs(out.mean() - ref.mean()) / abs(ref.mean())
    assert rel_mean <= 1e-4, rel_mean


def test_packed_branch_matches_unpacked_when_all_live(f32):
    """An all-live frame packed at fraction 1.0 in one band is the identity
    pack with the same uniforms as the unpacked branch (mirroring
    tests/test_collision.py:test_live_pack_matches_unpacked): the two
    branches give the same image to fp-sum order."""
    cfg, js, ts, _, tstate = f32
    cfg = R(cfg, render=R(cfg.render, live_pack_fraction=1.0,
                          live_tau_threshold=-1.0))
    tc = port_cfg(cfg)
    ts = dataclasses.replace(ts, camera=tcam.make_camera(
        tc.camera, "cpu", *jcam.orbit_position(1, 8, radius=40.0)))
    assert ttiled.live_fraction(ts, tc) == 1.0
    u = [tpt.draw_path_uniforms(tc, W * H, True,
                                torch.Generator().manual_seed(0))]
    packed = ttiled.render_banded(tstate, ts, None, tc, H, uniforms=u)
    unpacked = ttiled.render_banded(
        tstate, ts, None, R(tc, render=R(tc.render, live_pack_fraction=0.0)),
        H, uniforms=u)
    assert torch.isfinite(packed).all()
    torch.testing.assert_close(packed, unpacked, rtol=1e-5, atol=1e-5)


def test_render_banded_on_cpu_takes_plain_mlp_and_no_launch(f32):
    cfg, _, ts, _, tstate = f32
    with profiling.tracing("cpu") as rec, rec.frame(0):
        img = ttiled.render_banded(tstate, ts,
                                   torch.Generator().manual_seed(0),
                                   port_cfg(cfg), BAND)
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    assert not [r for r in rec.records() if r.name == "k1"
                or {"k1_f32_launches", "k1_bf16_launches"} & set(r.counts)]
