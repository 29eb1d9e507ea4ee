"""The port's hash-path MRHE (encode and its backward), its dense bake and
the cache's three inference modes against the JAX package, from the same
numpy inputs.

Tolerances, each with its reason:
- hash indices, dense-baked rows and the bake of every mode bit for bit
  (integer math and gathers);
- the encodes 1e-6 + 1e-6 |ref|: fp32 products of the same factors summed
  over 2^D corners in another order (the world_space_lerp quirk's lerp
  factors reach ~1e2 per axis, so its features are products of order 1e7:
  there the absolute floor is 1e-6 of the largest feature);
- the backward 1e-6 absolute (scaled the same way under the quirk): a
  scatter-add of the same products (measured equal bit for bit on the
  CPU);
- the cache query rtol 1e-5 / atol 2e-6 (fp32 matmuls in another
  summation order; with O(1) weights an output near 0 is the difference
  of O(1) terms, measured 7.9e-7 from JAX's);
- one ``frame_step`` with the dense bake and the hash train encode at the
  train tests' bounds (tests/test_torch_train.py): mse 1e-3 relative,
  MLP parameters 1e-6, hash entries >= 99.9% within 1e-6 and all within
  2 lr, the image's pixels >= 99.5% within 1e-4 + 1e-3 |ref| and its mean
  1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.config import MRHEConfig, QuirkFlags
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.ops import mrhe as jmrhe
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import mrhe as tmrhe
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from tests.test_torch_train import jax_train_uniforms

R = dataclasses.replace
W = H = 16
QUERY_ATOL = 2e-6


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


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _table(cfg, seed=0):
    return np.array(jmrhe.init_table(jax.random.PRNGKey(seed), cfg))


SMALL_3D = MRHEConfig(n_levels=3, min_res=4, max_res=16, table_size=512)
SMALL_2D = MRHEConfig(n_dims=2, n_levels=8, table_size=1024, min_res=2,
                      max_res=64)


# -- the hash ---------------------------------------------------------------

@pytest.mark.parametrize("table_size", [4096, 1000, 12289])
def test_hash_coords_bitwise_wrapping_sums(table_size):
    """Coordinates whose products with the primes wrap uint32, negative
    coordinates, and sums that wrap, for power-of-two and other T."""
    rng = np.random.default_rng(table_size)
    near = rng.integers(2**32 // 83492791 - 4, 2**32 // 83492791 + 64,
                        size=(2048, 3), dtype=np.int64)
    neg = rng.integers(-600, 600, size=(2048, 3), dtype=np.int64)
    big = rng.integers(2**31 - 2**20, 2**31, size=(2048, 3), dtype=np.int64)
    for c in (near, neg, big, np.concatenate([near, neg], -1)[:, :2]):
        ref = np.asarray(jmrhe.hash_coords(jnp.asarray(c.astype(np.int32)),
                                           table_size))
        out = tmrhe.hash_coords(torch.tensor(c), table_size).numpy()
        np.testing.assert_array_equal(out, ref)
        assert out.min() >= 0 and out.max() < table_size


# -- the hash-path encode and its backward ----------------------------------

@pytest.mark.parametrize("cfg", [MRHEConfig(), MRHEConfig(table_size=12289,
                                                          inference_bake=
                                                          "dense"),
                                 SMALL_2D], ids=["3d", "3d_T12289", "2d"])
@pytest.mark.parametrize("quirk", ["none", "world_space_lerp",
                                   "duplicated_feature_grad"])
def test_encode_and_backward_match_jax(cfg, quirk):
    quirks = QuirkFlags(**({} if quirk == "none" else {quirk: True}))
    table = _table(cfg, 1)
    rng = np.random.default_rng(1)
    # in-box positions plus a few outside (negative grid coordinates)
    pos = (rng.random((1024, cfg.n_dims)) * 1.2 - 0.1).astype(np.float32)
    raw = (pos * 40.0).astype(np.float32)
    ref, vjp = jax.vjp(lambda t: jmrhe.encode(
        t, jnp.asarray(pos), cfg, quirks, pos_raw=jnp.asarray(raw)),
        jnp.asarray(table))
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
    ref = np.asarray(ref)

    tt = torch.tensor(table, requires_grad=True)
    out = tmrhe.encode(tt, torch.tensor(pos), port_cfg(cfg),
                       port_cfg(quirks), pos_raw=torch.tensor(raw))
    g = torch.autograd.grad(out, tt, torch.tensor(cot))[0].numpy()
    assert out.shape == (1024, cfg.n_levels * cfg.n_features)
    scale = (max(1.0, float(np.abs(ref).max())) if quirks.world_space_lerp
             else 1.0)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6 * scale)
    g_scale = (max(1.0, float(np.abs(ref_g).max()))
               if quirks.world_space_lerp else 1.0)
    np.testing.assert_allclose(g, ref_g, rtol=0, atol=1e-6 * g_scale)
    if quirks.duplicated_feature_grad:
        np.testing.assert_array_equal(g[..., 0], g[..., 1])


def test_encode_needs_pos_raw_under_the_quirk():
    cfg = port_cfg(SMALL_3D)
    with pytest.raises(ValueError, match="pos_raw"):
        tmrhe.encode(torch.zeros(cfg.n_levels, cfg.table_size, 2),
                     torch.zeros(4, 3), cfg,
                     tcfg_mod.QuirkFlags(world_space_lerp=True))


# -- the dense bake -----------------------------------------------------------

@pytest.mark.parametrize("cfg", [MRHEConfig(), SMALL_3D, SMALL_2D,
                                 MRHEConfig(table_size=1000,
                                            inference_bake="dense")],
                         ids=["config4", "small", "2d", "T1000"])
def test_bake_dense_bitwise(cfg):
    tc = port_cfg(cfg)
    assert tmrhe.dense_level_count(tc) == jmrhe.dense_level_count(cfg)
    for a, b in zip(tmrhe.dense_level_offsets(tc),
                    jmrhe.dense_level_offsets(cfg)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    table = _table(cfg, 2)
    ref = np.asarray(jmrhe.bake_dense(jnp.asarray(table), cfg))
    out = tmrhe.bake_dense(torch.tensor(table), tc).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    if cfg == MRHEConfig():  # config 4: seven dense levels, res 16..64
        assert tmrhe.dense_level_count(tc) == 7
        assert out.shape == (543884, 16)
    if cfg.n_dims == 2:
        assert out.shape == (1, 8 * cfg.n_features) and not out.any()


@pytest.mark.parametrize("case", ["config4_in_box", "config4_out_of_box",
                                  "boundary"])
def test_encode_with_baked_matches_jax(case):
    """JAX tests/test_encoders.py:207-236's cases, and positions outside
    the box (the dense levels read the clipped base cell there)."""
    if case == "boundary":
        cfg = SMALL_3D
        pos = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 1.0, 0.0]],
                       np.float32)
    else:
        cfg = MRHEConfig()
        rng = np.random.default_rng(6)
        pos = rng.random((512, 3), dtype=np.float32)
        if case == "config4_out_of_box":
            pos = (pos * 1.4 - 0.2).astype(np.float32)
    table = _table(cfg, 5)
    baked = jmrhe.bake_dense(jnp.asarray(table), cfg)
    ref = np.asarray(jmrhe.encode_with_baked(jnp.asarray(table), baked,
                                             jnp.asarray(pos), cfg,
                                             QuirkFlags()))
    tc = port_cfg(cfg)
    out = tmrhe.encode_with_baked(torch.tensor(table),
                                  torch.tensor(np.asarray(baked)),
                                  torch.tensor(pos), tc,
                                  tcfg_mod.QuirkFlags()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    if case != "config4_out_of_box":  # in the box it is the hash path
        hashed = tmrhe.encode(torch.tensor(table), torch.tensor(pos), tc,
                              tcfg_mod.QuirkFlags()).numpy()
        np.testing.assert_allclose(out, hashed, rtol=1e-6, atol=1e-6)


def test_encode_with_baked_non_power_of_two_table():
    """T = 1000 under the dense bake: JAX's encode_with_baked cannot build
    its tail config for such a table (its MRHEConfig defaults to the oct
    bake, which refuses it), so the port is held to JAX's hash-path encode,
    which the dense encode equals for in-box positions."""
    cfg = MRHEConfig(table_size=1000, inference_bake="dense")
    table = _table(cfg, 8)
    pos = np.random.default_rng(8).random((512, 3), dtype=np.float32)
    with pytest.raises(ValueError, match="power-of-two"):
        jmrhe.encode_with_baked(jnp.asarray(table),
                                jmrhe.bake_dense(jnp.asarray(table), cfg),
                                jnp.asarray(pos), cfg, QuirkFlags())
    ref = np.asarray(jmrhe.encode(jnp.asarray(table), jnp.asarray(pos), cfg,
                                  QuirkFlags()))
    tc = port_cfg(cfg)
    tt = torch.tensor(table)
    out = tmrhe.encode_with_baked(tt, tmrhe.bake_dense(tt, tc),
                                  torch.tensor(pos), tc,
                                  tcfg_mod.QuirkFlags()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


# -- the cache: encode fallback (F3), bake modes, query, dump_weights -------

def _cache_cfg(mode="oct", field_dtype="float32", inference_dtype="float32",
               table_size=16384, train_encode="oct"):
    cfg = jcfg_mod.nrc_online_config(32, 32)
    return R(cfg,
             mrhe=R(cfg.mrhe, inference_bake=mode, table_size=table_size,
                    train_encode=train_encode),
             volume=R(cfg.volume, field_dtype=field_dtype),
             mlp=R(cfg.mlp, inference_dtype=inference_dtype,
                   fused_inference=True))


def _states(cfg, seed=4):
    """O(1) weights so the query's layers all carry signal."""
    jstate = jnrc.init_state(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(v.shape) * (0.25 if k[0] == "w"
                                                  else 0.05))
              .astype(np.float32) for k, v in jstate.mlp_params.items()}
    jstate = jstate._replace(mlp_params={k: jnp.asarray(v)
                                         for k, v in params.items()})
    return jstate, tnrc.state_from_numpy(to_np(jstate)._asdict(), "cpu")


def _rays(cfg, n, seed=4):
    rng = np.random.default_rng(seed)
    pos = ((rng.random((n, 3)) - 0.5) * np.asarray(
        cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d


@pytest.mark.parametrize("table_size", [1000, 12289])
def test_nrc_encode_non_power_of_two_table(table_size):
    """F3: a table that cannot use the oct layout trains through the hash
    path (JAX models/nrc.py:83-92) -- the features and the table's
    gradient match JAX's."""
    cfg = _cache_cfg("dense", table_size=table_size)
    jstate, tstate = _states(cfg)
    pos, d = _rays(cfg, 512)
    ref, vjp = jax.vjp(lambda t: jnrc.encode(t, jnp.asarray(pos),
                                             jnp.asarray(d), cfg),
                       jstate.hash_table)
    cot = np.random.default_rng(9).standard_normal(ref.shape).astype(
        np.float32)
    ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
    tt = tstate.hash_table.clone().requires_grad_()
    out = tnrc.encode(tt, torch.tensor(pos), torch.tensor(d), port_cfg(cfg))
    g = torch.autograd.grad(out, tt, torch.tensor(cot))[0].numpy()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g, ref_g, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["oct", "dense", "none"])
@pytest.mark.parametrize("fields", ["f32", "bf16"])
def test_bake_encode_baked_and_query_match_jax(mode, fields):
    """Every inference mode with f32 and with bf16 fields; with bf16 fields
    the query also asks for bf16 inference, which JAX honours only under
    the oct bake (models/nrc.py:145): the dense and hash paths keep f32
    rows. The oct bf16 encode's parity is in tests/test_torch_bf16.py, so
    there only its dtype is checked here."""
    bf16 = fields == "bf16"
    cfg = _cache_cfg(mode, "bfloat16" if bf16 else "float32",
                     "bfloat16" if bf16 else "float32")
    tcfg = port_cfg(cfg)
    jstate, tstate = _states(cfg)
    pos, d = _rays(cfg, 777)
    jb = jnrc.bake(jstate, cfg)
    tb = tnrc.bake(tstate, tcfg)
    assert tuple(tb.shape) == tuple(jb.shape)
    assert str(tb.dtype).split(".")[-1] == str(jb.dtype)
    np.testing.assert_array_equal(tb.float().numpy(),
                                  np.asarray(jb.astype(jnp.float32)))
    fn = tnrc.make_baked_query_fn(tstate, tb, tcfg)
    x = fn.encode_fn(torch.tensor(pos), torch.tensor(d))
    ref_x = jnrc.encode_baked(jstate, jb, jnp.asarray(pos), jnp.asarray(d),
                              cfg)
    assert str(x.dtype).split(".")[-1] == str(ref_x.dtype)
    assert x.dtype == (torch.bfloat16 if bf16 and mode == "oct"
                       else torch.float32)
    if x.dtype == torch.bfloat16:
        return
    np.testing.assert_allclose(x.numpy(), np.asarray(ref_x), rtol=1e-6,
                               atol=1e-6)
    ref = np.asarray(jnrc.query_baked(jstate, jb, jnp.asarray(pos),
                                      jnp.asarray(d), cfg))
    np.testing.assert_allclose(fn(torch.tensor(pos), torch.tensor(d)).numpy(),
                               ref, rtol=1e-5, atol=QUERY_ATOL)
    # the hash-path query of the trainable encode
    ref_q = np.asarray(jnrc.query(jstate, jnp.asarray(pos), jnp.asarray(d),
                                  cfg))
    np.testing.assert_allclose(tnrc.query(tstate, torch.tensor(pos),
                                          torch.tensor(d), tcfg).numpy(),
                               ref_q, rtol=1e-5, atol=QUERY_ATOL)
    if mode != "oct" and not bf16:  # in the box: the hash path's query
        np.testing.assert_allclose(fn(torch.tensor(pos),
                                      torch.tensor(d)).numpy(),
                                   ref_q, rtol=1e-5, atol=QUERY_ATOL)


def test_dump_weights_text_equals_jax():
    cfg = jcfg_mod.nrc_online_config(32, 32)
    jstate, tstate = _states(cfg, seed=0)
    for n in (8, 3):
        assert (tnrc.dump_weights(tstate, n)
                == jnrc.dump_weights(jstate, n))
    text = tnrc.dump_weights(tstate)
    assert "w0 (64, 64)" in text and "hash (16, 16384, 2)" in text


# -- one frame with the dense bake and the hash train encode ----------------

def test_dense_hash_frame_step_matches_jax():
    """Config 4 with the collision sampler and K1's query, the dense
    inference bake and the hash-path train encode, cut to 16x16: one JAX
    jitted frame_step and the port fed the same train and render draws."""
    cfg = jcfg_mod.nrc_online_config(W, H)
    cfg = R(cfg,
            path=R(cfg.path, sampler="collision", collision_field_steps=8),
            mlp=R(cfg.mlp, fused_inference=True),
            mrhe=R(cfg.mrhe, inference_bake="dense", train_encode="hash"),
            volume=R(cfg.volume, grid_shape=(16, 12, 20),
                     field_shape=(6, 5, 8)),
            env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
            train=R(cfg.train, train_width=8, train_height=8,
                    target_bounces=16))
    tcfg = port_cfg(cfg)
    rng = np.random.default_rng(0)
    dens = rng.random(cfg.volume.grid_shape, dtype=np.float32) * 0.5
    env = jassets.synthesize_sky(32, 64)
    opts = {"xla_backend_optimization_level": 0}
    js = jax.jit(lambda a, b: jscene.make_scene(cfg, a, b)).lower(
        dens, env).compile(compiler_options=opts)(dens, env)
    ts = tscene.make_scene(tcfg, dens, env, device="cpu")
    jstate, tstate = _states(cfg, seed=0)
    key = jax.random.PRNGKey(21)
    step = jax.jit(lambda s, sc, k: jframe.frame_step(s, sc, k, cfg))
    jstate, ref = step.lower(jstate, js, key).compile(
        compiler_options=opts)(jstate, js, key)
    k_train, k_render = jax.random.split(key)
    k_steps = min(cfg.path.coll_max_events, cfg.path.max_bounces)
    u = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(k_render, 0), (k_steps, 4, W * H))))
    tstate, out = tframe.frame_step(
        tstate, ts, None, tcfg,
        train_uniforms=jax_train_uniforms(k_train, cfg, tcfg), uniforms=u)

    np.testing.assert_allclose(float(out.mse), float(ref.mse), rtol=1e-3)
    for k in tstate.mlp_params:
        np.testing.assert_allclose(tstate.mlp_params[k].numpy(),
                                   np.asarray(jstate.mlp_params[k]), rtol=0,
                                   atol=1e-6)
    diff = np.abs(tstate.hash_table.numpy() - np.asarray(jstate.hash_table))
    assert (diff <= 1e-6).mean() >= 0.999, (diff <= 1e-6).mean()
    assert diff.max() <= 2 * cfg.mrhe.learning_rate * 1.0001, diff.max()
    img, ref_img = out.image.numpy(), np.asarray(ref.image)
    assert img.shape == ref_img.shape == (H, W, 3)
    ok = np.all(np.abs(img - ref_img) <= 1e-4 + 1e-3 * np.abs(ref_img),
                axis=-1)
    assert ok.mean() >= 0.995, ok.mean()
    assert abs(img.mean() - ref_img.mean()) <= 1e-4 * abs(ref_img.mean())
