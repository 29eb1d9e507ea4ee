"""The port's bf16 storage and bf16 cache query (config 5) against the JAX
package, from the same numpy inputs: the four scene fields stored in bf16,
the bf16 oct encode, ``bake`` / ``encode_baked`` / ``query_mlp`` /
``query_baked`` with ``MLPConfig.inference_dtype="bfloat16"``, and the
plain version of K1's bf16 mode against the Pallas kernel in interpreter
mode.

The JAX side is compiled by XLA:CPU's LLVM backend at -O0 (see
tests/test_torch_render.py). Bounds, each with its reason:
- fields: each bf16 field within one bf16 ulp of JAX's and >= 99.9% bit
  for bit. Both round f32 bakes that agree to f32 rounding (the port's f32
  bake test); a bake value a few f32 ulps from a bf16 rounding boundary
  rounds the other way (measured: 99.995% equal, never more than 1 ulp);
- the oct bake: bit for bit (rolls and one cast);
- the bf16 encode: within 8 bf16 ulps of the largest of the eight corner
  values it interpolates. The frameworks round bf16 in different places:
  torch rounds after every op (1 - frac, each product of the weight,
  each weight x row), XLA:CPU keeps some of them in f32 inside its fusion.
  Each of those roundings is half an ulp of a term no larger than the
  largest corner value, and the corner sum cancels, so the bound is in
  ulps of the terms, not of the result (measured <= 6 ulps of max(|x|,
  1/8), both sides within 7 ulps of the f32 encode);
- ``query_mlp`` on the same bf16 rows: rtol 1e-5 / atol 1e-5, the f32
  MLP in another summation order (measured 4.3e-6 on outputs up to 11);
- ``query_baked``: the encode's few-ulp differences carried through O(1)
  weights; held at the JAX test's bf16 bound, rtol/atol 0.03 (measured
  <= 0.02 x (|ref| + 1));
- the port's bf16 query against its own f32 query: rtol/atol 0.03 and not
  bit-identical, as tests/test_render_nrc.py holds the JAX package's;
- K1's plain bf16 version against the Pallas kernel: rtol 1e-5 / atol
  1e-6, as tests/test_torch_mlp.py (the same f32 function over the same
  bf16 values, another summation order).
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
from neuralradiancecaching_tpu.ops import mlp as jmlp
from neuralradiancecaching_tpu.ops import mrhe as jmrhe
from neuralradiancecaching_tpu.ops import pallas_mlp
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import mlp as tmlp
from neuralradiancecaching_tpu_torch.ops import mrhe as tmrhe
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import profiling

R = dataclasses.replace
N = 4096


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


def bf16_cfg():
    """Config 5 (bf16 fields, (32, 64) direction buckets) with the bf16
    fused query, scene cut to test size."""
    cfg = cfg_mod.progressive_1080p_config()
    return R(cfg, path=R(cfg.path, collision_field_steps=8),
             mlp=R(cfg.mlp, inference_dtype="bfloat16",
                   fused_inference=True),
             volume=R(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)))


def bits(x) -> np.ndarray:
    """bf16 values (a JAX array or a torch tensor) as int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


def to_bf16_tensor(x) -> torch.Tensor:
    """A JAX bf16 array as the torch bf16 tensor of the same bits."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(
        torch.bfloat16)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def encode_ulps(ref, out, oct_rows: torch.Tensor, pos: np.ndarray, cfg):
    """|ref - out| of (N, L*F) MRHE features in bf16 ulps of each feature's
    largest corner value (the scale of its terms; the base-row indices
    are bit-identical in both packages)."""
    tc = port_cfg(cfg)
    pn = mrhe_ops_norm(pos, cfg)
    flat, _ = tmrhe._oct_geom(torch.tensor(pn), tc.mrhe, tc.quirks, None)
    lv, f = cfg.mrhe.n_levels, cfg.mrhe.n_features
    corners = oct_rows[flat].float().reshape(len(pos), lv, -1, f).abs()
    scale = corners.amax(dim=2).reshape(len(pos), lv * f).numpy()
    diff = np.abs(np.asarray(ref, np.float32) - out.float().numpy())
    return diff / bf16_ulp(scale), diff


def mrhe_ops_norm(pos: np.ndarray, cfg) -> np.ndarray:
    """World positions -> the encode's [0, 1]^3 (normalize_pos)."""
    return ((pos - np.asarray(cfg.volume.box_center))
            / np.asarray(cfg.volume.box_size) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """O(1) hash table and MLP weights (numpy, seeded) in both packages, and
    N random in-box queries."""
    cfg = bf16_cfg()
    rng = np.random.default_rng(0)
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    table = (rng.standard_normal(jstate.hash_table.shape) * 0.5).astype(
        np.float32)
    params = {k: (rng.standard_normal(v.shape) * (0.25 if k[0] == "w"
                                                  else 0.05))
              .astype(np.float32) for k, v in jstate.mlp_params.items()}
    jstate = jstate._replace(
        hash_table=jnp.asarray(table),
        mlp_params={k: jnp.asarray(v) for k, v in params.items()})
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    pos = ((rng.random((N, 3)) - 0.5)
           * np.asarray(cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return cfg, jstate, tstate, pos, d


def test_make_scene_bf16_fields_match_jax():
    cfg = bf16_cfg()
    dens = np.random.default_rng(0).random(cfg.volume.grid_shape,
                                           dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    js = jax_o0(lambda dd, e: jscene.make_scene(cfg, dd, e), dens, env)
    ts = tscene.make_scene(port_cfg(cfg), torch.tensor(dens),
                           torch.tensor(env))
    for name in ("env_t_field", "env_s_field", "coll_field", "env_l_field"):
        ref, out = getattr(js, name), getattr(ts, name)
        assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
        assert tuple(out.shape) == ref.shape, name
        ulps = np.abs(bits(ref) - bits(out))
        assert ulps.max() <= 1, (name, ulps.max())
        assert (ulps == 0).mean() >= 0.999, (name, (ulps == 0).mean())
    # config 5's (32, 64) buckets: 4x the rows of config 4's (16, 32)
    assert ts.coll_field.shape[0] == 6 * 5 * 8 * 32 * 64
    assert ts.density.dtype == torch.float32  # the corner table stays f32


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
def test_encode_with_oct_bf16_matches_jax(setup, rows_dtype):
    cfg, jstate, tstate, pos, _ = setup
    pn = mrhe_ops_norm(pos, cfg)
    oct_rows = jax_o0(lambda t: jmrhe.bake_oct(t, cfg.mrhe),
                      jstate.hash_table).astype(rows_dtype)
    ref = jax_o0(lambda o, p: jmrhe.encode_with_oct(
        o, p, cfg.mrhe, cfg.quirks, compute_dtype=jnp.bfloat16),
        oct_rows, pn)
    t_rows = (to_bf16_tensor(oct_rows) if rows_dtype == "bfloat16"
              else torch.tensor(np.asarray(oct_rows)))
    tc = port_cfg(cfg)
    out = tmrhe.encode_with_oct(t_rows, torch.tensor(pn), tc.mrhe,
                                tc.quirks, compute_dtype=torch.bfloat16)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert tuple(out.shape) == ref.shape == (N, 32)
    ulps, diff = encode_ulps(ref, out, t_rows, pos, cfg)
    assert ulps.max() <= 8.0, ulps.max()
    assert (diff == 0).mean() >= 0.3  # mostly the same rounding


def test_bake_and_encode_baked_bf16_match_jax(setup):
    cfg, jstate, tstate, pos, d = setup
    tc = port_cfg(cfg)
    jb = jax_o0(lambda s: jnrc.bake(s, cfg), jstate)
    tb = tnrc.bake(tstate, tc)
    assert jb.dtype == jnp.bfloat16 and tb.dtype == torch.bfloat16
    assert np.array_equal(bits(jb), bits(tb))
    ref = jax_o0(lambda s, b, p, dd: jnrc.encode_baked(s, b, p, dd, cfg),
                 jstate, jb, pos, d)
    out = tnrc.encode_baked(tstate, tb, torch.tensor(pos), torch.tensor(d),
                            tc)
    assert ref.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    assert tuple(out.shape) == ref.shape == (N, 64)
    # MRHE features: the encode's bound; the one-blob features are f32
    # values cast once (<= 1 ulp: one f32 ulp can cross a boundary)
    ulps, _ = encode_ulps(ref[:, :32], out[:, :32], tb, pos, cfg)
    assert ulps.max() <= 8.0, ulps.max()
    blob = np.abs(bits(ref)[:, 32:] - bits(out)[:, 32:])
    assert blob.max() <= 1 and (blob == 0).mean() >= 0.999


def test_query_mlp_bf16_matches_jax_on_same_rows(setup):
    cfg, jstate, tstate, pos, d = setup
    jb = jax_o0(lambda s: jnrc.bake(s, cfg), jstate)
    x = jax_o0(lambda s, b, p, dd: jnrc.encode_baked(s, b, p, dd, cfg),
               jstate, jb, pos, d)
    ref = np.asarray(jax_o0(lambda s, xx: jnrc.query_mlp(s, xx, cfg),
                            jstate, x))
    with profiling.tracing("cpu") as rec, rec.frame(0):
        out = tnrc.query_mlp(tstate, to_bf16_tensor(x), port_cfg(cfg))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    # CPU rows: the plain version, no k1 span and no launch counted
    assert [(r.name, r.counts) for r in rec.records()] == [("frame", {})]


def test_query_baked_bf16_matches_jax(setup):
    cfg, jstate, tstate, pos, d = setup
    tc = port_cfg(cfg)
    ref = np.asarray(jax_o0(
        lambda s, p, dd: jnrc.query_baked(s, jnrc.bake(s, cfg), p, dd, cfg),
        jstate, pos, d))
    out = tnrc.query_baked(tstate, tnrc.bake(tstate, tc), torch.tensor(pos),
                           torch.tensor(d), tc).numpy()
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0.03, atol=0.03)


def test_bf16_query_tracks_own_f32_query():
    """The port's bf16 query against its own f32 query, from the JAX init
    state as tests/test_render_nrc.py:test_bf16_query_matches_f32_within_
    tolerance runs it: same bound, not bit-identical."""
    cfg = R(bf16_cfg(), volume=R(bf16_cfg().volume, field_dtype="float32"))
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    rng = np.random.default_rng(3)
    pos = torch.tensor(((rng.random((256, 3)) - 0.5)
                        * np.asarray(cfg.volume.box_size)).astype(np.float32))
    d = torch.tensor(rng.standard_normal((256, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    tc = port_cfg(cfg)
    baked = tnrc.bake(tstate, tc)
    a = tnrc.query_baked(tstate, baked, pos, d,
                         R(tc, mlp=R(tc.mlp, inference_dtype="float32")))
    b = tnrc.query_baked(tstate, baked, pos, d, tc)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0.03, atol=0.03)
    assert (a != b).any()


@pytest.mark.parametrize("n", [1, 5, 511, 513])
def test_k1_plain_bf16_matches_pallas_interpret(n):
    mlp = cfg_mod.MLPConfig()
    rng = np.random.default_rng(n)
    params = {k: (rng.standard_normal(v.shape) * (0.2 if k[0] == "w"
                                                  else 0.1))
              .astype(np.float32)
              for k, v in jmlp.init_params(jax.random.PRNGKey(n),
                                                   mlp).items()}
    x = jnp.asarray((rng.standard_normal((n, 64)) * 0.5).astype(np.float32),
                    jnp.bfloat16)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    ref = np.asarray(pallas_mlp.apply_fused(jp, x, mlp, interpret=True))
    assert ref.dtype == np.float32
    tp = {k: torch.tensor(v) for k, v in params.items()}  # f32: rounded
    # inside, as the kernel's wrapper rounds them
    out = fused_mlp.apply_plain(tp, to_bf16_tensor(x), port_cfg(mlp))
    fn = fused_mlp.apply(tp, to_bf16_tensor(x), port_cfg(mlp))
    assert out.dtype == fn.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fn.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_k1_plain_bf16_is_not_a_bf16_matmul_chain():
    """The hazard the plain version avoids: bf16 @ bf16 in torch returns
    bf16 and rounds every layer; the plain version keeps f32 activations."""
    mlp = port_cfg(cfg_mod.MLPConfig())
    g = torch.Generator().manual_seed(0)
    params = {k: v * 20.0 for k, v in
              tmlp.init_params(g, mlp).items()}
    x = torch.randn((64, 64), generator=g).to(torch.bfloat16)
    out = fused_mlp.apply_plain(params, x, mlp)
    f32 = tmlp.apply({k: v.to(torch.bfloat16).float()
                              for k, v in params.items()}, x.float(), mlp)
    chain = tmlp.apply({k: v.to(torch.bfloat16)
                                for k, v in params.items()}, x, mlp)
    assert torch.equal(out, f32)
    assert not torch.equal(out, chain.float())


def test_k1_bf16_rows_on_cpu_take_plain_and_kernel_needs_cuda():
    mlp = port_cfg(cfg_mod.MLPConfig())
    params = tmlp.init_params(torch.Generator().manual_seed(1), mlp)
    x = torch.zeros((8, 64), dtype=torch.bfloat16)
    with profiling.tracing("cpu") as rec, rec.frame(0):
        out = fused_mlp.apply_fused(params, x, mlp)
    assert out.dtype == torch.float32
    assert [(r.name, r.counts) for r in rec.records()] == [("frame", {})]
    fused_mlp._check_supported(x, mlp)  # bf16 rows are the kernel's too
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.apply_kernel(params, x, mlp)


def test_k1_bf16_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py there)")
    mlp = port_cfg(cfg_mod.MLPConfig())
    g = torch.Generator(device="cuda").manual_seed(7)
    params = {k: v * 20.0 for k, v in tmlp.init_params(
        g, mlp).items()}
    packed = fused_mlp.pack_params(params, mlp, bf16=True)
    assert torch.equal(packed.buffer, fused_mlp.pack_params_plain(
        params, mlp, bf16=True, device="cuda").buffer)
    for n in (1, 5, 63, 65, 127, 129, 511, 513, 4096):
        x = torch.randn((n, 64), generator=g, device="cuda").to(
            torch.bfloat16)
        with profiling.tracing("cuda") as rec:
            out = fused_mlp.apply_kernel(params, x, mlp)
        assert [(r.name, r.counts) for r in rec.records()] == [
            ("k1", {"rows": n, "k1_bf16_launches": 1})]
        torch.testing.assert_close(
            out, fused_mlp.apply_plain(params, x, mlp), rtol=1e-4,
            atol=1e-5)
    x[3, 5], x[64, 0] = float("nan"), float("inf")
    out = fused_mlp.launch(packed, x, mlp)
    torch.cuda.synchronize()
    assert not torch.isfinite(out[[3, 64]]).any()
    assert torch.isfinite(out[[0, 4, 63, 65]]).all()
