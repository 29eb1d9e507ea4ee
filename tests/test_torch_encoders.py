"""The port's MRHE (oct bake + encode), one-blob encode and state conversion
against the JAX package, from the same numpy inputs.

Hash indices and baked rows must match bit for bit; the encodes are fp32
arithmetic in another summation order, held to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as cfg_mod
from neuralradiancecaching_tpu.config import (MRHEConfig, OneBlobConfig,
                                              QuirkFlags)
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.ops import mrhe as jmrhe
from neuralradiancecaching_tpu.ops import oneblob as joneblob
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import mrhe as tmrhe
from neuralradiancecaching_tpu_torch.ops import oneblob as toneblob


@pytest.mark.parametrize("table_size", [16384, 1000])
def test_hash_coords_bitwise_incl_negative_and_above_2_31(table_size):
    rng = np.random.default_rng(0)
    neg = rng.integers(-2**31, 2**31, size=(4096, 3), dtype=np.int64)
    big = rng.integers(2**31, 2**32, size=(4096, 3), dtype=np.uint64)
    ref_neg = np.asarray(jmrhe.hash_coords(jnp.asarray(neg.astype(np.int32)),
                                           table_size))
    ref_big = np.asarray(jmrhe.hash_coords(
        jnp.asarray(big.astype(np.uint32)), table_size))
    out_neg = tmrhe.hash_coords(torch.tensor(neg), table_size).numpy()
    out_big = tmrhe.hash_coords(torch.tensor(big.astype(np.int64)),
                                table_size).numpy()
    np.testing.assert_array_equal(out_neg, ref_neg)
    np.testing.assert_array_equal(out_big, ref_big)
    assert out_neg.min() >= 0 and out_big.max() < table_size


def test_schedule_offsets_match():
    cfg = MRHEConfig()
    np.testing.assert_array_equal(tmrhe.resolutions(cfg),
                                  jmrhe.resolutions(cfg))
    np.testing.assert_array_equal(tmrhe.corner_hash_offsets(cfg),
                                  jmrhe.corner_hash_offsets(cfg))
    np.testing.assert_array_equal(tmrhe._corner_offsets(3),
                                  jmrhe._corner_offsets(3))
    assert tmrhe.oct_supported(cfg) and not tmrhe.oct_supported(
        MRHEConfig(table_size=1000, inference_bake="dense"))


def _table(cfg, seed=0):
    return np.array(jmrhe.init_table(jax.random.PRNGKey(seed), cfg))


def test_bake_oct_bitwise():
    cfg = MRHEConfig()
    table = _table(cfg)
    ref = np.asarray(jmrhe.bake_oct(jnp.asarray(table), cfg))
    out = tmrhe.bake_oct(torch.tensor(table), cfg).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("world_space_lerp", [False, True])
def test_encode_with_oct_matches(world_space_lerp):
    cfg = MRHEConfig()
    quirks = QuirkFlags(world_space_lerp=world_space_lerp)
    table = _table(cfg, 1)
    rng = np.random.default_rng(1)
    # in-box positions plus a few outside (negative grid coordinates)
    pos = (rng.random((2048, 3), dtype=np.float32) * 1.2 - 0.1).astype(
        np.float32)
    raw = (pos * 40.0).astype(np.float32)
    oct_j = jmrhe.bake_oct(jnp.asarray(table), cfg)
    ref = np.asarray(jmrhe.encode_with_oct(oct_j, jnp.asarray(pos), cfg,
                                           quirks, pos_raw=jnp.asarray(raw)))
    ref_hash = np.asarray(jmrhe.encode(jnp.asarray(table), jnp.asarray(pos),
                                       cfg, quirks, pos_raw=jnp.asarray(raw)))
    out = tmrhe.encode_with_oct(torch.tensor(np.asarray(oct_j)),
                                torch.tensor(pos), cfg, quirks,
                                pos_raw=torch.tensor(raw)).numpy()
    assert out.shape == (2048, 32)
    # the quirk's lerp factors reach ~1e2 per axis, so its features are
    # products of order 1e7 with cancellation: hold them to 1e-6 of scale
    atol = 1e-6 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(out, ref_hash, rtol=1e-6, atol=atol)


def test_encode_with_oct_bf16_raises():
    cfg = MRHEConfig()
    with pytest.raises(NotImplementedError):
        tmrhe.encode_with_oct(torch.zeros((16384 * 16, 16)),
                              torch.zeros((4, 3)), cfg, QuirkFlags(),
                              compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("raw", [False, True])
def test_encode_dir_matches(raw):
    rng = np.random.default_rng(2)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    quirks = QuirkFlags(raw_oneblob=raw)
    ref = np.asarray(joneblob.encode_dir(jnp.asarray(d), OneBlobConfig(),
                                         quirks))
    out = toneblob.encode_dir(torch.tensor(d), OneBlobConfig(),
                              quirks).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_normalize_pos_matches():
    vol = cfg_mod.VolumeConfig()
    pos = np.random.default_rng(3).standard_normal((512, 3)).astype(
        np.float32) * 30
    ref = np.asarray(jmrhe.normalize_pos(jnp.asarray(pos), vol.box_size,
                                         vol.box_center))
    out = tmrhe.normalize_pos(torch.tensor(pos), vol.box_size,
                              vol.box_center).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("preset", ["nrc_online", "mnist"])
def test_state_from_numpy_round_trip_bitwise(preset):
    cfg = (cfg_mod.nrc_online_config(32, 32) if preset == "nrc_online"
           else cfg_mod.NRCConfig())
    jstate = jnrc.init_state(jax.random.PRNGKey(3), cfg)
    d = jax.tree_util.tree_map(np.asarray, jstate)._asdict()
    tstate = tnrc.state_from_numpy(d, "cpu")
    for name, ref in d.items():
        got = getattr(tstate, name)
        if ref is None:
            assert got is None
        elif isinstance(ref, dict):
            assert sorted(got) == sorted(ref)
            for k in ref:
                np.testing.assert_array_equal(got[k].numpy(), ref[k])
                assert got[k].numpy().dtype == ref[k].dtype
        else:
            np.testing.assert_array_equal(got.numpy(), ref)
            assert got.numpy().dtype == ref.dtype


def test_init_state_structure_matches_jax():
    cfg = cfg_mod.nrc_online_config(32, 32)
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    tstate = tnrc.init_state(torch.Generator().manual_seed(0), cfg)
    assert tuple(tstate.hash_table.shape) == tuple(jstate.hash_table.shape)
    assert sorted(tstate.mlp_params) == sorted(jstate.mlp_params)
    assert (tstate.hash_second is None) == (jstate.hash_second is None)
    assert tnrc.input_features(cfg) == jnrc.input_features(cfg) == 64


def test_query_baked_matches_jax():
    cfg = cfg_mod.nrc_online_config(32, 32)
    cfg = cfg.replace(mlp=dataclasses.replace(cfg.mlp, fused_inference=True))
    jstate = jnrc.init_state(jax.random.PRNGKey(4), cfg)
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    rng = np.random.default_rng(4)
    pos = ((rng.random((777, 3)) - 0.5) * np.asarray(
        cfg.volume.box_size)).astype(np.float32)
    d = rng.standard_normal((777, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jb = jnrc.bake(jstate, cfg)
    ref_x = np.asarray(jnrc.encode_baked(jstate, jb, jnp.asarray(pos),
                                         jnp.asarray(d), cfg))
    ref = np.asarray(jnrc.query_baked(jstate, jb, jnp.asarray(pos),
                                      jnp.asarray(d), cfg))
    tb = tnrc.bake(tstate, cfg)
    fn = tnrc.make_baked_query_fn(tstate, tb, cfg)
    x = fn.encode_fn(torch.tensor(pos), torch.tensor(d))
    np.testing.assert_allclose(x.numpy(), ref_x, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fn(torch.tensor(pos), torch.tensor(d)).numpy(),
                               ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(fn.mlp_fn(x).numpy(), ref, rtol=1e-5,
                               atol=1e-9)
