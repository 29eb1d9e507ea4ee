"""``config.reference_exact()`` -- the JAX package's bit-faithful
reproduction of the reference -- through the port against the JAX package,
cut only in scale (image, grid, walk lengths, the train grid): the 8-bit
quantized scene, the unjittered train batch of one oversample, three whole
``frame_step``s with the reference's optimizers (guarded momentum SGD on
the MLP, guarded plain SGD on the hash table) from one carried-over state,
and that state and its checkpoints across the two packages.

The preset turns on all six quirks, quadrature transmittance for the
lights (32 steps) and the env (16), MC in-scatter (8 samples) through the
dense per-slot shade (``compact_events=0``), an uncapped query, train
targets without env light (``env_samples=0``). The scene as it ships has
no light on, so its train targets are 0; the frames run both as it ships
and with the two lights on, which drives the light quadrature through the
targets and the render.

Every draw comes from the JAX package's own keys (the helpers of
tests/test_torch_reference.py and tests/test_torch_oracle.py rebuild
them); the JAX frame is one jitted step compiled at -O0
(tests/test_torch_render.py). The JAX scene is built eagerly, as the
package's entry points build it (cli.py:80, bench.py:148): under jit XLA
rewrites the quantizer's ``/ 255`` into a multiply by the reciprocal,
which moves about half of the quantized voxels by one ulp.

Tolerances, each with its reason:
- the quantized grid and its corner table bit for bit (round, clip and
  one division, in the same order);
- the train batch per lane as tests/test_torch_reference.py holds it
  (>= 99% of lanes within 1e-4 + 1e-3 |ref|, the target mean within 1e-4
  relative: a one-ulp difference in a transcendental can flip a density
  test and change a lane wholesale);
- the three frames: the mse trajectory within 1e-3 relative, >= 99.5% of
  the last image's pixels within 1e-4 + 1e-3 |ref| and the mean within
  1e-4 relative, MLP parameters and their momentum within 1e-6 + 1e-5
  |ref| (three SGD steps on gradients summed in another order), and every
  hash entry within 1e-6: plain SGD scales the gradient by the learning
  rate, so there is no Adam eps to turn a rounding-level gradient into a
  step of +-lr (tests/test_torch_train.py);
- the state and checkpoints bit for bit, and one optimizer step from the
  carried state within 1e-6 + 1e-5 |ref| (one fp32 product and sum each).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.io import checkpoint as jck
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.render import frame as jframe
from neuralradiancecaching_tpu.render import targets as jtargets
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu_torch.io import checkpoint as tck
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.render import targets as ttargets
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from tests.test_torch_cli import jax_leaves, port_leaves, random_leaves
from tests.test_torch_oracle import (jax_path_uniforms, lanes_close, o0,
                                     port_cfg, with_lights)
from tests.test_torch_reference import (cut, jax_reference_train_uniforms,
                                        per_lane_all)

LANE_FRAC_OK, PIXEL_FRAC_OK, REL_MEAN = 0.99, 0.995, 1e-4
W = H = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exact_cfg(lights=False):
    """reference_exact as it ships, cut in scale (tests/test_torch_
    reference.py:cut), with the dir and point lights on when asked."""
    cfg = cut(jcfg_mod.reference_exact(W, H), W)
    return with_lights(cfg) if lights else cfg


@pytest.fixture(scope="module")
def assets():
    rng = np.random.default_rng(0)
    dens = rng.random(exact_cfg().volume.grid_shape, dtype=np.float32)
    return dens * 0.5, jassets.synthesize_sky(32, 64)


def scenes(cfg, assets):
    dens, env = assets
    return (jscene.make_scene(cfg, dens, env),
            tscene.make_scene(port_cfg(cfg), dens, env, device="cpu"))


def test_preset_settings():
    """What the frames below exercise is what the preset sets."""
    cfg = exact_cfg()
    assert cfg.path.sampler == "reference"
    assert all(dataclasses.astuple(cfg.quirks))
    assert (cfg.path.transmittance_mode, cfg.env_map.transmittance_mode,
            cfg.env_map.in_scatter_mode) == ("quadrature", "quadrature", "mc")
    assert (cfg.path.compact_events, cfg.render.query_cap_fraction,
            cfg.env_map.cdf_fraction) == (0.0, 1.0, 0.0)
    assert (cfg.train.env_samples, cfg.train.jitter_train_grid,
            cfg.train.vertex_oversample) == (0, False, 1)
    assert (cfg.mlp_opt.kind, cfg.mrhe.optimizer) == ("momentum", "sgd")


def test_quantized_scene_fields_bitwise(assets):
    """The 8-bit density and its corner table equal JAX's bit for bit; the
    preset bakes no field (every light and env term is a quadrature or an
    MC estimate), so each field is its placeholder row."""
    cfg = exact_cfg()
    js, ts = scenes(cfg, assets)
    grid = ts.density_grid.numpy()
    np.testing.assert_array_equal(grid, np.asarray(js.density_grid))
    np.testing.assert_array_equal(ts.density.numpy(), np.asarray(js.density))
    levels = grid * 255.0
    assert np.abs(levels - np.round(levels)).max() < 1e-4
    assert not np.array_equal(grid, assets[0])  # quantized, not copied
    for name in ("env_t_field", "env_l_field", "env_s_field", "coll_field"):
        ref, out = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert out.shape == ref.shape and out.shape[0] == 1, name
        assert not out.any(), name
    assert ts.env_t_field.shape[1] == tscene.lightfield_row_width()


def test_unjittered_train_batch_matches_jax(assets):
    """One oversample copy of the fixed train grid: the batch against
    JAX's, and the jitter draw does not enter it."""
    cfg = exact_cfg(lights=True)
    js, ts = scenes(cfg, assets)
    tcfg = port_cfg(cfg)
    key = jax.random.PRNGKey(62)
    ref = o0(lambda sc, k: jtargets.generate_train_batch(sc, cfg, k),
             js, key)(js, key)
    u = jax_reference_train_uniforms(key, cfg)
    assert u.jitter.shape[0] == 1
    out = ttargets.generate_train_batch(ts, tcfg, None, u)
    assert out.pos.shape[0] == cfg.train.train_width * cfg.train.train_height
    assert per_lane_all(ref, out) >= LANE_FRAC_OK
    _, rel = lanes_close(out.target.numpy(), np.asarray(ref.target))
    assert rel <= REL_MEAN and float(out.target.mean()) > 0.0
    other = u._replace(jitter=torch.rand_like(u.jitter))
    again = ttargets.generate_train_batch(ts, tcfg, None, other)
    for a, b in zip(out, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lights", [False, True], ids=["as_shipped",
                                                       "lights"])
def test_reference_exact_frame_steps_match_jax(assets, lights):
    """Three frame_steps from the JAX init state (weights N(0, 0.01^2), as
    the preset ships them: the MRHE features reach ~1e6 under the
    world-space-lerp quirk, so the cache term shows in the image), the
    JAX jitted frame and the port fed the same train and render draws."""
    cfg = exact_cfg(lights)
    tcfg = port_cfg(cfg)
    js, ts = scenes(cfg, assets)
    jstate = jnrc.init_state(jax.random.PRNGKey(0), cfg)
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    assert tstate.mlp_second is None and tstate.opt_step is None
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
    assert min(ref_mse) > 0.0
    img, ref_img = out.image.numpy(), np.asarray(ref.image)
    ok, rel = lanes_close(img.reshape(-1, 3), ref_img.reshape(-1, 3))
    assert ok.mean() >= PIXEL_FRAC_OK and rel <= REL_MEAN, (ok.mean(), rel)
    for tree in ("mlp_params", "mlp_momentum"):
        got, want = getattr(tstate, tree), getattr(jstate, tree)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{tree}[{k}]")
    assert any(bool(m.any()) for m in tstate.mlp_momentum.values())
    np.testing.assert_allclose(tstate.hash_table.numpy(),
                               np.asarray(jstate.hash_table), rtol=0,
                               atol=1e-6)
    assert tstate.mlp_second is None and tstate.hash_momentum is None
    assert tstate.opt_step is None and jstate.opt_step is None


def test_reference_exact_state_and_checkpoints_cross_load(tmp_path):
    """A reference_exact state (momentum SGD: mlp_momentum, no Adam
    fields, no step counter) from JAX into the port, a checkpoint of
    either package into the other, and one optimizer step from the
    carried momentum equal in both."""
    jcfg = exact_cfg()
    tcfg = port_cfg(jcfg)
    jstate = random_leaves(jnrc.init_state(jax.random.PRNGKey(0), jcfg), 3)
    assert jstate.mlp_second is None and jstate.opt_step is None
    tstate = tnrc.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate)._asdict(), "cpu")
    want = jax_leaves(jstate)
    assert sorted(want) == sorted(port_leaves(tstate))
    assert any(k.startswith(".mlp_momentum[") for k in want)
    for k, v in port_leaves(tstate).items():
        np.testing.assert_array_equal(v, want[k])
    # JAX -> port
    like = tnrc.init_state(torch.Generator().manual_seed(0), tcfg, "cpu")
    jck.save(str(tmp_path / "j"), jstate,
             metadata={"config_hash": jck.config_hash(jcfg)})
    loaded = tck.load(str(tmp_path / "j"), like,
                      expect_config_hash=tck.config_hash(tcfg))
    for k, v in port_leaves(loaded).items():
        np.testing.assert_array_equal(v, want[k])
    # port -> JAX, from other values
    other = tnrc.state_from_numpy(jax.tree_util.tree_map(
        np.asarray, random_leaves(jstate, 4))._asdict(), "cpu")
    tck.save(str(tmp_path / "t.npz"), other,
             metadata={"config_hash": tck.config_hash(tcfg)})
    back = jck.load(str(tmp_path / "t"), jstate,
                    expect_config_hash=jck.config_hash(jcfg))
    got, want = jax_leaves(back), port_leaves(other)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # one step of both optimizers from the carried state
    grads = random_leaves((jstate.mlp_params, jstate.hash_table), 5)
    ref = jnrc.apply_grads(jstate, grads, jcfg)
    out = tnrc.apply_grads(loaded, jax.tree_util.tree_map(
        lambda x: torch.tensor(np.asarray(x)), grads), tcfg)
    want = jax_leaves(ref)
    for k, v in port_leaves(out).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
