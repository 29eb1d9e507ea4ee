"""The port's offline path tracer (path-tracer.frag) against the JAX
package on the JAX test's scene, fed JAX's draws, and the JAX test's
behaviour checks on the port.

Tolerance: color, export position and export direction within 1e-5 +
1e-4 |ref| on every lane -- fp32 arithmetic in another order over 8
bounces of trilinear fetches, shadow and transmittance quadratures and
HG direction sampling. No lane flips at an exact-compare branch here
(the Russian-roulette draw against the survival probability, density >
0, transmittance < 0.01): the bound holds for all of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.config import CameraConfig, VolumeConfig
from neuralradiancecaching_tpu.ops import volume as jvolume
from neuralradiancecaching_tpu.render import offline_pathtracer as jopt
from neuralradiancecaching_tpu.scene.camera import make_camera, pixel_rays
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.ops import mlp as tmlp
from neuralradiancecaching_tpu_torch.ops import volume as tvolume
from neuralradiancecaching_tpu_torch.render import offline_pathtracer as topt

SUN = np.array([0.0, -1.0, 0.0], np.float32)


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
        cls = getattr(tcfg_mod, type(obj).__name__, None) or getattr(
            topt, type(obj).__name__)
        return cls(**{f.name: port_cfg(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def setup_scene(density=0.5):
    """JAX tests/test_offline_pathtracer.py:14-22: a 16^3 grid of constant
    density in an 8^3 box, 8 bounces, 4 transmittance steps, 6 shadow
    samples, an 8x8 camera at z = -20."""
    vol = VolumeConfig(grid_shape=(16, 16, 16), box_size=(8.0, 8.0, 8.0))
    grid = np.full((16, 16, 16), density, dtype=np.float32)
    cfg = jopt.OfflinePTConfig(max_bounces=8, transmittance_steps=4,
                               shadow_samples=6)
    ro, rd = pixel_rays(make_camera(CameraConfig(position=(0, 0, -20))), 8, 8)
    return grid, vol, cfg, np.asarray(ro), np.asarray(rd)


def jax_offline_uniforms(key, cfg, n: int) -> np.ndarray:
    """The draws of the JAX trace (offline_pathtracer.py:128-130,
    ops/phase.py:88-91) as (max_bounces, 4, n): per bounce k =
    fold_in(key, i), split(k, 3) into the rr, direction and distance keys,
    the direction key split again into u_cos and u_phi."""
    out = []
    for i in range(cfg.max_bounces):
        k_rr, k_dir, k_dist = jax.random.split(jax.random.fold_in(key, i), 3)
        k_ct, k_phi = jax.random.split(k_dir)
        out.append([np.asarray(jax.random.uniform(k, (n,)))
                    for k in (k_rr, k_ct, k_phi, k_dist)])
    return np.asarray(out, dtype=np.float32)


def run_jax(grid, vol, cfg, ro, rd, key):
    """The JAX trace compiled at -O0 (XLA:CPU's default level fuses
    floor()/fraction pairs inconsistently; tests/test_torch_render.py)."""
    def fn(g, o, d, k):
        return jopt.trace(jvolume.build_corner_table(g), vol, cfg, SUN, 1.0,
                          o, d, k)
    return jax.jit(fn).lower(grid, ro, rd, key).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        grid, ro, rd, key)


def run_port(grid, vol, cfg, ro, rd, uniforms):
    return topt.trace(tvolume.build_corner_table(torch.tensor(grid)),
                      port_cfg(vol), port_cfg(cfg), SUN, 1.0,
                      torch.tensor(ro), torch.tensor(rd),
                      torch.tensor(uniforms))


@pytest.mark.parametrize("density,seed", [(0.5, 0), (0.5, 1), (0.05, 2)])
def test_trace_matches_jax_lane_for_lane(density, seed):
    grid, vol, cfg, ro, rd = setup_scene(density)
    key = jax.random.PRNGKey(seed)
    ref = run_jax(grid, vol, cfg, ro, rd, key)
    out = run_port(grid, vol, cfg, ro, rd,
                   jax_offline_uniforms(key, cfg, len(ro)))
    for name in ("color", "export_pos", "export_dir"):
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(np.asarray(ref.color).max()) > 0.0


def test_offline_pt_runs_and_exports():
    """JAX's test_offline_pt_runs_and_exports on the port, with draws from
    a generator through draw_offline_uniforms."""
    grid, vol, cfg, ro, rd = setup_scene()
    u = topt.draw_offline_uniforms(torch.Generator().manual_seed(0),
                                   port_cfg(cfg), len(ro))
    assert tuple(u.shape) == (8, 4, 64)
    res = run_port(grid, vol, cfg, ro, rd, u.numpy())
    assert res.color.shape == (64, 3)
    assert res.export_pos.shape == (64, 3)
    assert res.export_dir.shape == (64, 2)
    assert torch.isfinite(res.color).all() and float(res.color.max()) > 0.0
    d = res.export_dir.numpy()
    assert d[:, 0].min() >= -np.pi - 1e-5 and d[:, 0].max() <= np.pi + 1e-5
    assert d[:, 1].min() >= -1e-5 and d[:, 1].max() <= np.pi + 1e-5
    with pytest.raises(ValueError, match="uniforms"):
        run_port(grid, vol, cfg, ro, rd, u.numpy()[:4])


def test_offline_pt_miss_is_black():
    grid, vol, cfg, _, _ = setup_scene()
    ro = np.array([[0.0, 50.0, 0.0]], np.float32)
    rd = np.array([[0.0, 1.0, 0.0]], np.float32)  # pointing away
    res = run_port(grid, vol, cfg, ro, rd, np.full((8, 4, 1), 0.5,
                                                   np.float32))
    np.testing.assert_array_equal(res.color.numpy(), 0.0)


def test_self_shadowing_denser_is_darker_and_matches_jax():
    vol = VolumeConfig(grid_shape=(8, 8, 8), box_size=(8.0, 8.0, 8.0),
                       density_factor=1.0)
    cfg = jopt.OfflinePTConfig()
    pos = np.array([[0.0, 0.0, 0.0], [1.0, -2.0, 0.5]], np.float32)
    sun = np.array([0.0, -1.0, 0.0], np.float32)
    shadows = []
    for d in (0.05, 0.9):
        grid = np.full((8, 8, 8), d, np.float32)
        t = topt.self_shadowing(tvolume.build_corner_table(torch.tensor(grid)),
                                torch.tensor(pos), torch.tensor(sun),
                                port_cfg(vol), port_cfg(cfg)).numpy()
        ref = np.asarray(jopt.self_shadowing(
            jvolume.build_corner_table(jnp.asarray(grid)), jnp.asarray(pos),
            jnp.asarray(sun), vol, cfg))
        np.testing.assert_allclose(t, ref, rtol=1e-5, atol=1e-7)
        shadows.append(t)
    assert np.all((0.0 <= shadows[1]) & (shadows[1] < shadows[0])
                  & (shadows[0] <= 1.0))


def test_sigmoid_activation_option():
    cfg = tcfg_mod.MLPConfig(in_features=8, hidden=16, out_features=3,
                             n_layers=2, activation="sigmoid",
                             output_relu=True, weight_init_std=0.5)
    params = tmlp.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((5, 8), generator=torch.Generator().manual_seed(1))
    y = tmlp.apply(params, x, cfg)
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0
