"""The quality gap (ROADMAP queue 3): the ground-truth leg of the JAX
bench's quality protocol (bench.py:755-810) in both packages, each with
its own random numbers, on one scene -- the synthesized stand-in cloud
(``io/assets.py:synthesize_cloud``, seed 7, at a fifth of its grid per
axis) under the synthesized sky.

The leg: config 5's no-cache collision render (baked fields, bf16) against
the unbiased oracle (the delta sampler with ratio-tracked light and env
transmittance and MC in-scatter) through ``render_only_step``, two twin
accumulations of each, held to each other by ``noise_subtracted_bias_err``
(``utils/metrics.py``): the noise-subtracted relative RMSE and its +-2
sigma interval. Cut to the CPU: a 24x24 view, 16 spp a twin, 8 bounces,
the fields at (8, 6, 10) voxels and (8, 16) buckets. Both packages render
the same function of the same scene with independent draws, so their
intervals must overlap: if they do not, the port's leg is biased against
JAX's (a fault), not the scene.
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
from neuralradiancecaching_tpu.scene import scene as jscene
from neuralradiancecaching_tpu.utils import metrics as jmetrics
from neuralradiancecaching_tpu_torch.io import assets as tassets
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.render import frame as tframe
from neuralradiancecaching_tpu_torch.scene import scene as tscene
from neuralradiancecaching_tpu_torch.utils import metrics as tmetrics
from tests.test_torch_tiled import port_cfg

R = dataclasses.replace
SIDE, SPP = 24, 16
GRID = (25, 17, 31)  # the stand-in's 125 x 85 x 153 at a fifth per axis


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leg_cfgs():
    """(collision, oracle) configs: config 5 as the bench derives its GT
    leg (square view, cache off), cut to the CPU."""
    cfg = jcfg_mod.progressive_1080p_config()
    gt = R(cfg,
           camera=R(cfg.camera, aspect=1.0),
           render=R(cfg.render, width=SIDE, height=SIDE, use_nn=False),
           path=R(cfg.path, collision_field_steps=8, max_bounces=8),
           volume=R(cfg.volume, grid_shape=GRID, field_shape=(8, 6, 10),
                    field_dir_buckets=(8, 16)),
           env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)))
    oracle = R(gt, path=R(gt.path, sampler="delta",
                          transmittance_mode="ratio"),
               env_map=R(gt.env_map, in_scatter_mode="mc",
                         transmittance_mode="ratio"))
    return gt, oracle


def jax_leg(dens, env):
    """The JAX package's twins: keys as bench.py's (seeds 20000/24000 for
    the collision twins, 21000/25000 for the oracle's)."""
    twins = []
    for cfg, seeds in zip(leg_cfgs(), ((20000, 24000), (21000, 25000))):
        scene = jscene.make_scene(cfg, dens, env)
        state = jnrc.init_state(jax.random.PRNGKey(0), cfg)
        render = jax.jit(lambda k, cfg=cfg: jframe.render_only_step(
            state, scene, k, cfg))
        for seed in seeds:
            acc = sum(np.asarray(render(jax.random.PRNGKey(seed + i)),
                                 np.float64) for i in range(SPP))
            twins.append(acc / SPP)
    return jmetrics.noise_subtracted_bias_err(*twins)


def port_leg(dens, env):
    """The port's twins from its own seeded CPU generators."""
    twins = []
    for cfg, seeds in zip(leg_cfgs(), ((20000, 24000), (21000, 25000))):
        cfg = port_cfg(cfg)
        scene = tscene.make_scene(cfg, dens, env, device="cpu")
        state = tnrc.init_state(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        for seed in seeds:
            gen = torch.Generator().manual_seed(seed)
            acc = sum(tframe.render_only_step(state, scene, gen, cfg)
                      .numpy().astype(np.float64) for _ in range(SPP))
            twins.append(acc / SPP)
    return tmetrics.noise_subtracted_bias_err(*twins)


def test_ground_truth_leg_intervals_overlap():
    """Both packages' GT leg on the same scene, each with its own draws:
    finite, a real bias above the noise floor's share, and overlapping
    +-2 sigma intervals."""
    dens = tassets.synthesize_cloud(GRID)
    np.testing.assert_array_equal(dens, jassets.synthesize_cloud(GRID))
    env = tassets.synthesize_sky()
    ref = jax_leg(dens, jassets.synthesize_sky())
    out = port_leg(dens, env)
    print(f"GT leg {SIDE}^2 x {SPP} spp: JAX {ref}, port {out}")
    assert np.isfinite(ref).all() and np.isfinite(out).all()
    (_, _, ref_lo, ref_hi), (_, _, lo, hi) = ref, out
    assert lo <= ref_hi and ref_lo <= hi, (ref, out)
