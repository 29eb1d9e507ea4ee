"""``config.reference_exact()`` -- the reference application's exact frame
-- through the port against the benchmark's frozen plain copy
(``benchmark/reference``: plain PyTorch in float32, importing neither JAX
nor the port), as the benchmark's configuration
``benchmark/configs/config_reference_exact_800.json`` states it, cut only
in scale: a 32x32 image, the (16, 12, 20) grid, a 16x16 train grid and 8
bounces. Both packages start from the same seeded random weights, and
both take the same draws (the reference's draw functions, handed to the
port through its uniform seams) for two whole ``frame_step``s from one
carried-over state: the 8-bit quantized scene, the unjittered train batch,
the quadrature transmittance on every segment and sky ray, momentum SGD
on the MLP and plain SGD on the hash table, the render with the cache
query.

Tolerances, each with its reason (every gap is ||a - b|| / ||b|| in
float64):
- the image and the mse within 1e-5: the same float32 operations on the
  same device; a sum taken in another order moves a pixel by a few ulps
  (~1e-7), while a walk whose scatter or roulette test flips on such a
  difference moves its whole pixel, which the bound still lets through
  only if it is a pixel in ~1e5 of the frame's energy;
- every leaf of the state after each step (each MLP weight and bias, its
  momentum, the hash table) within 1e-5: momentum SGD and plain SGD are
  linear in the gradient, with no Adam eps to turn a rounding-level
  gradient into a step of +-lr, so the leaves move by the gradients'
  rounding alone;
- the Adam fields None on both sides (the preset trains by SGD).

A broken path fails them: the momentum dropped from the MLP's step.
"""

import dataclasses
import json

import pytest
import torch

from benchmark import scene_data
from benchmark.spec import BENCH_DIR, PROGRAM, REFERENCE, Pkg, build_config
from benchmark.tests.test_bench_exact import no_momentum

CONF = json.loads((BENCH_DIR / "configs" / "config_reference_exact_800.json")
                  .read_text())
CUT = {"render.width": 32, "render.height": 32,
       "volume.grid_shape": [16, 12, 20], "train.train_width": 16,
       "train.train_height": 16, "path.max_bounces": 8}
TOL = 1e-5
FRAMES = 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the eager ops on small tensors (the suite
    runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den else (0.0 if num == 0.0 else float("inf"))


def leaves(state) -> dict:
    out = {f"mlp.{k}": v for k, v in state.mlp_params.items()}
    out.update({f"momentum.{k}": v for k, v in state.mlp_momentum.items()})
    out["hash_table"] = state.hash_table
    return out


def run_frames(package: str) -> list:
    """``FRAMES`` frame_steps of ``package`` from its seeded initial state
    on the draws of the reference: [(state leaves, image, mse)]."""
    pkg, ref = Pkg(package), Pkg(REFERENCE)
    cfg = build_config(pkg, CONF, CUT)
    rcfg = build_config(ref, CONF, CUT)
    scene = pkg.scene.make_scene(
        cfg, scene_data.synthesize_cloud(cfg.volume.grid_shape),
        scene_data.synthesize_sky(), device="cpu")
    state = pkg.nrc.init_state(torch.Generator().manual_seed(11), cfg,
                               device="cpu")
    n = cfg.render.width * cfg.render.height
    out = []
    for i in range(FRAMES):
        gen = torch.Generator().manual_seed(100 + i)
        train_u = ref.targets.draw_train_uniforms(rcfg, gen, "cpu")
        render_u = ref.pathtrace.draw_path_uniforms(rcfg, n, True, gen,
                                                    "cpu")
        state, res = pkg.frame.frame_step(
            state, scene, None, cfg, train_uniforms=pkg.adopt(train_u),
            uniforms=pkg.adopt(render_u))
        assert (state.mlp_second is None and state.hash_momentum is None
                and state.hash_second is None)
        out.append(({k: v.clone() for k, v in leaves(state).items()},
                    res.image.clone(), res.mse.clone()))
    return out


def gaps(prog: list, ref: list) -> dict:
    """The worst gap of each kind over the frames."""
    out = {"image": 0.0, "mse": 0.0, "leaf": 0.0}
    for (p_leaves, p_img, p_mse), (r_leaves, r_img, r_mse) in zip(prog, ref):
        assert p_leaves.keys() == r_leaves.keys()
        out["image"] = max(out["image"], rel(p_img, r_img))
        out["mse"] = max(out["mse"], rel(p_mse, r_mse))
        out["leaf"] = max(out["leaf"], max(rel(p_leaves[k], r_leaves[k])
                                           for k in r_leaves))
    return out


@pytest.fixture(scope="module")
def reference():
    return run_frames(REFERENCE)


def test_the_configuration_is_the_reference_exact_preset():
    cfg = build_config(Pkg(PROGRAM), CONF, CUT)
    assert dataclasses.asdict(cfg.quirks) == {
        f.name: True for f in dataclasses.fields(cfg.quirks)}
    assert (cfg.path.transmittance_mode, cfg.env_map.transmittance_mode) \
        == ("quadrature", "quadrature")
    assert (cfg.mlp_opt.kind, cfg.mrhe.optimizer) == ("momentum", "sgd")
    assert cfg.path.compact_events == 0.0
    assert cfg.render.query_cap_fraction == 1.0
    assert not cfg.train.jitter_train_grid and cfg.train.env_samples == 0


def test_two_frames_match_the_plain_reference(reference):
    got = gaps(run_frames(PROGRAM), reference)
    assert all(v <= TOL for v in got.values()), got
    # the frames did something: the state moved and the image is lit
    (l0, img, _), (l1, _, _) = reference
    assert float(img.abs().sum()) > 0.0
    assert any(rel(l1[k], l0[k]) > 0.0 for k in l0)


def test_a_dropped_momentum_fails_the_comparison(reference, monkeypatch):
    """The leaves catch a broken optimizer (a broken quadrature fails the
    cell's own run in ``benchmark/tests/test_bench_exact.py``)."""
    no_momentum(monkeypatch)
    got = gaps(run_frames(PROGRAM), reference)
    assert got["leaf"] > TOL, got
