"""The port's CLI and its I/O against the JAX package's.

- ``cli.main([... "--device", "cpu", ...])`` in-process for each rendering
  subcommand -- ``pathtrace`` with each sampler and spp 2, ``nrc-online``
  with a checkpoint and a resume under another sampler, ``progressive``
  banded (packed) and unbanded -- at 32x32 on a reduced preset and cloud
  (the full-grid bake is too slow on the CPU, as tests/test_cli.py says of
  the JAX CLI), the banded render forced by a small band: the EXR, PNG and
  JSONL exist and are finite. ``_band_rows`` equals JAX's; without CUDA and
  without ``--device cpu`` the CLI exits non-zero.
- Checkpoints cross-load between the packages both ways with equal arrays;
  ``config_hash`` equals JAX's for configs 3, 4 and 5; shape, dtype and
  config-hash mismatches raise ``ValueError`` and an SGD template takes an
  Adam checkpoint's shared leaves (tests/test_workloads.py:41,78,124).
- EXR and PNG files written by either package read back equal in the
  other; ``fly_through_position`` and ``uniform_sphere`` equal JAX's.
- The asset loaders look in the checkout's ``data/`` in the JAX package's
  order and load what it loads from the same files (queue-3 fault F1 of
  ROADMAP.md).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import cli as jcli
from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.io import checkpoint as jck
from neuralradiancecaching_tpu.io import exr as jexr
from neuralradiancecaching_tpu.models import nrc as jnrc
from neuralradiancecaching_tpu.ops import phase as jphase
from neuralradiancecaching_tpu.scene import camera as jcam
from neuralradiancecaching_tpu_torch import cli as tcli
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.io import assets as tassets
from neuralradiancecaching_tpu_torch.io import checkpoint as tck
from neuralradiancecaching_tpu_torch.io import exr as texr
from neuralradiancecaching_tpu_torch.models import nrc as tnrc
from neuralradiancecaching_tpu_torch.ops import phase as tphase
from neuralradiancecaching_tpu_torch.scene import camera as tcam
from tests.test_torch_tiled import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = dataclasses.replace
SIDE, BAND = 32, 8
GRID = (16, 12, 20)
PRESETS = ("pathtrace_config", "nrc_online_config",
           "progressive_1080p_config")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors (the
    suite runs several test workers on the same cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(cfg):
    """A preset cut to the tests' scale: the render tests' scene grid and
    fields, a 16x16 train grid of 16-slot target walks."""
    return R(cfg, path=R(cfg.path, collision_field_steps=8),
             volume=R(cfg.volume, grid_shape=GRID, field_shape=(6, 5, 8),
                      field_dir_buckets=(8, 16)),
             env_map=R(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=R(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


@pytest.fixture
def small_cli(monkeypatch):
    """The port's CLI on reduced presets, a seeded random cloud and the
    small synthesized sky, with frames above 16x16 banded in 8-row
    bands."""
    for name in PRESETS:
        full = getattr(tcfg_mod, name)
        monkeypatch.setattr(tcfg_mod, name,
                            lambda *a, full=full, **k: reduced(full(*a, **k)))
    dens = np.random.default_rng(0).random(GRID, dtype=np.float32) * 0.5
    monkeypatch.setattr(tassets, "load_cloud", lambda path=None: dens)
    monkeypatch.setattr(tassets, "load_env_map",
                        lambda path=None: tassets.synthesize_sky(32, 64))
    monkeypatch.setattr(tcli, "_band_rows", lambda w, h, n_dev=1:
                        BAND if w * h > 16 * 16 else None)
    return tcli


def run_cli(cli, tmp_path, *argv, side=SIDE):
    metrics = tmp_path / "m.jsonl"
    cli.main(["--device", "cpu", *argv, "--width", str(side), "--height",
              str(side), "--out", str(tmp_path), "--metrics", str(metrics)])
    return [json.loads(line) for line in open(metrics)]


def check_outputs(tmp_path, name, rows, side=SIDE):
    img = texr.read_exr(str(tmp_path / f"{name}.exr"))
    assert img.shape == (side, side, 3) and np.isfinite(img).all()
    assert img.mean() > 0.0
    png = (tmp_path / f"{name}.png").read_bytes()
    assert png.startswith(b"\x89PNG")
    assert rows and all(np.isfinite(r["frame_s"]) and r["frame_s"] > 0
                        for r in rows)
    return img


def test_band_rows_matches_jax():
    for w, h in [(800, 800), (1920, 1080), (512, 512), (513, 512),
                 (64, 64), (864, 432), (1000, 999)]:
        assert tcli._band_rows(w, h) == jcli._band_rows(w, h)
    assert tcli._band_rows(800, 800) == 32
    assert tcli._band_rows(1920, 1080) == 30


@pytest.mark.parametrize("argv", [
    ("--sampler", "reference"), ("--sampler", "collision"),
    ("--sampler", "delta", "--spp", "2")])
def test_pathtrace_on_cpu(small_cli, tmp_path, argv):
    rows = run_cli(small_cli, tmp_path, "pathtrace", *argv)
    check_outputs(tmp_path, "pathtrace", rows)
    assert len(rows) == 1 and np.isfinite(rows[0]["mean"])


def test_nrc_online_checkpoint_and_resume_on_cpu(small_cli, tmp_path):
    """Two banded frames and a checkpoint; then a resume under the delta
    sampler, which takes JAX's fallback to the pre-override sampler's
    hash and continues the Adam counter; the unbanded frame_step below
    the band threshold."""
    ck = str(tmp_path / "ck")
    rows = run_cli(small_cli, tmp_path, "nrc-online", "--frames", "2",
                   "--checkpoint", ck)
    check_outputs(tmp_path, "nrc_online", rows)
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["mse"]) for r in rows)
    meta = tck.load_metadata(ck)
    cfg = reduced(tcfg_mod.nrc_online_config(SIDE, SIDE))
    assert meta["config_hash"] == tck.config_hash(
        R(cfg, camera=R(cfg.camera, aspect=1.0)))
    resumed = tmp_path / "resumed"
    rows = run_cli(small_cli, resumed, "nrc-online", "--frames", "1",
                   "--resume", ck, "--sampler", "delta", "--checkpoint",
                   str(resumed / "ck"))
    check_outputs(resumed, "nrc_online", rows)
    like = tnrc.init_state(torch.Generator().manual_seed(0), cfg, "cpu")
    assert int(tck.load(str(resumed / "ck"), like).opt_step) == 3
    small = tmp_path / "small"
    rows = run_cli(small_cli, small, "nrc-online", "--frames", "1", side=16)
    check_outputs(small, "nrc_online", rows, side=16)


@pytest.mark.parametrize("argv,side", [
    (("--sync-every", "1"), SIDE),
    (("--band-rows", str(BAND // 2), "--sampler", "delta"), SIDE),
    (("--live-pack", "off"), SIDE),
    ((), 16)])
def test_progressive_on_cpu(small_cli, tmp_path, argv, side):
    """Banded over the live-ray pack (collision, a row per frame; delta's
    deferred shade with --band-rows), banded without the pack, and
    unbanded through frame_step (16x16)."""
    rows = run_cli(small_cli, tmp_path, "progressive", "--frames", "2",
                   *argv, side=side)
    check_outputs(tmp_path, "progressive", rows, side=side)
    assert len(rows) == (2 if "--sync-every" in argv else 1)
    assert all(np.isfinite(r["mse"]) for r in rows)
    assert sum(r["frames"] for r in rows) == 2


def test_cli_without_cuda_exits_nonzero():
    """No card and no --device cpu: an error, never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "neuralradiancecaching_tpu_torch.cli",
         "pathtrace", "--width", "8", "--height", "8"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


def random_leaves(tree, seed):
    """A JAX state with every leaf replaced by seeded random values of its
    shape and dtype."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(
            rng.integers(0, 100, x.shape).astype(x.dtype)
            if jnp.issubdtype(x.dtype, jnp.integer)
            else rng.standard_normal(x.shape).astype(x.dtype)), tree)


def jax_leaves(state):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def port_leaves(state):
    return {name: x.numpy() for name, x in tck._named_leaves(state)}


@pytest.mark.parametrize("adam", [True, False])
def test_checkpoint_cross_loads_both_ways(tmp_path, adam):
    jcfg = jcfg_mod.nrc_online_config(16, 16)
    if not adam:
        jcfg = R(jcfg, mlp_opt=jcfg_mod.OptimizerConfig(),
                 mrhe=R(jcfg.mrhe, optimizer="sgd"))
    tcfg = port_cfg(jcfg)
    jstate = random_leaves(jnrc.init_state(jax.random.PRNGKey(0), jcfg), 1)
    like = tnrc.init_state(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert (like.opt_step is not None) == adam
    # JAX -> port
    jck.save(str(tmp_path / "j"), jstate,
             metadata={"config_hash": jck.config_hash(jcfg)})
    tstate = tck.load(str(tmp_path / "j"), like,
                      expect_config_hash=tck.config_hash(tcfg))
    want = jax_leaves(jstate)
    got = port_leaves(tstate)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # port -> JAX, from other values
    tstate = tnrc.state_from_numpy(jax.tree_util.tree_map(
        np.asarray, random_leaves(jstate, 2))._asdict(), "cpu")
    tck.save(str(tmp_path / "t.npz"), tstate,
             metadata={"config_hash": tck.config_hash(tcfg)})
    back = jck.load(str(tmp_path / "t"), jstate,
                    expect_config_hash=jck.config_hash(jcfg))
    got, want = jax_leaves(back), port_leaves(tstate)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert jck.load_metadata(str(tmp_path / "t")) == tck.load_metadata(
        str(tmp_path / "t.npz"))


def test_config_hash_matches_jax():
    for jcfg, tcfg in [
            (jcfg_mod.pathtrace_config(), tcfg_mod.pathtrace_config()),
            (jcfg_mod.pathtrace_config(64, 32, 2),
             tcfg_mod.pathtrace_config(64, 32, 2)),
            (jcfg_mod.nrc_online_config(), tcfg_mod.nrc_online_config()),
            (jcfg_mod.progressive_1080p_config(),
             tcfg_mod.progressive_1080p_config())]:
        assert tck.config_hash(tcfg) == jck.config_hash(jcfg)
        assert tck.config_hash(port_cfg(jcfg)) == jck.config_hash(jcfg)
    assert (tck.config_hash(tcfg_mod.pathtrace_config())
            != tck.config_hash(tcfg_mod.nrc_online_config()))


def test_checkpoint_rejects_mismatches(tmp_path):
    cfg = tcfg_mod.nrc_online_config(16, 16)
    st = tnrc.init_state(torch.Generator().manual_seed(0), cfg, "cpu")
    path = str(tmp_path / "ck")
    tck.save(path, st, metadata={"config_hash": tck.config_hash(cfg)})
    tck.load(path, st, expect_config_hash=tck.config_hash(cfg))  # ok
    with pytest.raises(ValueError, match="config hash"):
        tck.load(path, st, expect_config_hash="0" * 16)
    bf16 = dataclasses.replace(st, hash_table=st.hash_table.bfloat16())
    with pytest.raises(ValueError, match="dtype"):
        tck.load(path, bf16)
    wide = dataclasses.replace(st, hash_table=torch.zeros(
        (st.hash_table.shape[0] + 1,) + st.hash_table.shape[1:]))
    with pytest.raises(ValueError, match="shape"):
        tck.load(path, wide)
    # an SGD template takes an Adam checkpoint's shared leaves; the config
    # guard is the hash, not the tree
    sgd_cfg = R(cfg, mlp_opt=tcfg_mod.OptimizerConfig(),
                mrhe=R(cfg.mrhe, optimizer="sgd"))
    sgd = tnrc.init_state(torch.Generator().manual_seed(5), sgd_cfg, "cpu")
    warm = tck.load(path, sgd)
    assert warm.mlp_second is None and warm.opt_step is None
    torch.testing.assert_close(warm.mlp_params["w0"], st.mlp_params["w0"],
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tck.load(path, sgd, expect_config_hash=tck.config_hash(sgd_cfg))
    # an SGD checkpoint lacks the Adam leaves an Adam template asks for
    tck.save(str(tmp_path / "sgd"), sgd)
    with pytest.raises(ValueError, match="missing"):
        tck.load(str(tmp_path / "sgd"), st)


@pytest.mark.parametrize("half", [True, False])
def test_exr_and_png_match_jax(tmp_path, half):
    rng = np.random.default_rng(3)
    img = (rng.random((5, 7, 3)) * 4.0).astype(np.float32)
    texr.write_exr(str(tmp_path / "t.exr"), img, half=half)
    jexr.write_exr(str(tmp_path / "j.exr"), img, half=half)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    back = texr.read_exr(str(tmp_path / "j.exr"))
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(jexr.read_exr(str(tmp_path / "t.exr")), back)
    texr.write_png(str(tmp_path / "t.png"), texr.tonemap(img))
    jexr.write_png(str(tmp_path / "j.png"), jexr.tonemap(img))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_trajectories_and_uniform_sphere_match_jax():
    p0, d0 = tcam.fly_through_position(0, 10)
    p9, d9 = tcam.fly_through_position(9, 10)
    np.testing.assert_allclose(p0, [0, 0, -64])
    np.testing.assert_allclose(p9, [0, 0, -20])
    np.testing.assert_allclose(d0, [0, 0, 1])
    for f in range(10):
        for a, b in zip(tcam.fly_through_position(f, 10),
                        jcam.fly_through_position(f, 10)):
            np.testing.assert_array_equal(a, np.asarray(b))
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jphase.uniform_sphere(key, (64,)))
    k1, k2 = jax.random.split(key)
    u = torch.tensor(np.stack([np.asarray(jax.random.uniform(k, (64,)))
                               for k in (k1, k2)]))
    got = tphase.uniform_sphere((64,), uniforms=u).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    d = tphase.uniform_sphere((4096,), torch.Generator().manual_seed(0))
    torch.testing.assert_close(torch.linalg.vector_norm(d, dim=-1),
                               torch.ones(4096))
    assert float(d.mean(0).abs().max()) < 0.05


def write_hdr(path, rgbe: np.ndarray) -> None:
    """A flat (non-RLE) Radiance .hdr of the given RGBE bytes."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w, _ = rgbe.shape
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.astype(np.uint8).tobytes())


def test_assets_match_jax_on_the_same_files(tmp_path, monkeypatch):
    """F1: the port looks only in its checkout's data/, in the JAX
    package's order; with both packages' candidates pointed at one data
    directory in the reference's layout they load equal arrays."""
    for f in tassets.CLOUD_FILES + tassets.ENV_FILES:
        assert f.startswith(os.path.join(REPO, "data") + os.sep)
    data = tmp_path / "data"
    monkeypatch.setattr(jassets, "REFERENCE_DATA", str(data))
    monkeypatch.setattr(jassets, "CACHE_DIR", str(data))
    for name in ("CLOUD_FILES", "ENV_FILES"):
        monkeypatch.setattr(tassets, name, tuple(
            f.replace(tassets.CACHE_DIR, str(data))
            for f in getattr(tassets, name)))
    rng = np.random.default_rng(4)
    # the small map of the checkout's own data only: both take it
    write_hdr(str(data / "photostudio.hdr"),
              rng.integers(100, 255, (4, 6, 4)))
    a, b = tassets.load_env_map(), jassets.load_env_map()
    assert a.shape == (4, 6, 3)
    np.testing.assert_array_equal(a, b)
    # the reference's layout comes first
    write_hdr(str(data / "image" / "photostudio.hdr"),
              rng.integers(100, 255, (3, 5, 4)))
    a, b = tassets.load_env_map(), jassets.load_env_map()
    assert a.shape == (3, 5, 3)
    np.testing.assert_array_equal(a, b)
    # the cloud likewise
    dens = rng.random(tassets.CLOUD_SHAPE, dtype=np.float32)
    dens.tofile(str(data / "cloud_sixteenth"))
    np.testing.assert_array_equal(tassets.load_cloud(), dens)
    np.testing.assert_array_equal(jassets.load_cloud(), dens)
