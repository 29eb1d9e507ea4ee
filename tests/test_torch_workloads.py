"""The port's side workloads against the JAX package: the generic NN
library (``models/nn.py``), the MNIST classifier and the 2-D image fit
(their train steps from carried-over states with JAX's rebuilt batch
draws), the MNIST loaders, and the CLI's ``mnist`` and ``image-fit``
subcommands on the CPU.

Tolerances, each with its reason:
- the loaders and the synthesized digit images bit for bit (the same
  numpy code on the same seed);
- ``Sequential.apply`` 1e-6 (fp32 matmuls in another summation order);
- five train steps: loss, accuracy and parameters within 1e-5 relative
  (an absolute floor of 1e-7 for entries near 0), hash entries >= 99.9%
  within 1e-6 and all within 1e-5 relative: the table's gradient is a
  scatter-add of many terms in another order, and the guarded SGD step
  moves an entry by lr x its gradient;
- the whole workloads at the JAX tests' thresholds
  (tests/test_workloads.py): MNIST train accuracy > 0.8, the image fit
  > 18 dB.
"""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu import config as jcfg_mod
from neuralradiancecaching_tpu.config import (MLPConfig, MRHEConfig,
                                              OptimizerConfig)
from neuralradiancecaching_tpu.io import assets as jassets
from neuralradiancecaching_tpu.models import image_fit as jfit
from neuralradiancecaching_tpu.models import mnist_mlp as jmnist
from neuralradiancecaching_tpu.models import nn as jnn
from neuralradiancecaching_tpu_torch import cli
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.io import assets as tassets
from neuralradiancecaching_tpu_torch.io import exr
from neuralradiancecaching_tpu_torch.models import image_fit as tfit
from neuralradiancecaching_tpu_torch.models import mnist_mlp as tmnist
from neuralradiancecaching_tpu_torch.models import nn as tnn

STEPS = 5


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


def jax_o0(fn, *args):
    """``jax.jit(fn)(*args)`` compiled by XLA:CPU's LLVM backend at -O0
    (at the default level fused floor()/fraction pairs disagree and hash
    lookups land one cell off; tests/test_torch_render.py)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def jax_batch_indices(seed: int, steps: int, batch: int, n: int):
    """JAX's minibatch draws: randint(fold_in(PRNGKey(seed), i), (B,), 0, n)
    for step i (mnist_mlp.py:65-66, image_fit.py:87-88)."""
    key = jax.random.PRNGKey(seed)
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(key, i), (batch,), 0, n)) for i in range(steps)])


def assert_tree_close(out: dict, ref: dict):
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-5, atol=1e-7)


def write_idx_labels(path, labels: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(struct.pack(">ii", 2049, len(labels))
                     + labels.astype(np.uint8).tobytes())


def write_idx_images(path, images: np.ndarray) -> None:
    n, rows, cols = images.shape
    path.write_bytes(struct.pack(">iiii", 2051, n, rows, cols)
                     + images.astype(np.uint8).tobytes())


@pytest.fixture
def mnist_dir(tmp_path, monkeypatch):
    """Synthetic idx1 label files (seeded) in a scratch directory that the
    port's loader searches: 2048 train and 512 t10k labels."""
    rng = np.random.default_rng(11)
    d = tmp_path / "mnist"
    write_idx_labels(d / "train-labels-idx1-ubyte",
                     rng.integers(0, 10, 2048).astype(np.uint8))
    write_idx_labels(d / "t10k-labels-idx1-ubyte",
                     rng.integers(0, 10, 512).astype(np.uint8))
    monkeypatch.setattr(tassets, "MNIST_DIRS", (str(d),))
    return d


# -- nn.Sequential --------------------------------------------------------------

def test_sequential_apply_and_train_step_match_jax():
    layers_j = [jnn.Linear(4, 8), jnn.Sigmoid(), jnn.Linear(8, 8),
                jnn.Relu(), jnn.Linear(8, 2, init_std=0.5)]
    layers_t = [tnn.Linear(4, 8), tnn.Sigmoid(), tnn.Linear(8, 8),
                tnn.Relu(), tnn.Linear(8, 2, init_std=0.5)]
    net_j, net_t = jnn.Sequential(layers_j), tnn.Sequential(layers_t)
    pj = net_j.init(jax.random.PRNGKey(0))
    pt = tnn.state_from_numpy(to_np(pj), "cpu")
    mj = jax.tree_util.tree_map(jnp.zeros_like, pj)
    mt = {k: torch.zeros_like(v) for k, v in pt.items()}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    tgt = rng.standard_normal((64, 2)).astype(np.float32)
    np.testing.assert_allclose(net_t.apply(pt, torch.tensor(x)).numpy(),
                               np.asarray(net_j.apply(pj, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    opt = OptimizerConfig(learning_rate=0.1, beta1=0.5)
    for _ in range(STEPS):
        pj, mj, lj = net_j.train_step(pj, mj, jnp.asarray(x),
                                      jnp.asarray(tgt), opt)
        pt, mt, lt = net_t.train_step(pt, mt, torch.tensor(x),
                                      torch.tensor(tgt), port_cfg(opt))
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert_tree_close(pt, pj)
    assert_tree_close(mt, mj)
    # the port's own init: a generator's draws, layer by layer, on its device
    own = net_t.init(torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(pj) and own["b2"].abs().sum() == 0
    assert own["w2"].shape == (8, 2)


# -- MNIST -------------------------------------------------------------------

def test_mnist_train_steps_match_jax():
    cfg = jcfg_mod.mnist_config()
    labels = np.random.default_rng(3).integers(0, 10, 512).astype(np.uint8)
    x = jassets.synthesize_digit_images(labels).reshape(512, -1)
    y = labels.astype(np.int32)
    js = jmnist.init_state(jax.random.PRNGKey(0), cfg.mlp)
    ts = tmnist.state_from_numpy(to_np(js)._asdict(), "cpu")
    idx = jax_batch_indices(0, STEPS, 128, len(y))
    tc = port_cfg(cfg)
    for i in range(STEPS):
        js, lj, aj = jmnist.train_step(js, jnp.asarray(x[idx[i]]),
                                       jnp.asarray(y[idx[i]]), cfg.mlp,
                                       cfg.mlp_opt)
        ts, lt, at = tmnist.train_step(ts, torch.tensor(x[idx[i]]),
                                       torch.tensor(y[idx[i]]), tc.mlp,
                                       tc.mlp_opt)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        assert float(at) == float(aj)
    assert_tree_close(ts.params, js.params)
    assert_tree_close(ts.momentum, js.momentum)


def test_mnist_trains_above_chance(mnist_dir):
    """JAX tests/test_workloads.py:15-23 on the port, with the label file
    this test synthesized: 300 steps of batch 256 on 2048 rows."""
    x, y = tassets.load_mnist("train", limit=2048)
    preset = tcfg_mod.mnist_config()
    _, loss, acc = tmnist.train(x, y, preset.mlp, preset.mlp_opt, steps=300,
                                batch_size=256, device="cpu")
    assert acc > 0.8, (loss, acc)


# -- the image fit -------------------------------------------------------------

def small_fit_configs():
    """The JAX test's reduced config (tests/test_workloads.py:26-38)."""
    return (MRHEConfig(n_dims=2, n_levels=8, table_size=1024, min_res=2,
                       max_res=64, learning_rate=0.05),
            MLPConfig(in_features=16, hidden=32, out_features=3, n_layers=3,
                      output_relu=True, weight_init_std=0.05),
            OptimizerConfig(learning_rate=0.01))


def test_image_fit_train_steps_match_jax():
    """Five steps at the default configs (L=16, T=16384, the 4x64 MLP)
    from one state, with JAX's draws of fit_image's pixel batches."""
    mrhe_cfg, mlp_cfg, opt = jfit.default_configs()
    img = jassets.synthesize_sky(32, 64)
    h, w = img.shape[:2]
    flat = img.reshape(-1, 3)
    js = jfit.init_state(jax.random.PRNGKey(0), mrhe_cfg, mlp_cfg)
    ts = tfit.state_from_numpy(to_np(js)._asdict(), "cpu")
    idx = jax_batch_indices(0, STEPS, 1024, h * w)
    tm, tl, to = port_cfg(mrhe_cfg), port_cfg(mlp_cfg), port_cfg(opt)
    for i in range(STEPS):
        uv = tfit.pixel_uv(torch.tensor(idx[i]), h, w)
        vy = (idx[i] // w).astype(np.float32) / np.float32(h)
        vx = (idx[i] % w).astype(np.float32) / np.float32(w)
        np.testing.assert_array_equal(uv.numpy(), np.stack([vx, vy], -1))
        js, mj = jax_o0(lambda s, u, c: jfit.train_step(
            s, u, c, mrhe_cfg, mlp_cfg, opt), js, uv.numpy(), flat[idx[i]])
        ts, mt = tfit.train_step(ts, uv, torch.tensor(flat[idx[i]]), tm, tl,
                                 to)
        np.testing.assert_allclose(float(mt), float(mj), rtol=1e-5)
    assert_tree_close(ts.mlp_params, js.mlp_params)
    assert_tree_close(ts.mlp_momentum, js.mlp_momentum)
    ref = np.asarray(js.hash_table)
    diff = np.abs(ts.hash_table.numpy() - ref)
    assert (diff <= 1e-6).mean() >= 0.999, (diff <= 1e-6).mean()
    np.testing.assert_allclose(ts.hash_table.numpy(), ref, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(
        tfit.predict(ts, uv, tm, tl).numpy(),
        np.asarray(jfit.predict(js, jnp.asarray(uv.numpy()), mrhe_cfg,
                                mlp_cfg)), rtol=1e-5, atol=1e-6)


def test_image_fit_psnr_improves():
    """JAX tests/test_workloads.py:26-38 on the port."""
    img = tassets.synthesize_sky(32, 64)
    img = img / img.max()
    mrhe_cfg, mlp_cfg, opt = (port_cfg(c) for c in small_fit_configs())
    _, psnr = tfit.fit_image(img, steps=300, batch_size=2048,
                             mrhe_cfg=mrhe_cfg, mlp_cfg=mlp_cfg, opt=opt,
                             device="cpu")
    assert psnr > 18.0, psnr


# -- the MNIST loaders -----------------------------------------------------------

def test_idx_readers_and_digit_synthesis_match_jax(tmp_path):
    # the loader's one candidate is the checkout's data/mnist/
    assert tassets.MNIST_DIRS == (os.path.join(tassets.CACHE_DIR, "mnist"),)
    assert os.path.dirname(tassets.CACHE_DIR) == os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 10, 300).astype(np.uint8)
    images = rng.integers(0, 256, (300, 28, 28)).astype(np.uint8)
    write_idx_labels(tmp_path / "l", labels)
    write_idx_images(tmp_path / "i", images)
    for fn in ("read_idx_labels", "read_idx_images"):
        path = str(tmp_path / ("l" if fn.endswith("labels") else "i"))
        out = getattr(tassets, fn)(path)
        np.testing.assert_array_equal(out, getattr(jassets, fn)(path))
        np.testing.assert_array_equal(
            out, labels if fn.endswith("labels") else images)
    with pytest.raises(ValueError, match="idx1 magic"):
        tassets.read_idx_labels(str(tmp_path / "i"))
    for seed in (0, 3):
        out = tassets.synthesize_digit_images(labels, seed)
        ref = jassets.synthesize_digit_images(labels, seed)
        assert out.dtype == ref.dtype and out.shape == (300, 28, 28)
        np.testing.assert_array_equal(out, ref)


def test_load_mnist_reads_the_checkout_only(mnist_dir):
    """The labels from the candidate directory, images synthesized beside
    them (JAX's fallback) or read when an idx3 file lies there; no label
    file raises, and the default candidate is the checkout's data/."""
    x, y = tassets.load_mnist("train", limit=100)
    labels = tassets.read_idx_labels(str(mnist_dir / "train-labels-idx1-"
                                         "ubyte"))[:100]
    np.testing.assert_array_equal(y, labels.astype(np.int32))
    assert y.dtype == np.int32 and x.shape == (100, 784)
    np.testing.assert_array_equal(
        x, jassets.synthesize_digit_images(labels).reshape(100, -1))
    images = np.random.default_rng(6).integers(0, 256, (512, 28, 28))
    write_idx_images(mnist_dir / "t10k-images-idx3-ubyte", images)
    xt, _ = tassets.load_mnist("test")
    np.testing.assert_array_equal(
        xt, (images.astype(np.float32) / 255.0).reshape(512, -1))
    (mnist_dir / "train-labels-idx1-ubyte").unlink()
    with pytest.raises(FileNotFoundError):
        tassets.load_mnist("train")


# -- the CLI ---------------------------------------------------------------------

def test_cli_mnist_and_image_fit(mnist_dir, tmp_path, monkeypatch, capsys):
    """``mnist`` and ``image-fit`` in-process on the CPU at a few steps:
    the metrics row and the fitted image are written and finite."""
    metrics = tmp_path / "m.jsonl"
    cli.main(["--device", "cpu", "mnist", "--steps", "5", "--limit", "512",
              "--out", str(tmp_path / "o"), "--metrics", str(metrics)])
    row = json.loads(metrics.read_text().splitlines()[-1])
    assert row["step"] == 5 and all(np.isfinite(row[k]) for k in (
        "train_loss", "train_acc", "test_acc"))
    assert "mnist: loss=" in capsys.readouterr().out
    monkeypatch.setattr(tassets, "load_env_map",
                        lambda path=None: tassets.synthesize_sky(16, 32))
    out = tmp_path / "fit"
    cli.main(["--device", "cpu", "image-fit", "--steps", "3", "--out",
              str(out)])
    assert "image-fit: psnr=" in capsys.readouterr().out
    img = exr.read_exr(str(out / "image_fit.exr"))
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    assert (out / "image_fit.png").exists()


def test_cli_workloads_refuse_the_cpu_without_asking():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    for argv in (["mnist"], ["image-fit"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
