"""The port's cache MLP and its fused-kernel wrapper (K1) against the JAX
MLP and the Pallas kernel in interpreter mode, from the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6, as tests/test_pallas_mlp.py holds the
Pallas kernel to the jnp MLP (fp32, matmul accumulation order differs).
The CUDA kernel itself runs only on the card: its comparison with the
plain version skips here and is a phase of chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.config import MLPConfig
from neuralradiancecaching_tpu.ops import mlp as jmlp
from neuralradiancecaching_tpu.ops import pallas_mlp
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import mlp as tmlp
from neuralradiancecaching_tpu_torch.utils import profiling

RTOL, ATOL = 1e-5, 1e-6


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


def _params(cfg, seed, scale=None):
    """numpy params: the JAX init, optionally rescaled so activations stay
    O(1) through every layer (the 0.01 init makes outputs ~1e-8)."""
    p = jmlp.init_params(jax.random.PRNGKey(seed), cfg)
    out = {k: np.array(v) for k, v in p.items()}
    if scale is not None:
        rng = np.random.default_rng(seed)
        for k in out:
            out[k] = (rng.standard_normal(out[k].shape) * (
                scale if k.startswith("w") else 0.1)).astype(np.float32)
    return out


def _torch(params, requires_grad=False):
    return {k: torch.tensor(v, requires_grad=requires_grad)
            for k, v in params.items()}


@pytest.mark.parametrize("n", [1, 5, 511, 513, 700])
def test_plain_and_function_match_pallas_interpret(n):
    cfg = MLPConfig()
    params = _params(cfg, n, scale=0.2)
    x = (np.random.default_rng(n).standard_normal((n, 64)) * 0.5).astype(
        np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref_pallas = np.asarray(pallas_mlp.apply_fused(jp, jnp.asarray(x), cfg,
                                                   interpret=True))
    ref_mlp = np.asarray(jmlp.apply(jp, jnp.asarray(x), cfg))
    tp = _torch(params)
    plain = fused_mlp.apply_plain(tp, torch.tensor(x), port_cfg(cfg)).numpy()
    fn = fused_mlp.apply(tp, torch.tensor(x), port_cfg(cfg)).numpy()
    assert plain.shape == fn.shape == (n, 3)
    for ref in (ref_pallas, ref_mlp):
        np.testing.assert_allclose(plain, ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(fn, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activation,output_relu",
                         [("relu", True), ("relu", False),
                          ("sigmoid", True)])
def test_activations_match_jax(activation, output_relu):
    cfg = MLPConfig(activation=activation, output_relu=output_relu,
                    n_layers=4, out_features=5)
    params = _params(cfg, 3, scale=0.2)
    x = np.random.default_rng(3).standard_normal((257, 64)).astype(np.float32)
    ref = np.asarray(pallas_mlp.apply_fused(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), cfg,
        interpret=True))
    out = fused_mlp.apply(_torch(params), torch.tensor(x),
                          port_cfg(cfg)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_gradients_match_custom_vjp():
    cfg = MLPConfig(in_features=16, hidden=32, out_features=3, n_layers=2,
                    weight_init_std=0.1)
    params = _params(cfg, 3)
    x = np.random.default_rng(4).standard_normal((64, 16)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p, xx):
        return jnp.sum(pallas_mlp.apply(p, xx, cfg) ** 2)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = _torch(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    (fused_mlp.apply(tp, tx, port_cfg(cfg)) ** 2).sum().backward()
    for k in gp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)


def test_init_params_layout_matches_jax():
    cfg = MLPConfig()
    jp = jmlp.init_params(jax.random.PRNGKey(0), cfg)
    tp = tmlp.init_params(torch.Generator().manual_seed(0), port_cfg(cfg))
    assert tmlp.layer_dims(port_cfg(cfg)) == jmlp.layer_dims(cfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        assert tp[k].dtype == torch.float32
    assert abs(float(tp["w0"].std()) - cfg.weight_init_std) < 1e-3
    assert float(tp["b0"].abs().max()) == 0.0


def test_packed_layout_reproduces_forward():
    """The kernel's packed-weight layout, read back the way the kernel reads
    it (per layer the bf16 pieces of W^T in the 128-byte swizzle, summed;
    the output layer's 8 rows zero-padded; then the fp32 biases), gives the
    plain forward: the wrapper's layout is checked here, the arithmetic on
    the card."""
    cfg = MLPConfig(out_features=3)
    params = _torch(_params(cfg, 5, scale=0.2))
    packed = fused_mlp.pack_params(params, port_cfg(cfg))
    assert not packed.bf16 and packed.buffer.dtype == torch.uint8
    raw = packed.buffer.numpy()
    x = np.random.default_rng(5).standard_normal((33, 64)).astype(np.float32)
    ws, off, pad = [], 0, 8
    for i in range(cfg.n_layers):
        rows = 64 if i < cfg.n_layers - 1 else pad
        index = fused_mlp.swizzle_index(rows).numpy()
        wt = np.zeros((rows, 64))
        for _ in range(3):  # hi, mid, lo
            words = raw[off:off + rows * 128].view(np.uint16)
            piece = (words.astype(np.uint32) << 16).view(np.float32)
            wt += piece[index].reshape(rows, 64)
            off += rows * 128
        ws.append(wt.T)
    biases = raw[off:].view(np.float32)
    h, boff = x.astype(np.float64), 0
    for i, w in enumerate(ws):
        b = biases[boff:boff + w.shape[1]]
        boff += w.shape[1]
        h = np.maximum(h @ w + b, 0.0)
    assert boff == 64 * (cfg.n_layers - 1) + pad
    assert off + 4 * boff == raw.size and raw.size % 16 == 0
    np.testing.assert_allclose(h[:, :3], fused_mlp.apply_plain(
        params, torch.tensor(x), cfg).numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(h[:, 3:] == 0.0)


def test_cpu_tensor_takes_plain_path_and_kernel_needs_cuda():
    cfg = MLPConfig()
    params = _torch(_params(cfg, 6))
    x = torch.zeros((8, 64))
    with profiling.tracing("cpu") as rec, rec.frame(0):
        fused_mlp.apply_fused(params, x, port_cfg(cfg))
    # the plain version is no launch: no k1 span, no launch counted
    assert [(r.name, r.counts) for r in rec.records()] == [("frame", {})]
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.apply_kernel(params, x, port_cfg(cfg))


@pytest.mark.parametrize("change,x_shape,dtype", [
    ({}, (8, 64), torch.float16),  # float32 and bf16 rows only
    ({}, (8, 128), torch.float32),  # non-contiguous slice below
    ({}, (8, 32), torch.float32),
    ({"hidden": 32}, (8, 64), torch.float32),
    ({"out_features": 65}, (8, 64), torch.float32),
    ({"n_layers": 1}, (8, 64), torch.float32),
    ({"activation": "tanh"}, (8, 64), torch.float32),
])
def test_kernel_rejects_unsupported(change, x_shape, dtype):
    cfg = dataclasses.replace(MLPConfig(), **change)
    x = torch.zeros(x_shape, dtype=dtype)
    if x_shape[1] == 128:
        x = x[:, :64]
    with pytest.raises(ValueError):
        fused_mlp._check_supported(x, port_cfg(cfg))


def test_kernel_rejects_misaligned_rows():
    cfg = MLPConfig()
    base = torch.zeros(8 * 64 + 1)
    fused_mlp._check_supported(base[:8 * 64].view(8, 64),
                               port_cfg(cfg))  # aligned
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp._check_supported(base[1:].view(8, 64), port_cfg(cfg))


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MLPConfig()
    params = {k: v.cuda() for k, v in _torch(_params(cfg, 7, 0.2)).items()}
    packed = fused_mlp.pack_params(params, port_cfg(cfg))
    plain_pack = fused_mlp.pack_params_plain(params, port_cfg(cfg))
    assert torch.equal(packed.buffer, plain_pack.buffer.cuda())
    for n in (1, 5, 63, 65, 127, 129, 511, 513, 4096):
        x = torch.randn((n, 64), device="cuda")
        out = fused_mlp.apply_kernel(params, x, port_cfg(cfg))
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out, fused_mlp.apply_plain(params, x, port_cfg(cfg)),
            rtol=1e-4, atol=1e-5)
    x[3, 5], x[64, 0] = float("nan"), float("inf")
    out = fused_mlp.launch(packed, x, port_cfg(cfg))
    torch.cuda.synchronize()
    assert not torch.isfinite(out[[3, 64]]).any()
    assert torch.isfinite(out[[0, 4, 63, 65]]).all()
