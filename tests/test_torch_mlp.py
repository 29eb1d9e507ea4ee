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
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import mlp as tmlp

RTOL, ATOL = 1e-5, 1e-6


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
    plain = fused_mlp.apply_plain(tp, torch.tensor(x), cfg).numpy()
    fn = fused_mlp.apply(tp, torch.tensor(x), cfg).numpy()
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
    out = fused_mlp.apply(_torch(params), torch.tensor(x), cfg).numpy()
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
    (fused_mlp.apply(tp, tx, cfg) ** 2).sum().backward()
    for k in gp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=RTOL,
                               atol=ATOL)


def test_init_params_layout_matches_jax():
    cfg = MLPConfig()
    jp = jmlp.init_params(jax.random.PRNGKey(0), cfg)
    tp = tmlp.init_params(torch.Generator().manual_seed(0), cfg)
    assert tmlp.layer_dims(cfg) == jmlp.layer_dims(cfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        assert tp[k].dtype == torch.float32
    assert abs(float(tp["w0"].std()) - cfg.weight_init_std) < 1e-3
    assert float(tp["b0"].abs().max()) == 0.0


def test_packed_layout_reproduces_forward():
    """The kernel's packed-weight layout, read back the way the kernel reads
    it (row-major (in, out_pad) blocks, zero pad columns), gives the plain
    forward: the wrapper's layout is checked here, the arithmetic on the
    card."""
    cfg = MLPConfig(out_features=3)
    params = _torch(_params(cfg, 5, scale=0.2))
    packed = fused_mlp.pack_params(params, cfg).numpy()
    x = np.random.default_rng(5).standard_normal((33, 64)).astype(np.float32)
    h, off, pad = x.astype(np.float64), 0, 4
    for i in range(cfg.n_layers):
        out = 64 if i < cfg.n_layers - 1 else pad
        w = packed[off:off + 64 * out].reshape(64, out)
        b = packed[off + 64 * out:off + 64 * out + out]
        off += 64 * out + out
        h = np.maximum(h @ w + b, 0.0)
    assert off == packed.size and packed.size % 4 == 0
    np.testing.assert_allclose(h[:, :3], fused_mlp.apply_plain(
        params, torch.tensor(x), cfg).numpy(), rtol=1e-5, atol=1e-6)
    assert np.all(h[:, 3:] == 0.0)


def test_cpu_tensor_takes_plain_path_and_kernel_needs_cuda():
    cfg = MLPConfig()
    params = _torch(_params(cfg, 6))
    x = torch.zeros((8, 64))
    before = fused_mlp.LAUNCHES
    fused_mlp.apply_fused(params, x, cfg)
    assert fused_mlp.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.apply_kernel(params, x, cfg)


@pytest.mark.parametrize("change,x_shape,dtype", [
    ({}, (8, 64), torch.bfloat16),
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
        fused_mlp._check_supported(x, cfg)


def test_kernel_rejects_misaligned_rows():
    cfg = MLPConfig()
    base = torch.zeros(8 * 64 + 1)
    fused_mlp._check_supported(base[:8 * 64].view(8, 64), cfg)  # aligned
    with pytest.raises(ValueError, match="aligned"):
        fused_mlp._check_supported(base[1:].view(8, 64), cfg)


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = MLPConfig()
    params = {k: v.cuda() for k, v in _torch(_params(cfg, 7, 0.2)).items()}
    for n in (1, 5, 511, 513, 4096):
        x = torch.randn((n, 64), device="cuda")
        out = fused_mlp.apply_kernel(params, x, cfg)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, fused_mlp.apply_plain(params, x, cfg),
                                   rtol=1e-4, atol=1e-5)
