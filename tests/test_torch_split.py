"""The numeric design of the tensor-core kernels K1 and K2, on the CPU.

Both kernels compute fp32 functions on Hopper's tensor cores by splitting
each fp32 operand into narrow pieces whose products are exact:
- K1 (``csrc/fused_mlp.cu``): every fp32 value into three bf16 pieces
  hi + mid + lo (``fused_mlp.split_bf16``), which sum to it exactly; the
  f32 mode keeps the six products of order >= 2^-16, the bf16 mode (bf16
  weights and rows, one piece) three passes over the split activations;
- K2 (``csrc/matmul.cu``): each operand into two TF32 pieces big + small
  (``matmul.split_tf32``), C = big.big + small.big + big.small, each
  stage's 32-deep sum added into an fp32 total.

(a) The wrapper's splits reconstruct what they split: K1's bit for bit
(f32 weights and activations in three pieces, bf16-mode weights in one),
K2's within 2^-22 |x| (TF32 pieces keep 11 significant bits each).

(b) A numpy emulation of each kernel's arithmetic -- pieces rounded as the
kernel rounds them, products formed exactly (float64), every MMA's sum
rounded to fp32 in the kernel's order -- holds to the JAX package's Pallas
kernels in interpreter mode at the card's unchanged bounds: K1 at 1e-5 +
1e-4 |ref| (chip_smoke.py's bound for K1 against its plain version), K2 at
2e-4 + 2e-4 |ref| (tests/test_nn_matmul.py's bound for the Pallas kernel).
The emulation rounds each sum to nearest where the tensor core rounds
toward zero; that is the order-of-summation freedom the bounds allow.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.config import MLPConfig
from neuralradiancecaching_tpu.ops import pallas_matmul, pallas_mlp
from neuralradiancecaching_tpu_torch import config as tcfg_mod
from neuralradiancecaching_tpu_torch.ops import fused_mlp
from neuralradiancecaching_tpu_torch.ops import matmul as tmm

K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_TOL = 2e-4
# K1's passes in issue order, (activation piece, weight piece), 0 = hi
F32_PASSES = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
BF16_PASSES = ((2, 0), (1, 0), (0, 0))


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


def _values(n, seed):
    """fp32 values across magnitudes and signs, with exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    x[::17] = 0.0
    return x.astype(np.float32)


# ---- numpy emulation of the kernels' rounding ---------------------------

def bf16_rn(x):
    """fp32 -> the nearest bf16 value (ties to even), as fp32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split3(v):
    """K1's split of fp32 v into hi, mid, lo (fp32 arithmetic)."""
    v = np.asarray(v, np.float32)
    hi = bf16_rn(v)
    rest = (v - hi).astype(np.float32)
    mid = bf16_rn(rest)
    return hi, mid, bf16_rn((rest - mid).astype(np.float32))


def tf32_rna(x):
    """fp32 -> the nearest TF32 value (ties away from zero), as fp32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def mma_sum(acc, a, b, k_step):
    """acc + a @ b as MMAs of depth k_step: each step's exact sum (float64)
    added into the fp32 accumulator and rounded to fp32."""
    for k0 in range(0, a.shape[1], k_step):
        part = (a[:, k0:k0 + k_step].astype(np.float64)
                @ b[k0:k0 + k_step].astype(np.float64))
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def emulate_k1(params, x, cfg, bf16):
    """K1's forward: pieces of the rows, weights and activations, the
    mode's passes of 16-deep MMAs into one fp32 accumulator per layer, the
    fp32 bias and activation, the next layer's split."""
    p = {k: np.asarray(v, np.float32) for k, v in params.items()}
    if bf16:
        p = {k: bf16_rn(v) for k, v in p.items()}
        acts = (bf16_rn(x),)
    else:
        acts = split3(x)
    for i in range(cfg.n_layers):
        w, b = p[f"w{i}"], p[f"b{i}"]
        ws = (w,) if bf16 else split3(w)
        if bf16:
            passes = ((0, 0),) if i == 0 else BF16_PASSES
        else:
            passes = F32_PASSES
        acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for pa, pw in passes:
            acc = mma_sum(acc, acts[pa], ws[pw], 16)
        h = (acc + b).astype(np.float32)
        if i < cfg.n_layers - 1 or cfg.output_relu:
            h = np.where(h < 0, np.float32(0), h)
        acts = split3(h)
    return h


def emulate_k2(a, b):
    """K2's product: TF32 pieces, per 32-deep stage the three products as
    8-deep MMAs into a fresh fp32 accumulator, added into the fp32
    total."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    a_s, b_s = tf32_rna(a - ab), tf32_rna(b - bb)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 32):
        acc = np.zeros_like(total)
        for k1 in range(k0, min(k0 + 32, a.shape[1]), 8):
            s = slice(k1, min(k1 + 8, a.shape[1]))
            for x, y in ((a_s, bb), (ab, b_s), (ab, bb)):
                acc = mma_sum(acc, x[:, s], y[s], 8)
        total = (total + acc).astype(np.float32)
    return total


def _mlp_params(cfg, seed):
    """O(1) weights (He-scaled), so activations stay O(1) through every
    layer, and 0.1-scale biases."""
    rng = np.random.default_rng(seed)
    dims = [cfg.in_features] + [cfg.hidden] * (cfg.n_layers - 1) + [
        cfg.out_features]
    out = {}
    for i in range(cfg.n_layers):
        out[f"w{i}"] = (rng.standard_normal((dims[i], dims[i + 1]))
                        * np.sqrt(2.0 / dims[i])).astype(np.float32)
        out[f"b{i}"] = (rng.standard_normal(dims[i + 1]) * 0.1).astype(
            np.float32)
    return out


# ---- (a) the splits reconstruct what they split --------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_k1_split_reconstructs_bit_for_bit(seed):
    v = _values(4096, seed)
    pieces = fused_mlp.split_bf16(torch.tensor(v), 3)
    assert all(p.dtype == torch.bfloat16 for p in pieces)
    total = sum(p.double() for p in pieces)
    assert np.array_equal(total.numpy().astype(np.float32), v)
    assert np.array_equal(total.numpy(), v.astype(np.float64))
    # the emulation's independent rounding gives the same pieces
    for got, ref in zip(pieces, split3(v)):
        assert np.array_equal(got.float().numpy(), ref)


def test_k1_bf16_weights_take_one_piece():
    w = torch.tensor(_values(4096, 2)).to(torch.bfloat16).float()
    hi, mid, lo = fused_mlp.split_bf16(w, 3)
    assert torch.equal(hi.float(), w)
    assert not mid.float().any() and not lo.float().any()
    (only,) = fused_mlp.split_bf16(w, 1)
    assert torch.equal(only.float(), w)


@pytest.mark.parametrize("bf16", [False, True])
def test_k1_packed_weights_reconstruct(bf16):
    """Every weight read back from the pack step's buffer (unswizzled, its
    pieces summed) is the weight the kernel must use, bit for bit; the
    output layer's pad rows are zero."""
    cfg = MLPConfig(out_features=3)
    params = _mlp_params(cfg, 3)
    packed = fused_mlp.pack_params({k: torch.tensor(v) for k, v in
                                    params.items()}, port_cfg(cfg), bf16)
    raw, off = packed.buffer.numpy(), 0
    n_pieces = 1 if bf16 else 3
    for i in range(cfg.n_layers):
        rows = 64 if i < cfg.n_layers - 1 else 8
        index = fused_mlp.swizzle_index(rows).numpy()
        total = np.zeros((rows, 64))
        for _ in range(n_pieces):
            words = raw[off:off + rows * 128].view(np.uint16)
            piece = (words.astype(np.uint32) << 16).view(np.float32)
            total += piece[index].reshape(rows, 64)
            off += rows * 128
        want = params[f"w{i}"].T
        want = bf16_rn(want) if bf16 else want
        assert np.array_equal(total[:want.shape[0]], want)
        assert not total[want.shape[0]:].any()


def test_k1_split_of_inf_is_not_finite():
    """Splitting +-inf gives NaN mid and lo pieces: a row holding inf (or
    NaN) gives a non-finite output row on the card."""
    v = np.array([np.inf, -np.inf, np.nan], np.float32)
    hi, mid, lo = fused_mlp.split_bf16(torch.tensor(v), 3)
    assert torch.isinf(hi.float()[:2]).all() and torch.isnan(hi.float()[2])
    assert torch.isnan(mid.float()).all() and torch.isnan(lo.float()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_split_pieces_are_tf32_and_reconstruct(seed):
    v = _values(4096, seed + 10)
    big, small = tmm.split_tf32(torch.tensor(v))
    for p in (big, small):
        assert not (p.numpy().view(np.uint32) & 0x1FFF).any()  # TF32
    assert np.array_equal(big.numpy(), tf32_rna(v))
    assert np.array_equal(small.numpy(), tf32_rna(v - tf32_rna(v)))
    err = np.abs(v.astype(np.float64) - big.double().numpy()
                 - small.double().numpy())
    assert np.all(err <= np.abs(v.astype(np.float64)) * 2.0 ** -22)


# ---- (b) the emulated kernels hold to the JAX reference -------------------

@pytest.mark.parametrize("n", [1, 5, 511, 513])
@pytest.mark.parametrize("bf16", [False, True])
def test_k1_emulation_matches_pallas_interpret(n, bf16):
    cfg = MLPConfig()
    params = _mlp_params(cfg, n)
    x = np.random.default_rng(n + 7).standard_normal((n, 64)).astype(
        np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    ref = np.asarray(pallas_mlp.apply_fused(
        {k: jnp.asarray(v, jdt) for k, v in params.items()},
        jnp.asarray(x, jdt), cfg, interpret=True))
    got = emulate_k1(params, x, cfg, bf16)
    assert got.shape == ref.shape == (n, 3)
    assert np.abs(ref).max() > 0.1  # O(1) outputs, not near-zero ones
    np.testing.assert_allclose(got, ref, rtol=K1_RTOL, atol=K1_ATOL)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (300, 200, 100),
                                   (512, 512, 512)])
def test_k2_emulation_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = np.asarray(pallas_matmul.matmul(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    got = emulate_k2(a, b)
    np.testing.assert_allclose(got, ref, rtol=K2_TOL, atol=K2_TOL)
    # the split is fp32-class: as close to the float64 product as fp32 is
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() <= 4 * np.abs(ref - exact).max()
