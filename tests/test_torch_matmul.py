"""The port's matrix product (K2, ``ops/matmul.py``) against the JAX
package's Pallas kernel in interpreter mode, from the same numpy inputs.

Tolerance rtol 2e-4 / atol 2e-4: the bound tests/test_nn_matmul.py holds
the Pallas kernel to ``a @ b`` (fp32, another summation order over K). The
CUDA kernel itself runs only on the card: its comparison with the plain
version skips here and is a phase of chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralradiancecaching_tpu.ops import pallas_matmul
from neuralradiancecaching_tpu_torch.ops import matmul as tmm
from neuralradiancecaching_tpu_torch.utils import profiling

RTOL = ATOL = 2e-4
SHAPES = [(64, 64, 64), (300, 200, 100), (512, 512, 512)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's eager ops on small tensors: the
    suite runs several test workers on the same cores, and thread pools
    per tiny op oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_matches_pallas_interpret(m, k, n):
    a, b = _operands(m, k, n, m + k + n)
    ref = np.asarray(pallas_matmul.matmul(jnp.asarray(a), jnp.asarray(b),
                                          interpret=True))
    with profiling.tracing("cpu") as rec, rec.frame(0):
        out = tmm.matmul(torch.tensor(a), torch.tensor(b))
    # CPU tensors take the plain version: no launch counted
    assert [(r.name, r.counts) for r in rec.records()] == [("frame", {})]
    assert out.shape == (m, n) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmm.matmul_plain(torch.tensor(a),
                                                torch.tensor(b)).numpy(),
                               out.numpy(), rtol=0, atol=0)


def test_kernel_needs_cuda_tensors():
    a, b = _operands(8, 8, 8, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmm.matmul_kernel(torch.tensor(a), torch.tensor(b))


@pytest.mark.parametrize("a_shape,b_shape,dtype,transpose", [
    ((8, 4), (5, 6), torch.float32, False),   # K mismatch
    ((8, 4, 1), (4, 6), torch.float32, False),  # not 2-D
    ((8, 4), (4, 6), torch.float64, False),   # dtype
    ((4, 8), (4, 6), torch.float32, True),    # non-contiguous A
])
def test_kernel_rejects_unsupported(a_shape, b_shape, dtype, transpose):
    a = torch.zeros(a_shape, dtype=dtype)
    a = a.T if transpose else a
    with pytest.raises(ValueError):
        tmm._check_supported(a, torch.zeros(b_shape, dtype=dtype))


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run chip_smoke.py there)")
    for m, k, n in SHAPES + [(1, 1, 1), (129, 17, 130), (1, 4, 1),
                             (127, 33, 129), (65, 129, 63)]:
        a, b = (torch.tensor(x, device="cuda")
                for x in _operands(m, k, n, 1))
        # no enclosing span: K2's own span holds its launch count
        with profiling.tracing("cuda") as rec:
            out = tmm.matmul_kernel(a, b)
        assert [(r.name, r.counts) for r in rec.records()] == [
            ("k2", {"k2_launches": 1})]
        torch.cuda.synchronize()
        torch.testing.assert_close(out, tmm.matmul_plain(a, b), rtol=RTOL,
                                   atol=ATOL)
        exact = (a.double() @ b.double()).float()
        torch.testing.assert_close(out, exact, rtol=RTOL, atol=ATOL)
