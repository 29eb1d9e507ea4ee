"""fp32 matrix product as one hand-written CUDA kernel (K2).

Counterpart of ``neuralradiancecaching_tpu/ops/pallas_matmul.py``: the
Pallas TPU kernel ``_kernel``/``matmul`` (256x256x512 tiles on the systolic
array, any shape padded and sliced) becomes ``csrc/matmul.cu``, a
tensor-core product at fp32 accuracy: a pre-pass splits each operand into
two TF32 pieces (:func:`split_tf32` is its plain version), and persistent
CTAs run ``wgmma`` on the three leading piece products, fed by TMA through
a shared-memory ring, predicating the ragged edges instead of padding (the
source says what bounds it). No module of the JAX package calls
``pallas_matmul.matmul`` (its only caller is ``tests/test_nn_matmul.py``),
and no path of the port calls this one.

Dispatch rule: CPU tensors take :func:`matmul_plain` (``torch.matmul``);
CUDA tensors take the kernel, or raise ``ValueError`` for what the kernel
does not take. There is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.utils import profiling


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version the kernel is held to: ``torch.matmul`` in full
    fp32 (TF32 off for the call on a card)."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass's split of fp32 ``x`` into TF32 pieces (big, small):
    big = tf32(x), small = tf32(x - big). ``big + small`` is within
    2^-22 |x| of x; the kernel forms big.big + small.big + big.small."""
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _check_supported(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"matmul kernel takes float32, got {a.dtype} and "
                         f"{b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul kernel takes (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous row-major operands")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.matmul_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.matmul_padded_k.argtypes = [ctypes.c_longlong]
        lib.matmul_padded_k.restype = ctypes.c_longlong
    return lib


@profiling.spanned("k2")
def matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch K2 on CUDA tensors: (M, K) @ (K, N) float32 -> (M, N). The
    operands' TF32 pieces go to scratch allocated here: (2, M, Kp) for A,
    (2, N, Kp) for B transposed, Kp = K rounded up to 4. Traced as the
    span ``k2``, each launch its count ``k2_launches``."""
    if a.device.type != "cuda":
        raise ValueError(f"matmul_kernel needs CUDA tensors, got {a.device}")
    _check_supported(a, b)
    lib = _bind(kernels.load("matmul"))
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    kp = lib.matmul_padded_k(k)
    pieces_a = torch.empty((2, m, kp), dtype=torch.float32, device=a.device)
    pieces_b = torch.empty((2, n, kp), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.matmul_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                         pieces_a.data_ptr(), pieces_b.data_ptr(), m, n, k,
                         a.device.index, stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: CUDA error {err}")
    profiling.count("k2_launches", 1)
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) with fp32 accumulation: the kernel on CUDA
    tensors, the plain version on CPU tensors (the only case that takes
    it)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_plain(a, b)
    return matmul_kernel(a, b)
