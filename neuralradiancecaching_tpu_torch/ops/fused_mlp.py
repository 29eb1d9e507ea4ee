"""Fused forward of the cache MLP as one hand-written CUDA kernel (K1).

Counterpart of ``neuralradiancecaching_tpu/ops/pallas_mlp.py``: the Pallas
TPU kernel ``_fused_kernel``/``apply_fused`` becomes
``csrc/fused_mlp.cu`` (one thread per row, activations in registers, the
~84 KB of weights in shared memory once per persistent block; the source
says what bounds it). :func:`apply` is the ``custom_vjp`` counterpart: a
``torch.autograd.Function`` whose backward recomputes through the plain
torch MLP, as the JAX version does -- the TPU kernel had no backward kernel.

Two modes, as the Pallas kernel has: float32 rows, and bf16 rows (the bf16
query of config 5) with bf16-rounded weights. The bf16 mode computes what
``jnp.dot(..., preferred_element_type=float32)`` gives in JAX: the f32 MLP
over bf16-rounded rows, weights and biases, with f32 activations and an f32
output -- not a chain of bf16 matmuls, which would round every layer.

Dispatch rule: a CPU tensor takes :func:`apply_plain`; a CUDA tensor of
float32 or bf16 rows takes the kernel in that mode, or raises
``ValueError`` for what the kernel does not take. There is no fallback
from the card to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from neuralradiancecaching_tpu_torch.config import MLPConfig
from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops

# launches of the CUDA kernel in this process, one per kernel launch: in
# the float32 mode and in the bf16 mode
LAUNCHES = 0
LAUNCHES_BF16 = 0

_D = 64  # the kernel's in_features == hidden
_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use


def apply_plain(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """The plain torch forward the kernel is held to. bf16 rows: the f32
    forward over the rows and the bf16-rounded parameters, upcast
    explicitly (``bf16 @ bf16`` in torch would return bf16)."""
    if x.dtype == torch.bfloat16:
        params = {k: v.to(torch.bfloat16).to(torch.float32)
                  for k, v in params.items()}
        x = x.to(torch.float32)
    return mlp_ops.apply(params, x, cfg)


def _out_pad(cfg: MLPConfig) -> int:
    return -(-cfg.out_features // 4) * 4


def _check_supported(x: torch.Tensor, cfg: MLPConfig) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mlp kernel takes float32 or bfloat16 rows, "
                         f"got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != cfg.in_features:
        raise ValueError(f"fused_mlp kernel takes (B, {cfg.in_features}) "
                         f"rows, got {tuple(x.shape)}")
    if cfg.in_features != _D or cfg.hidden != _D:
        raise ValueError("fused_mlp kernel needs in_features == hidden == 64,"
                         f" got {cfg.in_features}/{cfg.hidden}")
    if not 1 <= cfg.out_features <= _D:
        raise ValueError(f"fused_mlp kernel needs 1 <= out_features <= 64, "
                         f"got {cfg.out_features}")
    if cfg.n_layers < 2:
        raise ValueError(f"fused_mlp kernel needs n_layers >= 2, "
                         f"got {cfg.n_layers}")
    if cfg.activation not in ("relu", "sigmoid"):
        raise ValueError(f"fused_mlp kernel: unknown activation "
                         f"{cfg.activation!r}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_mlp kernel takes contiguous rows starting "
                         "16-byte aligned (16-byte vector loads)")


def pack_params(params, cfg: MLPConfig) -> torch.Tensor:
    """Flat float32 buffer in the kernel's layout: per hidden layer W (64, 64)
    then b (64,); then the output W (64, out_pad) and b (out_pad,), zero-
    padded to a multiple of 4 columns. bf16 parameters convert exactly."""
    pad = _out_pad(cfg) - cfg.out_features
    parts = []
    for i in range(cfg.n_layers):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if i == cfg.n_layers - 1 and pad:
            w, b = F.pad(w, (0, pad)), F.pad(b, (0, pad))
        parts += [w.reshape(-1), b.reshape(-1)]
    return torch.cat(parts).to(torch.float32).contiguous()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fused_mlp_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_mlp_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_mlp_smem_bytes.restype = ctypes.c_longlong
    return lib


def apply_kernel(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Launch K1 on a CUDA tensor: (B, 64) float32 or bf16 rows -> (B,
    out_features) float32. For bf16 rows the weights are rounded to bf16
    (``query_mlp`` hands them in bf16 already)."""
    global LAUNCHES, LAUNCHES_BF16
    if x.device.type != "cuda":
        raise ValueError(f"apply_kernel needs a CUDA tensor, got {x.device}")
    _check_supported(x, cfg)
    n_hidden, out_pad = cfg.n_layers - 1, _out_pad(cfg)
    lib = _bind(kernels.load("fused_mlp"))
    smem = lib.fused_mlp_smem_bytes(n_hidden, out_pad)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_mlp kernel: {cfg.n_layers} layers need "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    in_bf16 = x.dtype == torch.bfloat16
    if in_bf16:
        params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    packed = pack_params(params, cfg).to(x.device)
    out = torch.empty((x.shape[0], cfg.out_features), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_mlp_forward(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(), x.shape[0],
        n_hidden, cfg.out_features, out_pad,
        int(cfg.activation == "sigmoid"), int(cfg.output_relu), int(in_bf16),
        x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    if in_bf16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    return out


def apply_fused(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Fused forward: the kernel on a CUDA tensor, the plain version on a CPU
    tensor (the only case that takes it)."""
    if x.device.type == "cpu":
        return apply_plain(params, x, cfg)
    return apply_kernel(params, x, cfg)


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, names, *values):
        ctx.cfg, ctx.names = cfg, names
        ctx.save_for_backward(x, *values)
        return apply_fused(dict(zip(names, values)), x, cfg)

    @staticmethod
    def backward(ctx, g):
        x, *values = ctx.saved_tensors
        with torch.enable_grad():
            xs = x.detach().requires_grad_(ctx.needs_input_grad[0])
            vs = [v.detach().requires_grad_(need) for v, need in
                  zip(values, ctx.needs_input_grad[3:])]
            out = apply_plain(dict(zip(ctx.names, vs)), xs, ctx.cfg)
            wrt = [t for t in (xs, *vs) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g)) if wrt else iter(())
        gx = next(grads) if xs.requires_grad else None
        gv = [next(grads) if v.requires_grad else None for v in vs]
        return (gx, None, None, *gv)


def apply(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Fused forward with a plain-autodiff backward: drop-in for
    ``mlp.apply`` on 2-D inputs (the ``pallas_mlp.apply`` counterpart)."""
    names = tuple(sorted(params))
    return _FusedMLP.apply(x, cfg, names, *(params[k] for k in names))
