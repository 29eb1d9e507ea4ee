"""Fused forward of the cache MLP as one hand-written CUDA kernel (K1).

Counterpart of ``neuralradiancecaching_tpu/ops/pallas_mlp.py``: the Pallas
TPU kernel ``_fused_kernel``/``apply_fused`` becomes ``csrc/fused_mlp.cu``,
a tensor-core kernel at fp32 accuracy (persistent blocks, the packed weight
pieces in shared memory once per block, 64-row tiles per warpgroup brought
in by ``cp.async``, activations kept in registers as ``wgmma``'s A operand
from layer to layer; the source says what bounds it). Every fp32 value is
split into bf16 pieces that sum to it exactly (:func:`split_bf16`), so the
products are exact and only the summation order differs from the plain
version. :func:`apply` is the ``custom_vjp`` counterpart: a
``torch.autograd.Function`` whose backward recomputes through the plain
torch MLP, as the JAX version does -- the TPU kernel had no backward kernel.

Two modes, as the Pallas kernel has: float32 rows, and bf16 rows (the bf16
query of config 5) with bf16-rounded weights. The bf16 mode computes what
``jnp.dot(..., preferred_element_type=float32)`` gives in JAX: the f32 MLP
over bf16-rounded rows, weights and biases, with f32 activations and an f32
output -- not a chain of bf16 matmuls, which would round every layer.

A launch takes its weights packed: :func:`pack_params` writes them once per
weight set into the kernel's layout, :func:`launch` runs the kernel on a
packed buffer, and :func:`apply_kernel` is the two together.

Dispatch rule: a CPU tensor takes :func:`apply_plain`; a CUDA tensor of
float32 or bf16 rows takes the kernel in that mode, or raises
``ValueError`` for what the kernel does not take. There is no fallback
from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from neuralradiancecaching_tpu_torch.config import MLPConfig
from neuralradiancecaching_tpu_torch import kernels
from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
from neuralradiancecaching_tpu_torch.utils import profiling

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


def _out_cols(cfg: MLPConfig) -> int:
    """Columns of the packed output layer (the MMA's N): 8 or 64."""
    return 8 if cfg.out_features <= 8 else _D


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


def split_bf16(v: torch.Tensor, pieces: int) -> list[torch.Tensor]:
    """fp32 ``v`` as ``pieces`` bf16 tensors, largest first: each rounds (to
    nearest even, as the kernel's ``__floats2bfloat162_rn``) what the ones
    before it leave. Three pieces sum to ``v`` exactly; one piece is exact
    for a bf16 value."""
    out, rest = [], v.to(torch.float32)
    for _ in range(pieces):
        piece = rest.to(torch.bfloat16)
        out.append(piece)
        rest = rest - piece.to(torch.float32)
    return out


def swizzle_index(n: int, device=None) -> torch.Tensor:
    """Flat positions of wgmma's 128-byte swizzle for an (n, 64) K-major
    bf16 piece: element (r, k) lies at r * 64 + ((k // 8) ^ (r % 8)) * 8 +
    k % 8. The map is its own inverse, so ``piece.flatten()[index]`` both
    swizzles and unswizzles."""
    rows = torch.arange(n, device=device)[:, None]
    k = torch.arange(_D, device=device)[None, :]
    return (rows * _D + ((k // 8) ^ (rows % 8)) * 8 + k % 8).reshape(-1)


class PackedMLP(NamedTuple):
    """The kernel's weights for one weight set and mode: a uint8 buffer on
    the card in the layout ``csrc/fused_mlp.cu`` describes."""
    buffer: torch.Tensor
    bf16: bool


def _pieces(w: torch.Tensor, pieces: int, index: torch.Tensor
            ) -> torch.Tensor:
    """(..., n, in) fp32 weights, transposed K-major -> (..., pieces, n *
    64) swizzled bf16 pieces."""
    parts = torch.stack(split_bf16(w, pieces), dim=-3)
    return parts.flatten(-2)[..., index]


def pack_params_plain(params, cfg: MLPConfig, bf16: bool = False,
                      device=None) -> PackedMLP:
    """The pack step in plain torch (the pack kernel's plain version): per
    hidden layer the bf16 pieces of W^T (3 in the f32 mode, 1 in the bf16
    mode, where the weights are rounded to bf16 first), swizzled; then the
    output layer's, zero-padded to 8 or 64 rows; then the fp32 biases
    (bf16-rounded in the bf16 mode), the output's padded alike; the whole
    padded to 16 bytes."""
    pieces = 1 if bf16 else 3
    n_out, last = _out_cols(cfg), cfg.n_layers - 1
    dtype = torch.bfloat16 if bf16 else torch.float32

    def get(name):
        return params[name].to(device=device, dtype=dtype).to(torch.float32)
    index = swizzle_index(_D, device)
    hidden = torch.stack([get(f"w{i}") for i in range(last)])
    w_out = F.pad(get(f"w{last}"), (0, n_out - cfg.out_features))
    bias = torch.cat([get(f"b{i}") for i in range(last)] + [
        F.pad(get(f"b{last}"), (0, n_out - cfg.out_features))])
    buf = torch.cat([
        _pieces(hidden.transpose(1, 2), pieces, index).view(torch.uint8)
        .reshape(-1),
        _pieces(w_out.t(), pieces, index[:n_out * _D]).view(torch.uint8)
        .reshape(-1),
        bias.view(torch.uint8)])
    return PackedMLP(F.pad(buf, (0, -buf.numel() % 16)), bf16)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fused_mlp_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_mlp_pack.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.fused_mlp_pack.restype = ctypes.c_int
        for name in ("fused_mlp_smem_bytes", "fused_mlp_pack_bytes"):
            getattr(lib, name).argtypes = [ctypes.c_int] * 3
            getattr(lib, name).restype = ctypes.c_longlong
    return lib


def _load(cfg: MLPConfig, in_bf16: bool) -> ctypes.CDLL:
    """The built library, once the config is known to fit one block's
    shared memory."""
    lib = _bind(kernels.load("fused_mlp"))
    smem = lib.fused_mlp_smem_bytes(cfg.n_layers - 1, cfg.out_features,
                                    int(in_bf16))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_mlp kernel: {cfg.n_layers} layers need "
                         f"{smem} B of shared memory (> {_SMEM_LIMIT})")
    return lib


def pack_params(params, cfg: MLPConfig, bf16: bool = False,
                device=None) -> PackedMLP:
    """The pack step, run once per weight set, for rows of the bf16 mode
    (``bf16``) or the f32 mode on ``device`` (default: the parameters'):
    one launch of the pack kernel (``csrc/fused_mlp.cu``) on a card, the
    plain version, :func:`pack_params_plain`, on the CPU."""
    device = torch.device(device if device is not None
                          else params["w0"].device)
    if device.type == "cpu":
        return pack_params_plain(params, cfg, bf16, device)
    if device.type != "cuda":
        raise ValueError(f"pack_params needs a CUDA or CPU device, got "
                         f"{device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    layers = range(cfg.n_layers)
    names = [f"w{i}" for i in layers] + [f"b{i}" for i in layers]
    params_bf16 = all(params[k].dtype == torch.bfloat16 for k in names)
    dtype = torch.bfloat16 if params_bf16 else torch.float32
    ts = {k: params[k].to(device=device, dtype=dtype).contiguous()
          for k in names}
    n_hidden = cfg.n_layers - 1
    lib = _load(cfg, bf16)
    buf = torch.empty(lib.fused_mlp_pack_bytes(n_hidden, cfg.out_features,
                                               int(bf16)),
                      dtype=torch.uint8, device=device)
    w_ptrs, b_ptrs = ((ctypes.c_void_p * cfg.n_layers)(
        *[ts[f"{p}{i}"].data_ptr() for i in layers]) for p in "wb")
    err = lib.fused_mlp_pack(
        w_ptrs, b_ptrs, buf.data_ptr(), n_hidden, cfg.out_features,
        int(bf16), int(params_bf16), device.index,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp pack kernel launch failed: CUDA error "
                           f"{err}")
    return PackedMLP(buf, bf16)


@profiling.spanned("k1")
def launch(packed: PackedMLP, x: torch.Tensor, cfg: MLPConfig
           ) -> torch.Tensor:
    """Launch K1 on a CUDA tensor with weights packed by
    :func:`pack_params` in the rows' mode: (B, 64) float32 or bf16 rows ->
    (B, out_features) float32. Traced as the span ``k1`` with the count
    ``rows``, and ``k1_bf16_launches`` or ``k1_f32_launches`` once the
    launch succeeds."""
    profiling.count("rows", x.shape[0])
    if x.device.type != "cuda":
        raise ValueError(f"launch needs a CUDA tensor, got {x.device}")
    _check_supported(x, cfg)
    in_bf16 = x.dtype == torch.bfloat16
    if packed.bf16 != in_bf16 or packed.buffer.device != x.device:
        raise ValueError(f"fused_mlp kernel: weights packed for "
                         f"{'bf16' if packed.bf16 else 'float32'} rows on "
                         f"{packed.buffer.device}, got {x.dtype} rows on "
                         f"{x.device}")
    n_hidden = cfg.n_layers - 1
    lib = _load(cfg, in_bf16)
    if packed.buffer.numel() != lib.fused_mlp_pack_bytes(
            n_hidden, cfg.out_features, in_bf16):
        raise ValueError("fused_mlp kernel: the packed weights do not match "
                         "the config")
    out = torch.empty((x.shape[0], cfg.out_features), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_mlp_forward(
        x.data_ptr(), packed.buffer.data_ptr(), out.data_ptr(), x.shape[0],
        n_hidden, cfg.out_features, int(cfg.activation == "sigmoid"),
        int(cfg.output_relu), int(in_bf16), x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp kernel launch failed: CUDA error {err}")
    profiling.count("k1_bf16_launches" if in_bf16 else "k1_f32_launches", 1)
    return out


def apply_kernel(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """Pack and launch K1 on a CUDA tensor: (B, 64) float32 or bf16 rows ->
    (B, out_features) float32. For bf16 rows the weights are rounded to
    bf16 (``query_mlp`` hands them in bf16 already)."""
    if x.device.type != "cuda":
        raise ValueError(f"apply_kernel needs a CUDA tensor, got {x.device}")
    _check_supported(x, cfg)
    return launch(pack_params(params, cfg, x.dtype == torch.bfloat16,
                              x.device), x, cfg)


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
