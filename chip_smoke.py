#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (neuralradiancecaching_tpu_torch)
on one NVIDIA GPU.

Drives the port's paths at full model width (6x64 MLP, L=16 T=16384 F=2
hash table, random weights from a seed) and full scene size (125x85x153
density grid, fields at (32, 24, 40) voxels):

- config 4 with the collision sampler and the fused query MLP, fields at
  (16, 32) buckets: the serving path ``render_only_step`` (the cached
  512x512 render), and the online frame ``frame_step`` (the train batch:
  100x100 train grid x 8 oversampled jitters = an 80,000-lane vertex walk,
  80,000 target walks of 64 slots split and cascaded; the train step: oct
  encode, autograd, guarded Adam on the MLP and the table; then the
  512x512 render);
- config 5's progressive 1920x1080 frame, the single-device banded branch
  of the JAX package's ``cli.py`` with ``bench.py``'s production settings
  and hoists: bf16 fields at (32, 64) direction buckets, the caps from the
  bench's probes, the pose-static env colour and live-ray pack, then per
  frame ``train_only_step`` -> ``nrc.bake`` (bf16 rows) ->
  ``tiled.render_banded`` (the packed walk in 30-row bands, the deferred
  shade and the bf16 cache query through K1's bf16 mode);
- the JAX bench's quality legs on config 5's scene at 256^2: the unbiased
  oracle (delta sampler, ratio-tracked transmittance, MC in-scatter), the
  no-cache collision render and the NN render after 400 train steps, as
  twin accumulations held to the oracle's by ``utils/metrics.py``;
- configs 3 and 4 as they ship at 800x800 (``pathtrace_config``: the
  reference sampler with the cache off; ``nrc_online_config`` with only
  ``fused_inference`` set: the reference sampler's train targets and
  cached render, K1 f32 on its query);
- config 4 as it ships with the dense inference bake and the hash-path
  train encode (``MRHEConfig.inference_bake="dense"``,
  ``train_encode="hash"``), beside its oct-path frames;
- the port's CLI (``python -m neuralradiancecaching_tpu_torch.cli``) as a
  user runs it, each subcommand in its own process at its default size:
  ``pathtrace`` and ``nrc-online`` at 800x800 through the banded render
  in 32-row bands, ``progressive`` at 1920x1080, ``image-fit`` (500 steps
  of batch 8192 on the env map); ``mnist`` at its defaults in-process on
  synthetic labels (the machine has no MNIST label file);
- the offline path tracer (``render/offline_pathtracer.py``) on the
  stand-in cloud at 800x800 with its default 32 bounces;
- data parallel (``parallel/``) at world size 1 with NCCL on the card:
  config 5's production frame through ``dp_train_banded_frame`` (the
  packed DP render, K1 bf16) and config 4 as it ships through
  ``dp_frame_step`` (K1 f32), each beside its single-device path
  (``train_only_step`` -> ``bake`` -> ``render_banded``; ``frame_step``)
  on the same draws; ``probe_dp_caps`` at 1080p; two gloo ranks on the
  one card at a small cut; the CLI's ``--mesh`` frames under
  ``torchrun``;
- ``reference_exact()``, the JAX package's bit-faithful reproduction of
  the reference, as it ships at 800x800 (every quirk, the 8-bit density,
  quadrature light and env transmittance, MC in-scatter through the dense
  per-slot shade, momentum SGD and plain hash SGD), once more with
  ``fused_inference`` (K1 f32 on its query); with it the raw-grid
  trilinear fetch, ``tiled.render_tiled`` and ``utils/``;
- the host library ``csrc/nrcio.cpp`` (``io/native.py``), built with the
  machine's host C++ compiler: a 4096x2048 RLE ``.hdr`` of the synthesized
  sky decoded natively and by the plain Python decode, bit for bit.

It holds every hand-written kernel to its plain PyTorch version -- K1
(csrc/fused_mlp.cu, the query MLP on the tensor cores with split-bf16
operands: its f32 mode on config 4's paths, its bf16 mode on config 5's)
at the shapes the paths give it and at 64k +- 1 rows, with a NaN and an
inf row, and K2 (csrc/matmul.cu, the generic fp32 matrix product as
3xTF32 on the tensor cores, on no path of the frame) at the JAX test's
shapes, two ragged ones and 4096^3 -- and logs each one's error against a
float64 product on the card beside it, and the count of HGMMA (wgmma)
instructions in each built library. Run from the repository root:

    python3 chip_smoke.py

It checks and does not time frames: frame times come from the benchmark
(``python3 benchmark/run.py --workload <cell> ...``). Its only timings are
the kernels' own (phases 3, 8e and 21), which the kernel table of PERF.md
reads. Launch counts come from the port's tracer
(``utils/profiling.py``): the frames whose launches are checked run
inside ``profiling.tracing``, and the kernel wrappers' counts
``k1_f32_launches``, ``k1_bf16_launches``, ``k2_launches`` and
``k3_launches`` are read from its records.

Phases: 1 device; 2 the three kernels built together, the HGMMA counts of
K1 and K2; 3 K1 and K2 vs plain and vs float64 with their timings (K1's
launch alone on weights packed once, and its whole wrapper, at the
config-4-preset query's 640,000 rows; K1's pack kernel against the plain
pack step; K1's wide-output form; NaN and inf rows); 21 the quadrature
kernel bit for bit the plain path at the main path's (rows, steps),
each timed against the plain path and its bound; 4-6 config 4 with the
collision sampler at 512x512: its scene, 4 frames through
``render_only_step`` and 4 through ``frame_step`` (K1 launched on each),
K1 on the frame's real rows, 32 ``train_only_step``s whose mse must fall;
7 the card vs the CPU port at 32x32 with the same random draws (the CPU
path is the one the tests hold to the JAX package), for the render and
for one online frame; 8 config 5: its bf16 scene, 3 warm-up train steps,
the probes and caps (``benchmark/caps.py``), the live-ray pack (the
quadrature kernel launched), K1's bf16 mode vs plain and timed at the
packed-lane count, 4 progressive frames (K1 bf16 launched on each), no
entry-tau quadrature inside ``render_banded``, K1 bf16 on the frame's real
rows; 16a the same frame data-parallel, 16c ``probe_dp_caps``; 8h the
quality legs; 8i the card vs the CPU port on the packed frame with f32 and
with bf16 fields; 9-10 configs 3 and 4 as they ship at 800x800: 4 frames
each (config 3 launches no K1, config 4 launches K1 f32 on each), 32
train steps whose mse must fall, K1 f32 on config 4's real query rows,
each render once more in the CLI's 32-row bands; 10c config 4 with the
dense bake and the hash train encode: 2 frames, the dense encode against
the oct one; 16b config 4's frame data-parallel; 11 the card vs the CPU
port at 32x32 on the oracle's render, on one config-4-preset frame and on
one dense/hash frame; 17 reference_exact: 2 frames (no K1, the quadrature
kernel launched), 32 train steps, the ``fused_inference`` frame against
the plain one (K1 f32 launched once), the card vs the CPU port at 32x32,
the raw-grid fetch, ``render_tiled``, ``utils.profiling.trace`` and
``utils.debug.nan_check``; 12 the CLI as a user runs it, each run its own
process at the subcommand's default size (``pathtrace`` at 800x800 in
32-row bands, also with the delta sampler at spp 2; ``nrc-online`` for 4
frames with a checkpoint, then resumed from it for one; ``progressive``
for 4 frames at 1920x1080), each image read back finite, the CLI's own
metrics rows logged; 13 the card vs the CPU port on every branch of
``render_banded`` the CLI reaches at 32x32; 14 ``image-fit`` in its own
process, ``image_fit.train_step`` card vs CPU port, ``mnist`` whose train
accuracy must pass 0.8; 15 the offline path tracer at 800x800 and card vs
CPU port at 32x32; 16d-f two gloo ranks on the card, each its own process
of ``parallel/job.py``, bitwise equal to each other and equal to world
size 1 on the renders, the walks' branches no preset sets card vs CPU
port, and the CLI's ``--mesh`` frames under ``torchrun``; 19 the host
library (the build, the native and the plain decode of a 4096x2048 RLE
``.hdr``, bit for bit; host times); 20 the tracer where the CPU cannot
look (an ``.item()`` inside a span counts as one sync; config 5's and
config 4's frames traced, K1's rows at the query's row count, the frame's
kernels with the tracer off against the traced frame's with
``profiling.cap`` stubbed out, each from a profile padded by
PROFILE_PAD seconds of idle at both ends, the traced image within
TRACER_NOISE_MARGIN times the largest gap between TRACER_UNTRACED
untraced repeats). Any failure raises and exits non-zero. Without a CUDA
device, or outside a checkout of the repository, it exits 2 and prints no
result. The line before the last is the card's name and power limit, the
one before it the kernels' JSON record (K1 f32's launches are those of
the config-4-preset frames, oct and dense/hash, its data-parallel frame
and the fused reference_exact frame; K1 bf16's those of the progressive
frames and their data-parallel frame); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.work import HBM_BYTES_S, bound_ms, k1_work

REPO = Path(__file__).resolve().parent
WIDTH = HEIGHT = 512
N_FRAMES = 4
TRAIN_STEPS = 32
ORBIT_POSES = 8
K1_EDGE_SIZES = (1, 5, 63, 65, 127, 129, 511, 513)
K1_SIZES = K1_EDGE_SIZES + (WIDTH * HEIGHT,)
# K1 vs the plain torch MLP: the kernel's products of split-bf16 pieces are
# exact, so both are fp32 with another summation order over 64 terms per
# layer: |kernel - plain| <= K1_ATOL + K1_RTOL * |plain|
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# K2 vs torch.matmul (TF32 off), the bound tests/test_nn_matmul.py holds
# the Pallas kernel to: |kernel - ref| <= K2_TOL + K2_TOL * |ref|
K2_SHAPES = ((1, 1, 1), (129, 17, 130), (64, 64, 64), (300, 200, 100),
             (512, 512, 512), (4096, 4096, 4096))
K2_TOL = 2e-4
# the card vs the CPU port at the small size: the render test's tolerance;
# after one online frame also the training tests' bounds (mse 1e-3
# relative, MLP parameters 1e-6, hash entries >= 99.9% within 1e-6 and all
# within 2 lr -- index_add_ sums in another order on the card). As in the
# train-step test the MLP has O(1) weights: at the 0.01 init the early
# layers' gradients sit near Adam's eps (1e-15), where g / (|g| + eps)
# turns summation-order noise into steps of a share of lr.
SMALL_FRAC_OK, SMALL_REL_MEAN = 0.995, 1e-4
SMALL_MSE_REL, SMALL_PARAM_TOL, SMALL_HASH_FRAC = 1e-3, 1e-6, 0.999
# the FP32 FMA pipe's published peak (NVIDIA data sheet, H100 SXM, dense,
# at 700 W), logged beside the tensor-core bound of benchmark/work.py (the
# yardstick of PRs 1-3)
FP32_FLOPS = 67e12
# config 5's progressive frame (bench.py:69-84: 1920x1080, spp 1, 30-row
# bands; bench.py:153 three warm-up train steps), 4 frames, and K1's bf16
# mode at the tests' sizes (the frame's packed-lane count is added once
# the pack is built)
P_WIDTH, P_HEIGHT, BAND_ROWS = 1920, 1080, 30
P_FRAMES, P_WARMUP_STEPS = 4, 3
K1_BF16_SIZES = K1_EDGE_SIZES
# the card vs the CPU port on the small packed frame: f32 fields at the
# render bound above; bf16 fields and the bf16 query at the bound
# tests/test_torch_tiled.py holds the port to against JAX (>= 99% of
# pixels within 1e-3 + 1e-3 |ref|, all within 1e-2 + 1e-2 |ref|, mean
# 1e-4 relative)
SMALL_BF16_FRAC_OK = 0.99
# configs 3 and 4 as they ship (pathtrace_config / nrc_online_config at
# their 800x800 default; config 4 with only fused_inference set): 4
# frames, 32 train steps whose mse must fall, one frame in the CLI's bands
PRESET_SIDE = 800
# the port's bench's ground-truth legs (bench.py:755-829): 256^2, the
# oracle twins at 2 x 128 spp, the no-cache collision and the NN twins at
# 2 x 64 spp, the NN leg after 400 train steps
Q_SIDE, Q_TRAIN_STEPS, Q_GT_SPP = 256, 400, 64
# the CLI's runs (each its own process; a run's time limit) and the
# branches of render_banded held card against CPU: (sampler, cache on,
# spp, packed, light transmittance mode)
CLI_TIMEOUT = 600
CLI_MODULE = ("-m", "neuralradiancecaching_tpu_torch.cli")
BANDED_CASES = (("reference", False, 2, False, "field"),
                ("collision", False, 1, False, "field"),
                ("delta", False, 2, False, "field"),
                ("reference", True, 2, False, "field"),
                ("delta", True, 1, False, "field"),
                ("delta", True, 1, True, "field"),
                ("delta", True, 1, False, "quadrature"),
                ("collision", True, 2, False, "field"),
                ("collision", True, 2, True, "field"))
# config 4 as it ships with the dense inference bake and the hash-path
# train encode (phase 10c): its frames
DENSE_FRAMES = 2
# the image fit's one train step, card vs CPU port (phase 14): mse 1e-5
# relative (a forward of the same state), MLP parameters 1e-6, hash
# entries >= 99.9% within 1e-6 and all within 1e-5 (plain SGD moves an
# entry by lr x its scatter-added gradient, summed in another order)
FIT_MSE_REL, FIT_HASH_ALL = 1e-5, 1e-5
# MNIST at the CLI's defaults (phase 14): synthetic idx1 labels, as many as
# its --limit and its 2048 test rows; JAX's accuracy threshold
# (tests/test_workloads.py:23)
MNIST_TRAIN_LABELS, MNIST_TEST_LABELS, MNIST_MIN_ACC = 10000, 2048, 0.8
# the offline path tracer (phase 15) at the presets' 800x800 with
# OfflinePTConfig's defaults and the JAX tests' sun, straight down
OFFLINE_SUN = (0.0, -1.0, 0.0)
# the data-parallel paths (phase 16) at world size 1 with NCCL: a DP frame
# held to the single-device one on one set of draws (the train tests'
# bounds, mse within DP_MSE_REL: the same card, only the atomic sums' order
# differs; the image at the render bound); two gloo ranks on the one card
# at config 5's small cut in DP_SMALL_BAND-row bands (a rank group's time
# limit DP_RANKS_TIMEOUT); the walks' new branches card vs CPU port, the
# splits and the entry kill at WALK_SIDE^2 (their packs act above 1024
# lanes)
DP_MSE_REL, DP_SMALL_BAND, DP_RANKS_TIMEOUT = 1e-5, 6, 300
# the tracer (phase 20): a frame's image traced against TRACER_UNTRACED
# untraced repeats of it, its nearest gap to them at most
# TRACER_NOISE_MARGIN times the largest gap between two of them (the
# atomic sums' order varies run to run: about 2e-6 in config 5, 1e-9 in
# config 4; bit for bit where the repeats agree)
TRACER_UNTRACED, TRACER_NOISE_MARGIN = 4, 2.0
# seconds of host sleep at each end of a profile whose kernels are counted
# (phase 20): torch.profiler keeps only the device records whose times,
# mapped onto the host's clock, fall inside its window, and kernels that
# run right at an unpadded window's edge can map outside it
PROFILE_PAD = 0.25
WALK_SIDE = 48
# the quadrature transmittance kernel (phase 21) at the main path's
# (rows, steps): reference_exact's 800^2 sky rays and segments, the orbit's
# 460,800-lane entry tau
TRANSMITTANCE_SHAPES = ((640_000, 16), (640_000, 32), (460_800, 64))
# the host library (phase 19): the (height, width) of the RLE .hdr written
# from the synthesized sky and decoded natively and by the plain decode
HDR_SHAPE = (2048, 4096)
# the card's name and power limit, set once the card is found: every new
# phase's summary line carries it
CARD = ""
# the data-parallel phases' results, logged once at the end
DP_LOG: dict = {}
# the quadrature kernel's launches by path, for the kernels record: a
# reference_exact frame's and an orbit pose's live pack on the main path
K3_BY_PATH: dict = {}
# the host clock at the start of main(): each phase logs its start against it
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(label: str) -> None:
    """Log a phase's start in seconds since the start of main()."""
    log(f"-- [{time.perf_counter() - T_START:.1f} s] phase {label}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def sync() -> None:
    torch.cuda.synchronize()


def traced(dev, fn):
    """``fn()`` under the port's tracer, inside one ``frame`` span: (its
    result, a Counter of every count summed over the spans -- the kernels'
    ``k1_f32_launches``, ``k1_bf16_launches``, ``k2_launches`` and
    ``k3_launches`` among them -- with each span's name counted as
    ``span <name>``)."""
    from neuralradiancecaching_tpu_torch.utils import profiling
    with profiling.tracing(dev) as rec:
        with rec.frame(0):
            out = fn()
    tally = collections.Counter()
    for r in rec.records():
        tally.update(r.counts)
        tally[f"span {r.name}"] += 1
    return out, tally


def slice_config(width: int, height: int, small: bool = False):
    """Config 4 + the collision sampler + the fused query MLP; ``small``
    cuts the scene and the train batch to the tests' size."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    r = dataclasses.replace
    cfg = cfg_mod.nrc_online_config(width, height)
    cfg = r(cfg, path=r(cfg.path, sampler="collision"),
            mlp=r(cfg.mlp, fused_inference=True))
    if small:
        cfg = r(cfg, path=r(cfg.path, collision_field_steps=8),
                volume=r(cfg.volume, grid_shape=(16, 12, 20),
                         field_shape=(6, 5, 8)),
                env_map=r(cfg.env_map, scatter_quad_dirs=(8, 16)),
                train=r(cfg.train, train_width=16, train_height=16,
                        target_bounces=16))
    return cfg


def he_params(mlp_cfg, gen: torch.Generator, device) -> dict:
    """MLP weights whose activations stay O(1) through every layer (the
    0.01 init shrinks them ~20x per layer), so the comparison is not one of
    near-zero numbers."""
    from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
    dims = mlp_ops.layer_dims(mlp_cfg)
    out = {}
    for i in range(mlp_cfg.n_layers):
        out[f"w{i}"] = torch.randn((dims[i], dims[i + 1]), generator=gen,
                                   device=device) * (2.0 / dims[i]) ** 0.5
        out[f"b{i}"] = torch.randn((dims[i + 1],), generator=gen,
                                   device=device) * 0.1
    return out


def k1_float64(params, x, mlp_cfg):
    """The MLP over the kernel's inputs in float64 on the card (bf16 rows:
    over the bf16-rounded parameters, as the kernel takes them)."""
    from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
    dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    p64 = {k: v.to(dt).to(torch.float64) for k, v in params.items()}
    return mlp_ops.apply(p64, x.to(torch.float64), mlp_cfg)


def compare_k1(params, x, mlp_cfg):
    """Launch K1 and the plain version on x and hold the kernel to it;
    returns (max abs and max rel error vs plain, max abs error of the
    kernel and of the plain version vs the float64 forward)."""
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    got = fused_mlp.apply_kernel(params, x, mlp_cfg)
    ref = fused_mlp.apply_plain(params, x, mlp_cfg)
    f64 = k1_float64(params, x, mlp_cfg)
    sync()
    check(got.shape == ref.shape, f"K1 shape {tuple(got.shape)}")
    if not got.numel():
        return 0.0, 0.0, 0.0, 0.0
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    check(bool((err <= K1_ATOL + K1_RTOL * ref.abs()).all()),
          f"K1 disagrees with plain at n={x.shape[0]}: max abs "
          f"{float(err.max())}")
    rel = float((err / ref.abs().clamp(min=1e-6)).max())
    return (float(err.max()), rel, float((got - f64).abs().max()),
            float((ref - f64).abs().max()))


def check_k1_pack(params, mlp_cfg, bf16: bool, dev) -> None:
    """K1's pack kernel writes the plain pack step's buffer bit for bit."""
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    got = fused_mlp.pack_params(params, mlp_cfg, bf16, dev).buffer
    ref = fused_mlp.pack_params_plain(params, mlp_cfg, bf16, dev).buffer
    sync()
    mode = "bf16" if bf16 else "f32"
    check(torch.equal(got, ref),
          f"K1's pack kernel ({mode} mode) differs from the plain pack step")


def check_k1_wide(dev) -> None:
    """K1's other output width (the m64n64 output layer, out_features > 8)
    and the sigmoid, with the output activation, in both modes: a 4-layer
    MLP with 20 outputs held to the plain version at 513 rows."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    mlp_cfg = cfg_mod.MLPConfig(n_layers=4, out_features=20,
                                activation="sigmoid", output_relu=True)
    gen = torch.Generator(device=dev).manual_seed(10)
    params = he_params(mlp_cfg, gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_k1_pack(params, mlp_cfg, dtype == torch.bfloat16, dev)
        x = torch.randn((513, 64), generator=gen, device=dev).to(dtype)
        abs_e, _, f64_e, _ = compare_k1(params, x, mlp_cfg)
        log(f"K1 {str(dtype).split('.')[-1]}, 4 layers, 20 sigmoid outputs, "
            f"513 rows: pack kernel == plain pack; vs plain max abs "
            f"{abs_e:.3e}, vs float64 {f64_e:.3e}")


def check_k1_nonfinite(params, mlp_cfg, dtype, dev) -> None:
    """A row holding NaN, +inf or -inf gives a non-finite output row from
    the kernel, as from the plain version; the other rows are untouched."""
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    x = torch.randn((129, mlp_cfg.in_features),
                    generator=torch.Generator(device=dev).manual_seed(9),
                    device=dev)
    bad = {3: float("nan"), 64: float("inf"), 128: float("-inf")}
    for row, v in bad.items():
        x[row, 7] = v
    x = x.to(dtype)
    got = fused_mlp.apply_kernel(params, x, mlp_cfg)
    ref = fused_mlp.apply_plain(params, x, mlp_cfg)
    sync()
    rows = torch.tensor(sorted(bad), device=dev)
    good = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
    good[rows] = False
    check(not bool(torch.isfinite(got[rows]).any(dim=1).any()),
          "K1 gave a finite output for a NaN or inf input row")
    check(not bool(torch.isfinite(ref[rows]).all(dim=1).any()),
          "the plain MLP gave a finite row for a NaN or inf input row")
    err = (got[good] - ref[good]).abs()
    check(bool(torch.isfinite(got[good]).all())
          and bool((err <= K1_ATOL + K1_RTOL * ref[good].abs()).all()),
          "K1's finite rows beside NaN and inf rows disagree with plain")
    log(f"K1 {str(dtype).split('.')[-1]} with NaN / +inf / -inf rows "
        f"{sorted(bad)} of 129: those output rows non-finite (kernel: every "
        f"output; plain: at least one), the other rows within the bound "
        f"(max abs {float(err.max()):.3e})")


def compare_k2(a, b) -> dict:
    """Launch K2 on (a, b) and hold it, at the unchanged bound K2_TOL +
    K2_TOL |ref|, to the float64 product rounded to fp32 (the exact answer)
    at every shape, and to the plain version (torch.matmul, TF32 off) at
    every shape where the exact product itself meets that bound against
    the plain version. torch.matmul sums K in order in fp32: at 4096^3 it
    lies farther than the bound from the exact product at a few dozen of
    the 16.8M outputs, and so would any kernel more exact than it. Returns
    each pair's max abs difference and count of outputs outside the
    bound."""
    from neuralradiancecaching_tpu_torch.ops import matmul
    got = matmul.matmul_kernel(a, b)
    plain = matmul.matmul_plain(a, b)
    exact = (a.double() @ b.double()).float()
    sync()
    check(got.shape == plain.shape, f"K2 shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "K2 output not finite")

    def diff(x, ref):
        err = (x - ref).abs()
        return (float(err.max()),
                int((err > K2_TOL + K2_TOL * ref.abs()).sum()))
    out = {"kernel_vs_plain": diff(got, plain),
           "kernel_vs_exact": diff(got, exact),
           "plain_vs_exact": diff(plain, exact),
           "exact_vs_plain": diff(exact, plain)}
    shape = f"{tuple(a.shape)} @ {tuple(b.shape)}"
    check(out["kernel_vs_exact"][1] == 0,
          f"K2 disagrees with the float64 product at {shape}: {out}")
    out["plain_held"] = out["exact_vs_plain"][1] == 0
    if out["plain_held"]:
        check(out["kernel_vs_plain"][1] == 0,
              f"K2 disagrees with plain at {shape}: {out}")
    return out


def fp32_fma_bound_ms(flop: float, nbytes: float) -> float:
    """``bound_ms`` with the FP32 FMA pipe's peak (the bound of PRs
    1-3)."""
    return max(flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3)


def time_ms(fn, reps: int = 10, rounds: int = 5):
    """Median ms per call from CUDA events over `rounds` batches of `reps`."""
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def to_device(tree, device):
    """Tensors of a NamedTuple/list/tuple tree moved to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(to_device(x, device) for x in tree)
    return type(tree)(*[to_device(x, device) for x in tree])


def state_to(state, device):
    """A state dataclass (NRCState, ImageFitState) with every tensor moved
    to ``device``."""
    def conv(v):
        if isinstance(v, dict):
            return {k: x.to(device) for k, x in v.items()}
        return None if v is None else v.to(device)
    return type(state)(**{f.name: conv(getattr(state, f.name))
                          for f in dataclasses.fields(state)})


def progressive_config(width: int, height: int, small: bool = False,
                       field_dtype: str = "bfloat16"):
    """The quality tool's config (``bench_torch.bench_config``: config 5
    with ``bench.py``'s production settings and the fused query MLP) at 1
    spp, with f32 fields and an f32 query when ``field_dtype`` is f32; the
    caps come from :func:`probe_caps`. ``small`` cuts the scene and the
    train batch to the tests' size."""
    import bench_torch
    r = dataclasses.replace
    cfg = bench_torch.bench_config(width, height)
    if field_dtype != "bfloat16":
        cfg = r(cfg, mlp=r(cfg.mlp, inference_dtype=field_dtype),
                volume=r(cfg.volume, field_dtype=field_dtype))
    if small:
        cfg = r(cfg, path=r(cfg.path, collision_field_steps=8),
                volume=r(cfg.volume, grid_shape=(16, 12, 20),
                         field_shape=(6, 5, 8), field_dir_buckets=(8, 16)),
                env_map=r(cfg.env_map, scatter_quad_dirs=(8, 16)),
                train=r(cfg.train, train_width=16, train_height=16,
                        target_bounces=16))
    return cfg


def probe_caps(cfg, scene, dev):
    """The cap probes of ``benchmark/caps.py`` (the copy the benchmark's
    cells use) on the port: (cfg with the caps, what they measured)."""
    from benchmark import caps, spec
    return caps.probe_caps(spec.Pkg(spec.PROGRAM), cfg, scene, dev)


def query_fraction(cfg, scene, dev) -> float:
    """The share of an NN walk's lanes that query the cache, over every
    stride-th pixel ray of the frame (bench.py:161-203's query probe)."""
    from neuralradiancecaching_tpu_torch.render import pathtrace
    from neuralradiancecaching_tpu_torch.scene import camera
    w, h = cfg.render.width, cfg.render.height
    stride = max(1, (w * h) // (w * 64))
    ro, rd = camera.pixel_rays(scene.camera, w, h)
    res = pathtrace.trace_path(scene, cfg, ro[::stride], rd[::stride],
                               torch.Generator(device=dev).manual_seed(99),
                               use_nn=True)
    return float((res.query_weight > 0).float().mean())


def time_k1(params, x, mlp_cfg) -> dict:
    """K1's launch alone on weights packed once (the kernel's time), its
    whole wrapper (pack + launch, what a caller pays a call) and the plain
    version on x, in turns on one card (plain, launch, wrapper, wrapper,
    launch, plain): {name: (median ms, both runs)}."""
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    packed = fused_mlp.pack_params(params, mlp_cfg,
                                   x.dtype == torch.bfloat16, x.device)
    fns = {"launch": lambda: fused_mlp.launch(packed, x, mlp_cfg),
           "wrapper": lambda: fused_mlp.apply_kernel(params, x, mlp_cfg),
           "plain": lambda: fused_mlp.apply_plain(params, x, mlp_cfg)}
    for fn in fns.values():  # warm-up
        fn()
    sync()
    runs: dict[str, list] = {k: [] for k in fns}
    for k in ("plain", "launch", "wrapper", "wrapper", "launch", "plain"):
        runs[k].append(time_ms(fns[k]))
    return {k: (statistics.median(v), tuple(v)) for k, v in runs.items()}


def k1_record(name, launches, err, err_f64, times, flop, nbytes) -> dict:
    """K1's entry of the kernels' record line."""
    bound, by = bound_ms(flop, nbytes)
    return {"name": name, "route": "cuda",
            "source": "neuralradiancecaching_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "neuralradiancecaching_tpu/ops/pallas_mlp.py:37",
            "launches": launches, "max_abs_err": err,
            "max_abs_err_f64": err_f64, "ms": times["wrapper"][0],
            "launch_ms": times["launch"][0], "plain_ms": times["plain"][0],
            "bound_ms": bound, "bound_by": by,
            "fp32_fma_bound_ms": fp32_fma_bound_ms(flop, nbytes),
            "library_ms": None}


def log_k1_times(label, rows, times, flop, nbytes) -> None:
    bound, by = bound_ms(flop, nbytes)
    launch = times["launch"][0]
    log(f"{label} at {rows} rows: launch alone {launch:.4f} ms "
        f"{times['launch'][1]}, {flop / launch / 1e9:.2f} TFLOP/s useful; "
        f"whole wrapper (pack + launch) {times['wrapper'][0]:.4f} ms "
        f"{times['wrapper'][1]}; plain {times['plain'][0]:.4f} ms "
        f"{times['plain'][1]}; bound {bound:.4f} ms by {by} "
        f"({flop / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; FP32 FMA bound "
        f"{fp32_fma_bound_ms(flop, nbytes):.4f} ms)")


def ball_cloud(shape, seed: int = 0) -> np.ndarray:
    """A seeded random ball of density (the tiled tests' cloud): rays miss
    the box, graze it below the live threshold, or cross it."""
    rng = np.random.default_rng(seed)
    axes = [(np.arange(n) + 0.5) / n - 0.5 for n in shape]
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(*axes, indexing="ij")))
    return (rng.random(shape, dtype=np.float32) * 0.6 * (r < 0.4)).astype(
        np.float32)


def progressive_small_vs_cpu(dev, field_dtype: str) -> None:
    """The packed frame on the card vs the CPU port at the tests' size
    (32x30, 6-row bands): one ``train_only_step`` -> ``bake`` ->
    ``render_banded`` from the same O(1) state, scene and draws."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, targets, tiled
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn
    w, h, band = 32, 30, 6
    r = dataclasses.replace
    cfg = progressive_config(w, h, small=True, field_dtype=field_dtype)
    cfg = r(cfg, render=r(cfg.render, live_pack_fraction=0.75,
                          query_cap_fraction=1.0, shade_cap_fraction=1.0))
    dens, env = ball_cloud(cfg.volume.grid_shape), assets.synthesize_sky(32, 64)
    pose = camera.orbit_position(1, 8, radius=150.0)
    state = nrc.init_state(torch.Generator().manual_seed(2), cfg,
                           device="cpu")
    state = dataclasses.replace(state, mlp_params=he_params(
        cfg.mlp, torch.Generator().manual_seed(3), "cpu"))
    t_u = targets.draw_train_uniforms(cfg, torch.Generator().manual_seed(6),
                                      "cpu")
    u, out = None, []
    for d in ("cpu", dev):
        sc = scn.make_scene(cfg, dens, env, device=d)
        sc = dataclasses.replace(sc, camera=camera.make_camera(cfg.camera, d,
                                                               *pose))
        st, mse = frame.train_only_step(state_to(state, d), sc, None, cfg,
                                        to_device(t_u, d))
        pack = tiled.frame_live_pack(sc, cfg, band)
        if u is None:
            u = draw_band_uniforms(cfg, pack.ro_p.shape[0], band * w,
                                   torch.Generator().manual_seed(4))
        img = tiled.render_banded(
            st, sc, None, cfg, band, env_rgb=tiled.frame_env_color(sc, cfg),
            baked=nrc.bake(st, cfg), pack=pack, uniforms=to_device(u, d))
        out.append((img.cpu().numpy().reshape(-1, 3), float(mse),
                    int(pack.val.sum())))
    sync()
    (ref, mse_c, live_c), (got, mse_g, live_g) = out
    check(live_g == live_c, f"live rays {live_g} vs {live_c}")
    check(bool(np.isfinite(got).all()), "small packed frame not finite")
    err = np.abs(got - ref)
    rel_mean = abs(got.mean() - ref.mean()) / abs(ref.mean())
    mse_rel = abs(mse_g - mse_c) / abs(mse_c)
    if field_dtype == "float32":
        frac = np.all(err <= 1e-4 + 1e-3 * np.abs(ref), axis=-1).mean()
        ok = frac >= SMALL_FRAC_OK
        bound = "1e-4 + 1e-3|ref|"
    else:
        frac = np.all(err <= 1e-3 + 1e-3 * np.abs(ref), axis=-1).mean()
        ok = (frac >= SMALL_BF16_FRAC_OK
              and bool(np.all(err <= 1e-2 + 1e-2 * np.abs(ref))))
        bound = "1e-3 + 1e-3|ref| (all within 1e-2 + 1e-2|ref|)"
    log(f"card vs CPU port, packed progressive frame {w}x{h} with "
        f"{field_dtype} fields: {live_g} live rays on both, {frac:.4f} of "
        f"pixels within {bound}, max abs diff {float(err.max()):.3e}, mean "
        f"rel diff {rel_mean:.3e}; mse {mse_g:.6f} vs {mse_c:.6f} (rel "
        f"{mse_rel:.3e})")
    check(ok and rel_mean <= SMALL_REL_MEAN,
          f"the card's packed frame ({field_dtype}) disagrees with the CPU "
          f"port")
    check(mse_rel <= SMALL_MSE_REL, "the card's train mse disagrees")


def progressive_frame(dev, dens, env, params_he) -> dict:
    """Config 5's progressive 1920x1080 frame on the card (phases 8-8i):
    its scene bake, 3 warm-up train steps, the probes and caps, the
    pose-static hoists, K1's bf16 mode vs its plain version, P_FRAMES
    frames of ``train_only_step`` -> ``bake`` -> ``render_banded`` under
    the tracer (their kernel launches), K1 bf16 on the frame's real rows,
    the data-parallel frame, the quality legs and the card vs the CPU port
    on the small packed frame. Returns K1's bf16 entry of the kernels'
    record and the quality legs."""
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, tiled
    from neuralradiancecaching_tpu_torch.scene import scene as scn

    # -- 8. config 5's scene: bf16 fields at (32, 64) buckets ---------------
    cfg = progressive_config(P_WIDTH, P_HEIGHT)
    n_pix = P_WIDTH * P_HEIGHT
    scene = scn.make_scene(cfg, dens, env, device=dev)
    log(f"config 5 scene (dir buckets {cfg.volume.field_dir_buckets}, out "
        f"buckets {cfg.volume.field_out_buckets}):")
    for field in ("env_t_field", "env_s_field", "coll_field"):
        t = getattr(scene, field)
        check(t.dtype == torch.bfloat16, f"{field} is {t.dtype}")
        check(bool(torch.isfinite(t).all()), f"{field} not finite")
        log(f"  {field} {tuple(t.shape)} {t.dtype} mean "
            f"{float(t.float().mean()):.5f}")

    # -- 8b. cache state and the bench's warm-up train steps ----------------
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(cfg.seed),
                           cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100)
    warm = []
    for _ in range(P_WARMUP_STEPS):
        state, mse = frame.train_only_step(state, scene, gen, cfg)
        warm.append(float(mse))
    log(f"{P_WARMUP_STEPS} warm-up train_only_steps: mse "
        f"{[round(m, 5) for m in warm]}")

    # -- 8c. the probes and caps ---------------------------------------------
    qfrac = query_fraction(cfg, scene, dev)
    cfg, probes = probe_caps(cfg, scene, dev)
    probes["query_fraction"] = qfrac
    log(f"probes and caps: {json.dumps(probes)}, query cap "
        f"{cfg.render.query_cap_fraction}")
    check(0.0 < probes["live_pack_fraction"] <= 1.0, "no live rays")

    # -- 8d. pose-static hoists ---------------------------------------------
    env_rgb = tiled.frame_env_color(scene, cfg)
    pack, n = traced(dev, lambda: tiled.frame_live_pack(scene, cfg,
                                                        BAND_ROWS))
    K3_BY_PATH["orbit pose's live pack"] = n["k3_launches"]
    check(n["k3_launches"] > 0, "frame_live_pack's entry tau did not launch "
          "the quadrature kernel")
    log(f"frame_live_pack: quadrature kernel launches {n['k3_launches']}")
    n_packed = pack.ro_p.shape[0] * pack.ro_p.shape[1]
    n_live = int(pack.val.sum())
    log(f"live-ray pack: {n_live} live rays of {n_pix}, packed to "
        f"{n_packed} lanes ({pack.ro_p.shape[0]} bands of {BAND_ROWS} rows)")
    check(n_live == round(probes["live_fraction"] * n_pix),
          "the pack dropped live rays")

    # -- 8e. K1's bf16 mode vs its plain version ----------------------------
    mlp = cfg.mlp
    params_bf = {k: v.to(torch.bfloat16) for k, v in params_he.items()}
    kgen = torch.Generator(device=dev).manual_seed(8)
    err = err_f64 = 0.0
    for n_rows in K1_BF16_SIZES + (n_packed,):
        x = torch.randn((n_rows, mlp.in_features), generator=kgen,
                        device=dev).to(torch.bfloat16)
        abs_e, rel_e, f64_e, plain_f64 = compare_k1(params_bf, x, mlp)
        err, err_f64 = max(err, abs_e), max(err_f64, f64_e)
        log(f"K1 bf16 vs plain n={n_rows}: max abs {abs_e:.3e} max rel "
            f"{rel_e:.3e}; vs float64: kernel {f64_e:.3e}, plain "
            f"{plain_f64:.3e}")
    check_k1_nonfinite(params_bf, mlp, torch.bfloat16, dev)
    check_k1_pack(params_bf, mlp, True, dev)
    k1_times = time_k1(params_bf, x, mlp)
    flop, nbytes = k1_work(mlp, n_packed, 2 * mlp.in_features)
    log_k1_times("K1 bf16", n_packed, k1_times, flop, nbytes)
    del x

    # -- 8f. P_FRAMES progressive frames under the tracer --------------------
    def progressive():
        nonlocal state
        out = []
        for _ in range(P_FRAMES):
            state, mse = frame.train_only_step(state, scene, gen, cfg)
            img = tiled.render_banded(state, scene, gen, cfg, BAND_ROWS,
                                      env_rgb=env_rgb,
                                      baked=nrc.bake(state, cfg), pack=pack)
            out.append((float(mse), img))
        return out

    out, n = traced(dev, progressive)
    mses = [m for m, _ in out]
    means = []
    for i, (_, img) in enumerate(out):
        check(tuple(img.shape) == (P_HEIGHT, P_WIDTH, 3), f"image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"progressive frame {i} not "
              f"finite")
        means.append(float(img.mean()))
    del out
    launches = n["k1_bf16_launches"]
    check(launches >= P_FRAMES, f"K1 bf16 launched {launches} times in "
          f"{P_FRAMES} progressive frames")
    check(all(1e-3 < m < 1e3 for m in means), f"frame means {means}")
    check(all(np.isfinite(mses)), f"train mse {mses}")
    log(f"{P_FRAMES} progressive frames {P_WIDTH}x{P_HEIGHT} "
        f"(train_only_step -> bake -> render_banded, {BAND_ROWS}-row bands): "
        f"mse {[round(m, 5) for m in mses]}; image means "
        f"{[round(m, 5) for m in means]}; K1 bf16 launches {launches}, K1 "
        f"f32 launches {n['k1_f32_launches']}, K2 launches "
        f"{n['k2_launches']}")

    # -- 8g. K1 bf16 on the frame's real rows; no entry tau per frame --------
    baked = nrc.bake(state, cfg)
    _, _, _, qp, qd, qw, _ = tiled._packed_bands_program(scene, gen, cfg,
                                                         BAND_ROWS, pack)
    feats = nrc.encode_baked(state, baked, qp, qd, cfg)
    _, n = traced(dev, lambda: tiled.render_banded(
        state, scene, gen, cfg, BAND_ROWS, env_rgb=env_rgb, baked=baked,
        pack=pack))
    log(f"  entry-tau quadratures (transmittance spans) in one "
        f"render_banded: {n['span transmittance']}")
    check(n["span transmittance"] == 0,
          "render_banded ran the entry-tau quadrature")
    log(f"real bf16 feature rows {tuple(feats.shape)}, "
        f"{float((qw > 0).float().mean()):.4f} of the packed lanes querying")
    for label, params in (("state weights", {
            k: v.to(torch.bfloat16) for k, v in state.mlp_params.items()}),
            ("O(1) weights", params_bf)):
        abs_e, rel_e, f64_e, plain_f64 = compare_k1(params, feats, mlp)
        err, err_f64 = max(err, abs_e), max(err_f64, f64_e)
        log(f"K1 bf16 vs plain on real rows ({label}): max abs {abs_e:.3e} "
            f"max rel {rel_e:.3e}; vs float64: kernel {f64_e:.3e}, plain "
            f"{plain_f64:.3e}")
    del baked, feats, qp, qd, qw
    torch.cuda.empty_cache()

    phase("16a: config 5 data parallel")
    # -- 16a, 16c. the production frame data-parallel, the per-shard probe --
    dp_launches = dp_progressive(dev, scene, cfg, state, env_rgb, pack,
                                 probes)
    del pack, env_rgb
    torch.cuda.empty_cache()

    phase("8h: quality legs")
    # -- 8h. the bench's quality legs on config 5's scene --------------------
    legs = quality_legs(dev, scene, cfg, state)
    del scene, state
    torch.cuda.empty_cache()

    phase("8i: packed frame card vs CPU")
    # -- 8i. the card vs the CPU port on the small packed frame -------------
    for field_dtype in ("float32", "bfloat16"):
        progressive_small_vs_cpu(dev, field_dtype)

    return k1_record("fused_mlp_bf16", launches + dp_launches, err, err_f64,
                     k1_times, flop, nbytes), legs


def quality_legs(dev, scene, cfg, state) -> dict:
    """The quality tool's ground-truth legs (``bench_torch``'s
    ``_ground_truth_legs``, bench.py:755-829) on the card at Q_SIDE^2 on
    config 5's scene (the tool's scene keeps config 5's camera), after
    Q_TRAIN_STEPS more train steps: the unbiased oracle in twins of
    2 x Q_GT_SPP frames, the shipped no-cache collision render and the NN
    render (``bench_torch.quality_config``: query cap 0.375) in twins of
    Q_GT_SPP, every pair held to the oracle's twins by the port's
    ``utils/metrics.py``; not the spp-2 twins. Returns the legs."""
    import bench_torch
    from neuralradiancecaching_tpu_torch.render import frame
    qcfg = bench_torch.quality_config(cfg, Q_SIDE)
    gen = torch.Generator(device=dev).manual_seed(1000)
    mses = []
    for _ in range(Q_TRAIN_STEPS):
        state, mse = frame.train_only_step(state, scene, gen, cfg)
        mses.append(mse)
    mses = [float(m) for m in mses]
    check(bool(np.isfinite(mses).all()), "quality-leg train mse not finite")
    legs = bench_torch._ground_truth_legs(qcfg, scene, state, dev, Q_GT_SPP,
                                          Q_SIDE, spp2=False)
    legs.update(train_steps=Q_TRAIN_STEPS, size=Q_SIDE,
                query_cap_fraction=qcfg.render.query_cap_fraction)
    log(f"quality legs {Q_SIDE}x{Q_SIDE} (bench protocol): " + json.dumps(
        legs))
    log(f"  {Q_TRAIN_STEPS} train steps: mse first 8 "
        f"{np.mean(mses[:8]):.5f}, last 8 {np.mean(mses[-8:]):.5f}; the "
        f"legs' twins: oracle 4 x {Q_GT_SPP}, collision and NN 2 x "
        f"{Q_GT_SPP} frames each")
    check(all(np.isfinite(v) for v in legs.values()), "quality legs not "
          "finite")
    # a gross check of the two samplers against each other (the cache
    # leg depends on the training and is only measured)
    check(legs["oracle_mean"] > 0.0
          and abs(legs["ground_truth_mean_delta"]) < 0.25,
          "the collision render's mean strays from the oracle's by more "
          "than 25%")
    return legs


def preset_config(name: str, small: bool = False):
    """Configs 3 and 4 as they ship at PRESET_SIDE (config 4 with
    ``fused_inference`` so K1 f32 lies on its cache query); ``small`` cuts
    them to the tests' scale (tests/test_torch_reference.py)."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    r = dataclasses.replace
    side = 32 if small else PRESET_SIDE
    if name == "config3":
        cfg = cfg_mod.pathtrace_config(side, side)
    else:
        cfg = cfg_mod.nrc_online_config(side, side)
        cfg = r(cfg, mlp=r(cfg.mlp, fused_inference=True))
    return small_cut(cfg) if small else cfg


def small_cut(cfg):
    """A preset cut to the tests' scale (tests/test_torch_reference.py:cut):
    8 bounces, the (16, 12, 20) grid, (6, 5, 8) fields, a 16x16 train grid
    of 16-step target walks."""
    r = dataclasses.replace
    return r(cfg, path=r(cfg.path, max_bounces=8),
             volume=r(cfg.volume, grid_shape=(16, 12, 20),
                      field_shape=(6, 5, 8)),
             env_map=r(cfg.env_map, scatter_quad_dirs=(8, 16)),
             train=r(cfg.train, train_width=16, train_height=16,
                     target_bounces=16))


def banded_frame(label: str, fn, band: int) -> None:
    """A preset's 800x800 frame in the CLI's bands (phases 9b, 10b): one
    frame, its shape and finiteness checked."""
    phase(f"9b/10b: {label} banded")
    img = fn()
    check(tuple(img.shape) == (PRESET_SIDE, PRESET_SIDE, 3)
          and bool(torch.isfinite(img).all()),
          f"{label} banded frame not finite")
    log(f"{label} render_banded {PRESET_SIDE}x{PRESET_SIDE} in "
        f"{PRESET_SIDE // band} bands of {band} rows: image mean "
        f"{float(img.mean()):.5f}")


def preset_frames(dev, dens, env, params_he):
    """Configs 3 and 4 as they ship, at 800x800 on the card (phases 9-10):
    config 3's render_only_step (reference sampler, cache off: no bake, no
    query), config 4's frame_step (the reference vertex walk and 64-step
    target walks, the train step, the two-phase march, the compacted
    shade, the K1 f32 query), N_FRAMES of each under the tracer (their
    kernel launches), 32 train_only_steps whose mse must fall, both renders
    in the CLI's 32-row bands, and K1 f32 held to its plain version on
    config 4's real query rows. Returns (K1 f32's launches in the
    config-4 frames, its max abs error vs plain and vs float64 there, its
    launches in the dense/hash frames and in the data-parallel frame)."""
    from neuralradiancecaching_tpu_torch import cli
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace, tiled
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn
    c3, c4 = preset_config("config3"), preset_config("config4")
    check(c3.path.sampler == c4.path.sampler == "reference"
          and not c3.render.use_nn and c4.render.use_nn,
          "the presets no longer ship the reference sampler")
    # the presets share their volume and env settings, so one scene serves
    # both
    check(c3.volume == c4.volume and c3.env_map == c4.env_map,
          "configs 3 and 4 differ in their scene")
    scene = scn.make_scene(c3, dens, env, device=dev)
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(0), c4,
                           device=dev)

    phase("9: config 3")
    # -- 9. config 3: the cache-off reference render --------------------------
    gen = torch.Generator(device=dev).manual_seed(3)
    imgs, n = traced(dev, lambda: [frame.render_only_step(state, scene, gen,
                                                          c3)
                                   for _ in range(N_FRAMES)])
    means = [float(img.mean()) for img in imgs]
    check(all(tuple(img.shape) == (PRESET_SIDE, PRESET_SIDE, 3)
              and bool(torch.isfinite(img).all()) for img in imgs),
          "config 3 frame not finite")
    check(all(1e-3 < m < 1e3 for m in means), f"config 3 means {means}")
    check(n["span k1"] == 0, "config 3 (cache off) launched K1")
    log(f"config 3 render_only_step {PRESET_SIDE}x{PRESET_SIDE} (reference "
        f"sampler, {c3.path.max_bounces} slots, dense shade, cache off): "
        f"means {[round(m, 5) for m in means]}, K1 launches "
        f"{n['k1_f32_launches'] + n['k1_bf16_launches']}")
    del imgs
    # the same frame as the CLI renders it (its bands above 512x512)
    band = cli._band_rows(PRESET_SIDE, PRESET_SIDE)
    banded_frame("config 3", lambda: tiled.render_banded(
        state, scene, gen, c3, band_rows=band), band)

    phase("10: config 4")
    # -- 10. config 4: the online frame with the reference sampler ------------
    gen = torch.Generator(device=dev).manual_seed(4)

    def online():
        nonlocal state
        outs = []
        for _ in range(N_FRAMES):
            state, out = frame.frame_step(state, scene, gen, c4)
            outs.append(out)
        return outs

    outs, n = traced(dev, online)
    launches = n["k1_f32_launches"]
    mses = [float(o.mse) for o in outs]
    check(all(bool(torch.isfinite(o.image).all()) for o in outs)
          and all(np.isfinite(mses)), "config 4 frame not finite")
    check(launches >= N_FRAMES, f"K1 f32 launched {launches} times in "
          f"{N_FRAMES} config-4 frames")
    log(f"config 4 frame_step {PRESET_SIDE}x{PRESET_SIDE} (reference "
        f"sampler, train {c4.train.train_width}x{c4.train.train_height} x "
        f"{c4.train.target_samples} target walks of "
        f"{c4.train.target_bounces} steps): mse "
        f"{[round(m, 5) for m in mses]}; image means "
        f"{[round(float(o.image.mean()), 5) for o in outs]}; K1 f32 launches "
        f"{launches}, K1 bf16 {n['k1_bf16_launches']}, K2 "
        f"{n['k2_launches']}")
    del outs

    steps = []
    for _ in range(TRAIN_STEPS):
        state, mse = frame.train_only_step(state, scene, gen, c4)
        steps.append(mse)
    steps = [float(m) for m in steps]
    first, last = np.mean(steps[:8]), np.mean(steps[-8:])
    log(f"config 4: {TRAIN_STEPS} train_only_steps, mse "
        f"{[round(m, 4) for m in steps]}, mean of the first 8 "
        f"{first:.5f}, of the last 8 {last:.5f}")
    check(bool(np.isfinite(steps).all()), "config 4 train mse not finite")
    check(last < first, f"config 4's mse did not fall: {first} -> {last}")

    # K1 f32 on the render's real query rows
    ro, rd = camera.pixel_rays(scene.camera, PRESET_SIDE, PRESET_SIDE)
    res = pathtrace.trace_path(scene, c4, ro, rd, gen, use_nn=True)
    feats = nrc.encode_baked(state, nrc.bake(state, c4), res.query_pos,
                             res.query_dir, c4)
    err = err_f64 = 0.0
    for label, params in (("state weights", state.mlp_params),
                          ("O(1) weights", params_he)):
        abs_e, rel_e, f64_e, plain_f64 = compare_k1(params, feats, c4.mlp)
        err, err_f64 = max(err, abs_e), max(err_f64, f64_e)
        log(f"K1 vs plain on config 4's real rows {tuple(feats.shape)} "
            f"({label}): max abs {abs_e:.3e} max rel {rel_e:.3e}; vs "
            f"float64: kernel {f64_e:.3e}, plain {plain_f64:.3e}")
    log(f"  config 4 render: {float((res.query_weight > 0).float().mean()):.4f}"
        f" of the rays query the cache")
    del feats
    phase("10c: dense/hash")
    # -- 10c. the same frame with the dense bake and the hash train encode
    launches_dense = dense_hash_frames(dev, scene, state, c4, gen, res)
    del res
    phase("16b: config 4 data parallel")
    # -- 16b. the same frame data-parallel ----------------------------------
    launches_dp = dp_preset(dev, scene, state, c4)
    # the render half as the CLI's nrc-online renders it, banded
    banded_frame("config 4", lambda: tiled.render_banded(
        state, scene, gen, c4, band_rows=band), band)
    return launches, err, err_f64, launches_dense, launches_dp


def dense_hash_config(c4):
    """Config 4 with the dense inference bake and the hash-path train
    encode (MRHEConfig.inference_bake / train_encode)."""
    r = dataclasses.replace
    return r(c4, mrhe=r(c4.mrhe, inference_bake="dense", train_encode="hash"))


def dense_hash_frames(dev, scene, state, c4, gen, res) -> int:
    """Config 4 as it ships at 800x800 with the dense inference bake and
    the hash-path train encode (phase 10c): DENSE_FRAMES frame_steps under
    the tracer (K1 f32 on the query), and ``encode_baked`` dense against
    the oct path on the frame's 640,000 query rows ``res``, whose in-box
    rows must agree. Returns K1 f32's launches in the frames."""
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.ops import mrhe
    from neuralradiancecaching_tpu_torch.render import frame
    cd = dense_hash_config(c4)

    def online():
        st, outs = state, []
        for _ in range(DENSE_FRAMES):
            st, out = frame.frame_step(st, scene, gen, cd)
            outs.append(out)
        return outs

    outs, n = traced(dev, online)
    launches = n["k1_f32_launches"]
    mses = [float(o.mse) for o in outs]
    check(all(bool(torch.isfinite(o.image).all()) for o in outs)
          and all(np.isfinite(mses)), "dense/hash config-4 frame not finite")
    check(launches >= DENSE_FRAMES, f"K1 f32 launched {launches} times in "
          f"{DENSE_FRAMES} dense/hash config-4 frames")
    log(f"config 4 frame_step {PRESET_SIDE}x{PRESET_SIDE}, dense bake + hash "
        f"train encode: mse {[round(m, 5) for m in mses]}; K1 f32 launches "
        f"{launches}")
    del outs
    baked = {"oct": nrc.bake(state, c4), "dense": nrc.bake(state, cd)}
    log(f"  baked rows: oct {tuple(baked['oct'].shape)}, dense "
        f"{tuple(baked['dense'].shape)} ({baked['dense'].numel() * 4 / 1e6:.1f}"
        f" MB f32)")
    qp, qd = res.query_pos, res.query_dir
    f_oct = nrc.encode_baked(state, baked["oct"], qp, qd, c4)
    f_dense = nrc.encode_baked(state, baked["dense"], qp, qd, cd)
    pn = mrhe.normalize_pos(qp, c4.volume.box_size, c4.volume.box_center)
    inside = ((pn >= 0) & (pn <= 1)).all(dim=-1)
    diff = float((f_oct - f_dense)[inside].abs().max())
    log(f"  encode_baked dense vs oct on {int(inside.sum())} in-box query rows "
        f"of {qp.shape[0]}: max abs diff {diff:.3e}")
    check(diff <= 1e-5, "the dense encode disagrees with the oct encode")
    return launches


def dense_hash_small_vs_cpu(dev) -> None:
    """The card vs the CPU port at 32x32 with the same draws (drawn on the
    CPU): one frame_step of config 4 as it ships (tests' scale) with the
    dense bake and the hash train encode, from O(1) weights, at the train
    tests' bounds."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace, targets
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    cd = dense_hash_config(preset_config("config4", small=True))
    rng = np.random.default_rng(0)
    dens = rng.random(cd.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    cpu_gen = torch.Generator().manual_seed(12)
    u_t = targets.draw_train_uniforms(cd, cpu_gen, "cpu")
    u_r = pathtrace.draw_path_uniforms(cd, 32 * 32, True, cpu_gen)
    state = nrc.init_state(torch.Generator().manual_seed(2), cd,
                           device="cpu")
    state = dataclasses.replace(state, mlp_params=he_params(
        cd.mlp, torch.Generator().manual_seed(3), "cpu"))
    out = []
    for d in ("cpu", dev):
        sc = scn.make_scene(cd, dens, env, device=d)
        st, o = frame.frame_step(state_to(state, d), sc, None, cd,
                                 train_uniforms=to_device(u_t, d),
                                 uniforms=to_device(u_r, d))
        out.append((o.image.cpu().numpy(), float(o.mse), state_to(st, "cpu")))
    sync()
    (img_c, mse_c, st_c), (img_g, mse_g, st_g) = out
    ok = np.all(np.abs(img_g - img_c) <= 1e-4 + 1e-3 * np.abs(img_c),
                axis=-1)
    rel = abs(img_g.mean() - img_c.mean()) / abs(img_c.mean())
    mse_rel = abs(mse_g - mse_c) / abs(mse_c)
    p_err = max(float((st_g.mlp_params[k] - st_c.mlp_params[k]).abs().max())
                for k in st_c.mlp_params)
    h_diff = (st_g.hash_table - st_c.hash_table).abs()
    h_frac = float((h_diff <= SMALL_PARAM_TOL).float().mean())
    log(f"card vs CPU port, dense/hash config-4 frame_step 32x32: "
        f"{ok.mean():.4f} of pixels within 1e-4 + 1e-3|ref|, mean rel diff "
        f"{rel:.3e}; mse {mse_g:.6f} vs {mse_c:.6f} (rel {mse_rel:.3e}); MLP "
        f"parameters max abs diff {p_err:.3e}; hash entries within "
        f"{SMALL_PARAM_TOL:g}: {h_frac:.6f}, max abs diff "
        f"{float(h_diff.max()):.3e}")
    check(bool(np.isfinite(img_g).all()) and ok.mean() >= SMALL_FRAC_OK
          and rel <= SMALL_REL_MEAN,
          "the card's dense/hash frame disagrees with the CPU port")
    check(mse_rel <= SMALL_MSE_REL, "the card's dense/hash mse disagrees")
    check(p_err <= SMALL_PARAM_TOL, "the card's dense/hash MLP step disagrees")
    check(h_frac >= SMALL_HASH_FRAC
          and float(h_diff.max()) <= 2 * cd.mrhe.learning_rate * 1.0001,
          "the card's dense/hash hash-table step disagrees")


def presets_small_vs_cpu(dev) -> None:
    """The card vs the CPU port at 32x32 with the same draws (drawn on the
    CPU): the oracle's render (delta, ratio, MC, 32 bounces on the tests'
    grid) and one frame_step of config 4 as it ships (tests' scale)."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace, targets
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    r = dataclasses.replace
    c5 = cfg_mod.progressive_1080p_config()
    oracle = r(c5, camera=r(c5.camera, aspect=1.0),
               render=r(c5.render, width=32, height=32, use_nn=False),
               path=r(c5.path, sampler="delta", transmittance_mode="ratio"),
               env_map=r(c5.env_map, in_scatter_mode="mc",
                         transmittance_mode="ratio"),
               volume=r(c5.volume, field_dtype="float32",
                        grid_shape=(16, 12, 20), field_shape=(6, 5, 8)))
    c4 = preset_config("config4", small=True)
    rng = np.random.default_rng(0)
    dens = rng.random(c4.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    cpu_gen = torch.Generator().manual_seed(11)
    u_o = pathtrace.draw_path_uniforms(oracle, 32 * 32, False, cpu_gen)
    u_t = targets.draw_train_uniforms(c4, cpu_gen, "cpu")
    u_r = pathtrace.draw_path_uniforms(c4, 32 * 32, True, cpu_gen)
    state = nrc.init_state(torch.Generator().manual_seed(2), c4,
                           device="cpu")
    state = dataclasses.replace(state, mlp_params=he_params(
        c4.mlp, torch.Generator().manual_seed(3), "cpu"))
    out = []
    for d in ("cpu", dev):
        so = scn.make_scene(oracle, dens, env, device=d)
        img_o = frame.render_only_step(state_to(state, d), so, None, oracle,
                                       uniforms=to_device(u_o, d))
        s4 = scn.make_scene(c4, dens, env, device=d)
        st, o4 = frame.frame_step(state_to(state, d), s4, None, c4,
                                  train_uniforms=to_device(u_t, d),
                                  uniforms=to_device(u_r, d))
        out.append((img_o.cpu().numpy(), o4.image.cpu().numpy(),
                    float(o4.mse), state_to(st, "cpu")))
    sync()
    (o_c, f_c, mse_c, st_c), (o_g, f_g, mse_g, st_g) = out
    for label, got, ref in (("oracle render", o_g, o_c),
                            ("config-4 frame_step", f_g, f_c)):
        ok = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
        rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
        log(f"card vs CPU port, {label} 32x32: {ok.mean():.4f} of pixels "
            f"within 1e-4 + 1e-3|ref|, mean rel diff {rel:.3e}, max abs diff "
            f"{float(np.abs(got - ref).max()):.3e}")
        check(bool(np.isfinite(got).all()) and ok.mean() >= SMALL_FRAC_OK
              and rel <= SMALL_REL_MEAN,
              f"the card's {label} disagrees with the CPU port")
    mse_rel = abs(mse_g - mse_c) / abs(mse_c)
    h_diff = (st_g.hash_table - st_c.hash_table).abs()
    h_frac = float((h_diff <= SMALL_PARAM_TOL).float().mean())
    log(f"  config-4 frame: mse {mse_g:.6f} vs {mse_c:.6f} (rel "
        f"{mse_rel:.3e}); hash entries within {SMALL_PARAM_TOL:g}: "
        f"{h_frac:.6f}")
    check(mse_rel <= SMALL_MSE_REL, "the card's config-4 train mse disagrees")
    check(h_frac >= SMALL_HASH_FRAC
          and float(h_diff.max()) <= 2 * c4.mrhe.learning_rate * 1.0001,
          "the card's config-4 hash-table step disagrees")


def draw_band_uniforms(cfg, n_bands: int, band_n: int, gen):
    """Every draw of a banded frame in ``render_banded``'s seam, one entry
    per band: the cache off, one ``render_image`` draw (a list of spp); the
    cache on, one walk's PathUniforms per copy of the spp x n_bands."""
    from neuralradiancecaching_tpu_torch.render import pathtrace
    spp = cfg.render.spp
    if not cfg.render.use_nn:
        def one():
            return pathtrace.draw_path_uniforms(cfg, band_n, False, gen)
        return [[one() for _ in range(spp)] if spp > 1 else one()
                for _ in range(n_bands)]
    return [pathtrace.draw_path_uniforms(cfg, band_n, True, gen)
            for _ in range(spp * n_bands)]


def banded_small_vs_cpu(dev) -> None:
    """The card vs the CPU port on each branch of ``render_banded`` that
    the CLI reaches (phase 13), at 32x32 in 8-row bands (12 bounces, so
    the cache-off walks split) from one O(1) state, the same scene and
    the same draws (drawn on the CPU): the cache off with each sampler,
    the cached reference sampler (the in-band shade, then the reference
    composite), the delta sampler's deferred shade packed and unpacked and
    its in-band shade (quadrature light transmittance), and spp 2 by
    virtual-ray expansion."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import pathtrace, tiled
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn
    side, band = 32, 8
    r = dataclasses.replace
    base = progressive_config(side, side, small=True, field_dtype="float32")
    base = r(base, render=r(base.render, query_cap_fraction=1.0,
                            shade_cap_fraction=1.0))
    dens, env = ball_cloud(base.volume.grid_shape), assets.synthesize_sky(32,
                                                                         64)
    pose = camera.orbit_position(1, 8, radius=150.0)
    state = nrc.init_state(torch.Generator().manual_seed(2), base,
                           device="cpu")
    state = dataclasses.replace(state, mlp_params=he_params(
        base.mlp, torch.Generator().manual_seed(3), "cpu"))
    scenes: dict = {}
    for sampler, use_nn, spp, packed, light in BANDED_CASES:
        cfg = r(base, path=r(base.path, sampler=sampler, max_bounces=12,
                             transmittance_mode=light),
                render=r(base.render, use_nn=use_nn, spp=spp,
                         live_pack_fraction=0.75 if packed else 0.0))
        check(pathtrace.shade_deferred(cfg)
              == (sampler != "reference" and light == "field"),
              f"shade_deferred({sampler}, {light})")
        u, imgs = None, []
        for d in ("cpu", dev):
            if (sampler, d) not in scenes:
                sc = scn.make_scene(cfg, dens, env, device=d)
                scenes[sampler, d] = dataclasses.replace(
                    sc, camera=camera.make_camera(cfg.camera, d, *pose))
            sc = scenes[sampler, d]
            pack = tiled.frame_live_pack(sc, cfg, band) if packed else None
            if u is None:
                n_bands = pack.ro_p.shape[0] if packed else side // band
                u = draw_band_uniforms(cfg, n_bands, band * side,
                                       torch.Generator().manual_seed(7))
            imgs.append(tiled.render_banded(
                state_to(state, d), sc, None, cfg, band, pack=pack,
                uniforms=to_device(u, d)).cpu().numpy().reshape(-1, 3))
        sync()
        ref, got = imgs
        err = np.abs(got - ref)
        frac = np.all(err <= 1e-4 + 1e-3 * np.abs(ref), axis=-1).mean()
        rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
        label = (f"{sampler}, cache {'on' if use_nn else 'off'}, spp {spp}"
                 + (", packed" if packed else "")
                 + (f", {light} light transmittance" if light != "field"
                    else ""))
        log(f"card vs CPU port, render_banded {side}x{side} ({label}): "
            f"{frac:.4f} of pixels within 1e-4 + 1e-3|ref|, mean rel diff "
            f"{rel:.3e}, max abs diff {float(err.max()):.3e}")
        check(bool(np.isfinite(got).all()) and frac >= SMALL_FRAC_OK
              and rel <= SMALL_REL_MEAN,
              f"the card's banded frame ({label}) disagrees with the CPU port")


def cli_runs() -> dict:
    """The port's CLI as a user runs it (phase 12), each subcommand in its
    own process at its default size: ``pathtrace`` (config 3: 800x800, the
    reference sampler, the cache off, 32-row bands), ``pathtrace --sampler
    delta --spp 2``, ``nrc-online`` (config 4: 4 frames of a train step
    and the banded cached render, then a checkpoint), the same resumed for
    one frame, and ``progressive`` (config 5: 4 frames at 1920x1080, a
    metrics row per frame). Each must exit 0 with a finite image of a
    plausible mean; the resume must load (the Adam counter goes on from
    the checkpoint's). Returns each run's frame times, peak memory of each
    frame (of the frames since the previous row; the scene bake
    excluded) and image mean."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    from neuralradiancecaching_tpu_torch.io import checkpoint
    from neuralradiancecaching_tpu_torch.models import nrc
    root = REPO / "out" / "chip_smoke_cli"
    ck = root / "nrc_online" / "ck"
    ck2 = root / "nrc_online_resume" / "ck"
    runs = [("pathtrace", "pathtrace", ["pathtrace"]),
            ("pathtrace_delta_spp2", "pathtrace",
             ["pathtrace", "--sampler", "delta", "--spp", "2"]),
            ("nrc_online", "nrc_online",
             ["nrc-online", "--frames", str(N_FRAMES), "--checkpoint",
              str(ck)]),
            ("nrc_online_resume", "nrc_online",
             ["nrc-online", "--frames", "1", "--resume", str(ck),
              "--checkpoint", str(ck2)]),
            ("progressive", "progressive",
             ["progressive", "--frames", str(N_FRAMES), "--sync-every",
              "1"])]
    out = {name: run_cli(name, image, [sys.executable, *CLI_MODULE, *argv],
                         root)
           for name, image, argv in runs}
    check(f"resumed from {ck}" in out["nrc_online_resume"]["stdout"],
          "the resumed run did not report its resume")
    like = nrc.init_state(torch.Generator().manual_seed(0),
                          cfg_mod.nrc_online_config(), device="cpu")
    step = int(checkpoint.load(str(ck2), like).opt_step)
    check(step == N_FRAMES + 1, f"the resumed run's Adam counter is {step}, "
          f"not {N_FRAMES + 1}: the resume did not load")
    return out


def run_cli(name: str, image: str, cmd: list, root: Path) -> dict:
    """One CLI run in its own process (``cmd``, to which the output
    directory ``root / name`` and a metrics file are added): it must exit
    0 with a finite image of a plausible mean (read back, then deleted)
    and its metrics rows. Returns its frame times, the peak memory of
    each metrics row, the image mean, the process wall time and its
    stdout."""
    from neuralradiancecaching_tpu_torch.io import exr
    d = root / name
    d.mkdir(parents=True, exist_ok=True)
    metrics = d / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    sync()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "--out", str(d), "--metrics", str(metrics)],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  cli {name}: {line}")
    check(proc.returncode == 0, f"cli {' '.join(cmd)} exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    img = exr.read_exr(str(d / f"{image}.exr"))
    (d / f"{image}.exr").unlink()
    rows = [json.loads(line) for line in open(metrics)]
    mean = float(img.mean())
    check(img.ndim == 3 and img.shape[2] == 3
          and bool(np.isfinite(img).all()), f"cli {name}: image "
          f"{img.shape} not finite")
    check(1e-3 < mean < 1e3, f"cli {name}: image mean {mean}")
    frame_s = [row["frame_s"] for row in rows]
    peaks = [row["peak_gib"] for row in rows]
    sub = cmd.index(CLI_MODULE[1]) + 1
    log(f"cli {name} ({' '.join(cmd[sub + 1:]) or 'defaults'}) "
        f"{img.shape[1]}x{img.shape[0]}: frame ms "
        f"{[round(t * 1e3, 3) for t in frame_s]}, peak memory per frame "
        f"{[round(p, 3) for p in peaks]} GiB, image mean {mean:.5f}; "
        f"process {wall:.1f} s (start-up and scene bake included) [{CARD}]")
    return {"size": f"{img.shape[1]}x{img.shape[0]}",
            "frame_ms": [t * 1e3 for t in frame_s], "peak_gib": peaks,
            "mean": mean, "process_s": wall, "stdout": proc.stdout}


def image_fit_run() -> dict:
    """``image-fit`` as a user runs it (phase 14), in its own process at its
    defaults: 500 steps of batch 8192 with ``default_configs()`` on the env
    map ``load_env_map`` finds. Its metrics row gives the PSNR and the
    fit's seconds; the fitted image must come back finite."""
    from neuralradiancecaching_tpu_torch.io import exr
    d = REPO / "out" / "chip_smoke_cli" / "image_fit"
    d.mkdir(parents=True, exist_ok=True)
    metrics = d / "metrics.jsonl"
    metrics.unlink(missing_ok=True)
    sync()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "neuralradiancecaching_tpu_torch.cli",
         "image-fit", "--out", str(d), "--metrics", str(metrics)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  cli image_fit: {line}")
    check(proc.returncode == 0, f"cli image-fit exited {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    row = json.loads(metrics.read_text().splitlines()[-1])
    img = exr.read_exr(str(d / "image_fit.exr"))
    (d / "image_fit.exr").unlink()
    check(img.ndim == 3 and img.shape[2] == 3
          and bool(np.isfinite(img).all()), "cli image-fit: image not finite")
    check(bool(np.isfinite(row["psnr"])) and row["psnr"] > 0.0,
          f"cli image-fit: psnr {row['psnr']}")
    steps = row["step"]
    out = {"psnr_db": row["psnr"], "fit_s": row["fit_s"],
           "ms_per_step": row["fit_s"] * 1e3 / steps, "process_s": wall,
           "size": f"{img.shape[1]}x{img.shape[0]}"}
    log(f"cli image_fit (defaults: {steps} steps of batch 8192) on "
        f"{out['size']}: psnr {row['psnr']:.4f} dB, fit {row['fit_s']:.3f} s "
        f"= {out['ms_per_step']:.3f} ms per step (the final full-image "
        f"PSNR included); process {wall:.1f} s [{CARD}]")
    return out


def image_fit_small_vs_cpu(dev) -> None:
    """``image_fit.train_step`` on the card vs the CPU port from one state
    (default configs) and one batch of 8192 env-map pixels."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import image_fit
    mrhe_cfg, mlp_cfg, opt = image_fit.default_configs()
    img = torch.as_tensor(assets.load_env_map(), dtype=torch.float32)
    h, w = img.shape[:2]
    gen = torch.Generator().manual_seed(13)
    state = image_fit.init_state(gen, mrhe_cfg, mlp_cfg, device="cpu")
    idx = torch.randint(0, h * w, (8192,), generator=gen)
    uv, rgb = image_fit.pixel_uv(idx, h, w), img.reshape(-1, 3)[idx]
    out = []
    for d in ("cpu", dev):
        s, mse = image_fit.train_step(state_to(state, d), uv.to(d),
                                      rgb.to(d), mrhe_cfg, mlp_cfg, opt)
        out.append((s, float(mse)))
    sync()
    (s_c, mse_c), (s_g, mse_g) = out
    mse_rel = abs(mse_g - mse_c) / abs(mse_c)
    p_err = max(float((s_g.mlp_params[k].cpu() - s_c.mlp_params[k])
                      .abs().max()) for k in s_c.mlp_params)
    h_diff = (s_g.hash_table.cpu() - s_c.hash_table).abs()
    h_frac = float((h_diff <= SMALL_PARAM_TOL).float().mean())
    log(f"card vs CPU port, image_fit.train_step (batch 8192): mse "
        f"{mse_g:.6f} vs {mse_c:.6f} (rel {mse_rel:.3e}); MLP parameters max "
        f"abs diff {p_err:.3e}; hash entries within {SMALL_PARAM_TOL:g}: "
        f"{h_frac:.6f}, max abs diff {float(h_diff.max()):.3e}")
    check(mse_rel <= FIT_MSE_REL, "the card's image-fit mse disagrees")
    check(p_err <= SMALL_PARAM_TOL, "the card's image-fit MLP step disagrees")
    check(h_frac >= SMALL_HASH_FRAC and float(h_diff.max()) <= FIT_HASH_ALL,
          "the card's image-fit hash-table step disagrees")


def write_idx_labels(path: Path, labels: np.ndarray) -> None:
    path.write_bytes(struct.pack(">ii", 2049, len(labels))
                     + labels.astype(np.uint8).tobytes())


def mnist_run() -> dict:
    """``mnist`` at its defaults (phase 14): 300 steps on the first 10,000
    train rows, test accuracy on 2048 t10k rows, run in-process through
    ``cli.main``. The machine has no MNIST label file, so this writes
    synthetic idx1 labels (seeded) into a temporary directory and points
    the port's MNIST candidates there; the images are synthesized from the
    labels as the loader does when no image file lies beside them."""
    from neuralradiancecaching_tpu_torch import cli
    from neuralradiancecaching_tpu_torch.io import assets
    rng = np.random.default_rng(14)
    saved = assets.MNIST_DIRS
    with tempfile.TemporaryDirectory() as tmp:
        write_idx_labels(Path(tmp) / "train-labels-idx1-ubyte",
                         rng.integers(0, 10, MNIST_TRAIN_LABELS))
        write_idx_labels(Path(tmp) / "t10k-labels-idx1-ubyte",
                         rng.integers(0, 10, MNIST_TEST_LABELS))
        log(f"mnist: synthetic labels ({MNIST_TRAIN_LABELS} train, "
            f"{MNIST_TEST_LABELS} t10k, seeded) written as idx1 files; "
            f"images synthesized from them")
        assets.MNIST_DIRS = (tmp,)
        metrics = Path(tmp) / "metrics.jsonl"
        try:
            sync()
            t0 = time.perf_counter()
            cli.main(["mnist", "--out", tmp, "--metrics", str(metrics)])
            sync()
            wall = time.perf_counter() - t0
        finally:
            assets.MNIST_DIRS = saved
        row = json.loads(metrics.read_text().splitlines()[-1])
    log(f"cli mnist (defaults: {row['step']} steps, --limit "
        f"{MNIST_TRAIN_LABELS}): train loss {row['train_loss']:.5f}, train "
        f"accuracy {row['train_acc']:.4f}, test accuracy "
        f"{row['test_acc']:.4f}; {wall:.3f} s in-process (image synthesis "
        f"included) [{CARD}]")
    check(row["train_acc"] > MNIST_MIN_ACC,
          f"mnist train accuracy {row['train_acc']} <= {MNIST_MIN_ACC}")
    return {k: row[k] for k in ("train_loss", "train_acc", "test_acc")} | {
        "process_s": wall}


def offline_trace(dev, dens) -> dict:
    """The offline path tracer (phase 15) on the stand-in cloud's corner
    table at 800x800 with OfflinePTConfig's defaults (32 bounces, 16
    transmittance steps, 12 shadow samples) from config 4's camera: one
    trace, its image finite with max > 0 and its export angles in range;
    then at 32x32 the card against the CPU port on the same uniforms,
    every lane within 1e-4 + 1e-3 |ref|."""
    from neuralradiancecaching_tpu_torch.ops import volume
    from neuralradiancecaching_tpu_torch.render import offline_pathtracer as opt
    from neuralradiancecaching_tpu_torch.scene import camera
    c4 = preset_config("config4")
    ocfg = opt.OfflinePTConfig()
    field = volume.build_corner_table(torch.as_tensor(dens, device=dev))
    ro, rd = camera.pixel_rays(camera.make_camera(c4.camera, dev),
                               PRESET_SIDE, PRESET_SIDE)
    gen = torch.Generator(device=dev).manual_seed(15)
    u = opt.draw_offline_uniforms(gen, ocfg, ro.shape[0])
    res = opt.trace(field, c4.volume, ocfg, OFFLINE_SUN, 1.0, ro, rd, u)
    d = res.export_dir
    check(bool(torch.isfinite(res.color).all())
          and float(res.color.max()) > 0.0, "offline trace not finite or "
          "black")
    check(float(d[:, 0].min()) >= -np.pi - 1e-5
          and float(d[:, 0].max()) <= np.pi + 1e-5
          and float(d[:, 1].min()) >= -1e-5
          and float(d[:, 1].max()) <= np.pi + 1e-5,
          "offline export angles out of range")
    out = {"mean_color": float(res.color.mean()),
           "max_color": float(res.color.max())}
    log(f"offline trace {PRESET_SIDE}x{PRESET_SIDE} ({ocfg.max_bounces} "
        f"bounces, {ocfg.transmittance_steps} transmittance steps, "
        f"{ocfg.shadow_samples} shadow samples): mean color "
        f"{out['mean_color']:.5f}, max {out['max_color']:.5f}")
    del res

    # the card vs the CPU port at 32x32 on the same uniforms
    ro_s, rd_s = camera.pixel_rays(camera.make_camera(c4.camera, "cpu"), 32,
                                   32)
    u_s = opt.draw_offline_uniforms(torch.Generator().manual_seed(16), ocfg,
                                    32 * 32)
    field_c = volume.build_corner_table(torch.as_tensor(dens))
    ref = opt.trace(field_c, c4.volume, ocfg, OFFLINE_SUN, 1.0, ro_s, rd_s,
                    u_s)
    got = opt.trace(field, c4.volume, ocfg, OFFLINE_SUN, 1.0, ro_s.to(dev),
                    rd_s.to(dev), u_s.to(dev))
    for name in ("color", "export_pos", "export_dir"):
        g = getattr(got, name).cpu().numpy()
        r = getattr(ref, name).numpy()
        ok = np.all(np.abs(g - r) <= 1e-4 + 1e-3 * np.abs(r), axis=-1)
        log(f"card vs CPU port, offline trace 32x32 {name}: {ok.mean():.4f} "
            f"of lanes within 1e-4 + 1e-3|ref|, max abs diff "
            f"{float(np.abs(g - r).max()):.3e}")
        check(bool(np.isfinite(g).all()) and bool(ok.all()),
              f"the card's offline trace ({name}) disagrees with the CPU "
              f"port")
    return out


def same_frame(label: str, ref, out, lr: float) -> dict:
    """The data-parallel frame against the single-device one on the same
    draws (one card: only the atomic sums' order differs): mse within
    DP_MSE_REL, MLP parameters within SMALL_PARAM_TOL, hash entries >=
    SMALL_HASH_FRAC within it and all within 2 lr, the image at the render
    bound. ref/out: (state, image, mse)."""
    (st_r, img_r, mse_r), (st_o, img_o, mse_o) = ref, out
    mse_rel = abs(float(mse_o) - float(mse_r)) / abs(float(mse_r))
    p_err = max(float((st_o.mlp_params[k] - st_r.mlp_params[k]).abs().max())
                for k in st_r.mlp_params)
    h_diff = (st_o.hash_table - st_r.hash_table).abs()
    h_frac = float((h_diff <= SMALL_PARAM_TOL).float().mean())
    got, ref_img = img_o.float().cpu().numpy(), img_r.float().cpu().numpy()
    ok = np.all(np.abs(got - ref_img) <= 1e-4 + 1e-3 * np.abs(ref_img),
                axis=-1)
    rel = abs(got.mean() - ref_img.mean()) / abs(ref_img.mean())
    res = {"pixels_ok": float(ok.mean()), "mean_rel": float(rel),
           "max_abs": float(np.abs(got - ref_img).max()),
           "mse_rel": mse_rel, "mlp_max_abs": p_err, "hash_frac": h_frac,
           "hash_max_abs": float(h_diff.max())}
    log(f"{label}, data parallel vs single device on the same draws: "
        + json.dumps(res))
    check(bool(np.isfinite(got).all()) and ok.mean() >= SMALL_FRAC_OK
          and rel <= SMALL_REL_MEAN, f"{label}: the DP image disagrees")
    check(mse_rel <= DP_MSE_REL and p_err <= SMALL_PARAM_TOL,
          f"{label}: the DP train step disagrees")
    check(h_frac >= SMALL_HASH_FRAC and float(h_diff.max()) <= 2 * lr
          * 1.0001, f"{label}: the DP hash-table step disagrees")
    return res


def dp_same_frame(dev, label: str, draw, single, data_parallel, counter: str,
                  lr: float) -> int:
    """A data-parallel path at world size 1 beside its single-device path
    (phases 16a-b) on one set of draws, held equal by :func:`same_frame`;
    the DP frame runs under the tracer, so its K1 launches (the count
    ``counter``) and its collectives (the ``dp.all_reduce`` and
    ``dp.all_gather`` spans) are read from it. Returns the launches."""
    d = draw()
    ref = single(d)
    out, n = traced(dev, lambda: data_parallel(d))
    eq = same_frame(label, ref, out, lr)
    launches = n[counter]
    spans = sorted(k[5:] for k in n if k.startswith("span dp."))
    log(f"{label}: K1 {counter} {launches} in the DP frame, collectives "
        f"{spans}")
    check(launches >= 1, f"{label}: K1 did not launch in the DP frame")
    check("dp.all_reduce" in spans and "dp.all_gather" in spans,
          f"{label}: no collective ran")
    DP_LOG[label] = {"equality": eq, "k1_launches": launches,
                     "collectives": spans}
    return launches


def dp_progressive(dev, scene, cfg, state, env_rgb, pack, probes) -> int:
    """Config 5's production frame at 1920x1080 through
    ``dp_train_banded_frame`` at world size 1 with NCCL (phase 16a: the
    packed DP render, K1 bf16) beside ``train_only_step`` -> ``bake`` ->
    ``render_banded`` on the same draws; then ``probe_dp_caps`` at world
    size 1 over the same pack against phase 8c's single-device probes
    (phase 16c). Returns the DP frame's K1 bf16 launches."""
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.parallel import data_parallel as dp
    from neuralradiancecaching_tpu_torch.parallel import make_mesh
    from neuralradiancecaching_tpu_torch.render import (frame, pathtrace,
                                                        targets, tiled)
    mesh = make_mesh(1)
    check(mesh.backend == "nccl" and mesh.device == dev,
          f"mesh {mesh.backend} on {mesh.device}")
    n_bands_p, band_n = pack.ro_p.shape[:2]
    gen = torch.Generator(device=dev).manual_seed(300)

    def draw():
        return (targets.draw_train_uniforms(cfg, gen, dev),
                [pathtrace.draw_path_uniforms(cfg, band_n, True, gen, dev)
                 for _ in range(n_bands_p)])

    def single(d):
        st, mse = frame.train_only_step(state, scene, None, cfg,
                                        train_uniforms=d[0])
        img = tiled.render_banded(st, scene, None, cfg, BAND_ROWS,
                                  env_rgb=env_rgb, baked=nrc.bake(st, cfg),
                                  pack=pack, uniforms=d[1])
        return st, img, mse

    def data_parallel(d):
        st, img, mse, _ = dp.dp_train_banded_frame(
            state, scene, None, cfg, mesh, BAND_ROWS, env_rgb=env_rgb,
            pack=pack, jitter=d[0].jitter, train_uniforms=[d[0]],
            uniforms=d[1])
        return st, img, mse

    launches = dp_same_frame(dev, f"config 5 dp_train_banded_frame "
                             f"{P_WIDTH}x{P_HEIGHT}", draw, single,
                             data_parallel, "k1_bf16_launches",
                             cfg.mrhe.learning_rate)

    # -- 16c. the per-shard cap probe at world size 1 -----------------------
    cfg_t, rep = dp.probe_dp_caps(scene, cfg, 1, band_rows=BAND_ROWS,
                                  pack=pack)
    probe = {"query_frac": rep.query_frac.tolist(),
             "event_mean": rep.event_mean.tolist(),
             "live_frac": rep.live_frac.tolist(),
             "query_cap": rep.query_cap, "shade_cap": rep.shade_cap,
             "phase_8c": probes}
    log(f"probe_dp_caps at world size 1 over the pack: {json.dumps(probe)}")
    # one shard is the frame: the exact live fraction is phase 8c's, the
    # sampled query and event means match its own (other draws) within
    # their spread, and the DP shade cap also covers slot 0
    qfrac, ev_mean = probes["query_fraction"], probes["event_mean"]
    check(abs(rep.live_frac[0] - probes["live_fraction"]) <= 1e-6,
          "probe_dp_caps' live fraction differs from the frame's")
    check(abs(rep.query_frac[0] - qfrac) <= 0.05 * qfrac + 0.005
          and abs(rep.event_mean[0] - ev_mean) <= 0.05 * ev_mean + 0.005,
          "probe_dp_caps' fractions stray from phase 8c's probes")
    check(cfg_t.render.shade_cap_fraction >= probes["shade_cap_fraction"],
          "probe_dp_caps' shade cap is below the single-device one")
    DP_LOG["probe_dp_caps 1080p"] = probe
    return launches


def dp_preset(dev, scene, state, c4) -> int:
    """Config 4 as it ships at 800x800 through ``dp_frame_step`` at world
    size 1 with NCCL (phase 16b: the reference sampler's train batch and
    the cached render, K1 f32) beside ``frame_step`` on the same draws.
    Returns the DP frame's K1 f32 launches."""
    from neuralradiancecaching_tpu_torch.parallel import data_parallel as dp
    from neuralradiancecaching_tpu_torch.parallel import make_mesh
    from neuralradiancecaching_tpu_torch.render import (frame, pathtrace,
                                                        targets)
    mesh = make_mesh(1)
    gen = torch.Generator(device=dev).manual_seed(400)
    n_pix = PRESET_SIDE * PRESET_SIDE

    def draw():
        return (targets.draw_train_uniforms(c4, gen, dev),
                pathtrace.draw_path_uniforms(c4, n_pix, True, gen, dev))

    def single(d):
        st, out = frame.frame_step(state, scene, None, c4,
                                   train_uniforms=d[0], uniforms=d[1])
        return st, out.image, out.mse

    def data_parallel(d):
        return dp.dp_frame_step(state, scene, None, c4, mesh,
                                jitter=d[0].jitter, train_uniforms=[d[0]],
                                uniforms=[d[1]])

    return dp_same_frame(dev, f"config 4 dp_frame_step {PRESET_SIDE}x"
                         f"{PRESET_SIDE}", draw, single, data_parallel,
                         "k1_f32_launches", c4.mrhe.learning_rate)


def dp_two_ranks(dev) -> None:
    """Two gloo ranks on the one card (phase 16d; NCCL refuses two ranks on
    one device), each its own process of ``parallel/job.py``: config 5's
    small cut (64x60 in 6-row bands, so the height divides into 2 ranks x
    6 rows; caps off, so no cap binds at either world size) through
    ``dp_train_banded_frame``, ``dp_render_banded_packed`` and
    ``dp_render_banded``, and config 4's through ``dp_frame_step``. Every
    output bitwise equal on both ranks; the two renders from the global
    per-band draws equal to world size 1's (NCCL, this process) at the
    render bound."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.parallel import data_parallel as dp
    from neuralradiancecaching_tpu_torch.parallel import make_mesh, spawn
    from neuralradiancecaching_tpu_torch.render import pathtrace, tiled
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    r = dataclasses.replace
    w, h, band = 64, 60, DP_SMALL_BAND
    c5 = progressive_config(w, h, small=True)
    c5 = r(c5, render=r(c5.render, query_cap_fraction=1.0,
                        shade_cap_fraction=float(c5.path.max_bounces),
                        live_pack_fraction=0.75))
    c4 = preset_config("config4", small=True)
    rng = np.random.default_rng(0)
    dens = rng.random(c5.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)

    def state_np(cfg, seed):
        st = nrc.init_state(torch.Generator().manual_seed(seed), cfg,
                            device="cpu")
        st = dataclasses.replace(st, mlp_params=he_params(
            cfg.mlp, torch.Generator().manual_seed(seed + 1), "cpu"))
        return {f.name: to_numpy(getattr(st, f.name))
                for f in dataclasses.fields(st)}

    st5, st4 = state_np(c5, 2), state_np(c4, 4)
    scene5 = scn.make_scene(c5, dens, env, device=dev)
    pack = tiled.frame_live_pack(scene5, c5, band, multiple_of=2)
    n_p, band_n = pack.ro_p.shape[:2]
    g = torch.Generator().manual_seed(7)
    pu = [pathtrace.draw_path_uniforms(c5, band_n, True, g)
          for _ in range(n_p)]
    bu = [pathtrace.draw_path_uniforms(c5, band * w, True, g)
          for _ in range(h // band)]
    pack_cpu = to_device(pack, "cpu")
    steps = [dict(name="c5_train_frame", fn="dp_train_banded_frame", cfg=c5,
                  state=st5, seed=11,
                  kwargs=dict(band_rows=band, pack=pack_cpu)),
             dict(name="c4_frame", fn="dp_frame_step", cfg=c4, state=st4,
                  seed=12),
             dict(name="c5_packed", fn="dp_render_banded_packed", cfg=c5,
                  state=st5, kwargs=dict(band_rows=band, pack=pack_cpu,
                                         uniforms=pu)),
             dict(name="c5_banded", fn="dp_render_banded", cfg=c5, state=st5,
                  kwargs=dict(band_rows=band, uniforms=bu))]
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        torch.save(dict(density=dens, env=env, steps=steps), d / "job.pt")
        sync()
        t0 = time.perf_counter()
        spawn(["-m", "neuralradiancecaching_tpu_torch.parallel.job",
               str(d / "job.pt"), str(d), "--device", str(dev), "--backend",
               "gloo"], 2, d / "group", env={"PYTHONPATH": str(REPO)},
              timeout=DP_RANKS_TIMEOUT)
        wall = time.perf_counter() - t0
        r0, r1 = (torch.load(d / f"rank{k}.pt", weights_only=False)
                  for k in range(2))
    finally:
        for f in sorted(d.rglob("*"), reverse=True):
            f.unlink() if f.is_file() else f.rmdir()
        d.rmdir()
    for name in r0:
        a, b = flat_tensors(r0[name]), flat_tensors(r1[name])
        check(len(a) == len(b) and all(torch.equal(x, y)
                                       for x, y in zip(a, b)),
              f"two ranks: {name} differs between the ranks")
    for name, out in (("c4_frame", r0["c4_frame"][1]),
                      ("c5_train_frame", r0["c5_train_frame"][1])):
        check(bool(torch.isfinite(out).all()) and float(out.mean()) > 0.0,
              f"two ranks: {name} image not finite")
    mesh = make_mesh(1)
    st = nrc.state_from_numpy(st5, dev)
    ref = {"c5_packed": dp.dp_render_banded_packed(
               st, scene5, None, c5, mesh, band, pack=pack,
               uniforms=to_device(pu, dev)),
           "c5_banded": dp.dp_render_banded(
               st, scene5, None, c5, mesh, band,
               uniforms=to_device(bu, dev))}
    res = {"process_s": wall}
    for name, img in ref.items():
        got, want = r0[name].numpy(), img.cpu().numpy()
        ok = np.all(np.abs(got - want) <= 1e-4 + 1e-3 * np.abs(want),
                    axis=-1)
        rel = abs(got.mean() - want.mean()) / abs(want.mean())
        res[name] = {"pixels_ok": float(ok.mean()), "mean_rel": float(rel),
                     "max_abs": float(np.abs(got - want).max())}
        check(ok.mean() >= SMALL_FRAC_OK and rel <= SMALL_REL_MEAN,
              f"two ranks: {name} differs from world size 1's")
    log(f"two gloo ranks on one card ({w}x{h} config 5 in {band}-row "
        f"bands, 32x32 config 4): every output bitwise equal on both "
        f"ranks; the renders vs world size 1: {json.dumps(res)} [{CARD}]")
    DP_LOG["two ranks"] = res


def to_numpy(x):
    """A tensor, a dict of them or None as numpy."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return None if x is None else x.cpu().numpy()


def flat_tensors(x) -> list:
    """The tensors of a job output (tuples, dicts) in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in flat_tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat_tensors(v)]
    return []


def walk_branches_small_vs_cpu(dev) -> None:
    """The card vs the CPU port on the walks' branches no preset sets (phase
    16f), the same draws (drawn on the CPU): the NN-mode march split of the
    collision and delta walks and the reference march's entry kill through
    ``trace_path`` at WALK_SIDE^2 (their packs act above 1024 lanes; per
    lane at the render bound, >= 99% of lanes), the dense per-slot shade of
    both and the premultiplied env mode through ``render_only_step`` at
    32x32 (per pixel and the mean)."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn
    r = dataclasses.replace
    base = slice_config(32, 32, small=True)
    branches = (
        ("nn_split_collision", "walk", {"path": {"coll_phase1_steps": 2}}),
        ("nn_split_delta", "walk", {"path": {"sampler": "delta",
                                             "coll_phase1_steps": 2}}),
        ("dense_collision", "render", {"path": {"coll_shade_cap": 0.0}}),
        ("dense_delta", "render", {"path": {"sampler": "delta",
                                            "coll_shade_cap": 0.0}}),
        ("entry_kill", "walk", {"path": {"sampler": "reference",
                                         "march_entry_fraction": 0.25}}),
        ("premultiplied", "render", {"env_map": {
            "in_scatter_mode": "mc", "transmittance_mode": "premultiplied"}}))
    rng = np.random.default_rng(0)
    dens = rng.random(base.volume.grid_shape, dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    state = nrc.init_state(torch.Generator().manual_seed(2), base,
                           device="cpu")
    state = dataclasses.replace(state, mlp_params=he_params(
        base.mlp, torch.Generator().manual_seed(3), "cpu"))
    res = {}
    for name, kind, change in branches:
        cfg = base
        for section, kw in change.items():
            cfg = r(cfg, **{section: r(getattr(cfg, section), **kw)})
        g = torch.Generator().manual_seed(13)
        side = WALK_SIDE if kind == "walk" else 32
        u = pathtrace.draw_path_uniforms(cfg, side * side, True, g)
        outs = []
        for d in ("cpu", dev):
            sc = scn.make_scene(cfg, dens, env, device=d)
            if kind == "render":
                outs.append(frame.render_only_step(
                    state_to(state, d), sc, None, cfg,
                    uniforms=to_device(u, d)).cpu().numpy().reshape(-1, 3))
            else:
                ro, rd = camera.pixel_rays(sc.camera, side, side)
                p = pathtrace.trace_path(sc, cfg, ro, rd, None, use_nn=True,
                                         uniforms=to_device(u, d))
                outs.append(np.concatenate(
                    [t.cpu().numpy().reshape(side * side, -1) for t in p],
                    axis=1))
        sync()
        ref, got = outs
        ok = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
        rel = abs(got.mean() - ref.mean()) / abs(ref.mean())
        res[name] = {"ok": float(ok.mean()), "mean_rel": float(rel)}
        check(bool(np.isfinite(got).all()) and ok.mean()
              >= (0.99 if kind == "walk" else SMALL_FRAC_OK)
              and (kind == "walk" or rel <= SMALL_REL_MEAN),
              f"the card's {name} branch disagrees with the CPU port")
    log("card vs CPU port, the walks' new branches: " + json.dumps(res))


def dp_cli_runs() -> dict:
    """The CLI's data-parallel frames as a user runs them (phase 16e), each
    in its own process at its default size: ``torchrun --standalone
    --nproc-per-node 1 -m neuralradiancecaching_tpu_torch.cli progressive
    --mesh auto --frames 4`` (NCCL, the per-shard cap probe, the packed DP
    frame) and ``python -m neuralradiancecaching_tpu_torch.cli nrc-online
    --mesh 1 --frames 4`` (a group of one, the striped banded DP frame).
    Each must exit 0 with a finite image and a metrics row per frame."""
    root = REPO / "out" / "chip_smoke_cli"
    out = {
        "progressive_mesh": run_cli(
            "progressive_mesh", "progressive",
            ["torchrun", "--standalone", "--nproc-per-node", "1",
             *CLI_MODULE, "progressive", "--mesh", "auto", "--frames",
             str(N_FRAMES), "--sync-every", "1"], root),
        "nrc_online_mesh": run_cli(
            "nrc_online_mesh", "nrc_online",
            [sys.executable, *CLI_MODULE, "nrc-online", "--mesh", "1",
             "--frames", str(N_FRAMES)], root)}
    check(all(len(run["frame_ms"]) == N_FRAMES for run in out.values()),
          "a DP CLI run logged another number of frames")
    check("probe-caps: query_cap=" in out["progressive_mesh"]["stdout"],
          "the DP progressive run did not probe its caps")
    DP_LOG["cli"] = {k: {f: v for f, v in run.items() if f != "stdout"}
                     for k, run in out.items()}
    return out


def to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 -> (H, W, 4) uint8 RGBE (Radiance's float2rgbe:
    mantissas scaled to the largest channel's power of two)."""
    m = rgb.max(axis=-1)
    mant, e = np.frexp(m)
    lit = m > 1e-32
    scale = np.where(lit, mant * 256.0 / np.where(lit, m, 1.0), 0.0)
    rgbe = np.empty(rgb.shape[:2] + (4,), np.uint8)
    rgbe[..., :3] = (rgb * scale[..., None]).astype(np.uint8)
    rgbe[..., 3] = np.where(lit, e + 128, 0)
    return rgbe


def rle_encode(rgbe: np.ndarray) -> tuple[bytes, int, int]:
    """New-style RLE scanlines of (H, W, 4) RGBE: per channel, stretches of
    3 or more equal bytes as runs (<= 127 per packet), the bytes between
    them as literals (<= 128 per packet). Returns (payload, runs,
    literals)."""
    h, w, _ = rgbe.shape
    head = bytes([2, 2, w >> 8, w & 0xFF])
    out, runs, literals = [], 0, 0
    for y in range(h):
        out.append(head)
        for c in range(4):
            v = rgbe[y, :, c]
            starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
            lens = np.diff(np.r_[starts, w])
            long = lens >= 3
            run_a, run_b = starts[long], starts[long] + lens[long]
            # the literal before each run and after the last
            lit_a, lit_b = np.r_[0, run_b], np.r_[run_a, w]
            for i in range(len(lit_a)):
                for a in range(int(lit_a[i]), int(lit_b[i]), 128):
                    b = min(a + 128, int(lit_b[i]))
                    out.append(bytes([b - a]) + v[a:b].tobytes())
                    literals += 1
                if i < len(run_a):
                    for a in range(int(run_a[i]), int(run_b[i]), 127):
                        n = min(127, int(run_b[i]) - a)
                        out.append(bytes([128 + n, int(v[a])]))
                        runs += 1
    return b"".join(out), runs, literals


def host_library() -> dict:
    """The port's host library (phase 19): ``csrc/nrcio.cpp`` built with this
    machine's host C++ compiler, a HDR_SHAPE RLE ``.hdr`` written from
    ``assets.synthesize_sky`` (runs and literals), decoded through
    ``native.hdr_decode`` (and ``assets.read_hdr``) and through the plain
    decode: bit for bit equal, and within RGBE's precision (1/128 of the
    pixel's largest channel) of the sky. The times are host times."""
    from neuralradiancecaching_tpu_torch import kernels
    from neuralradiancecaching_tpu_torch.io import assets, native
    kernels.build("nrcio")
    build_s = kernels.BUILD_SECONDS["nrcio"]
    check(native.available(), "nrcio is not built")
    h, w = HDR_SHAPE
    sky = assets.synthesize_sky(h, w)
    t0 = time.perf_counter()
    payload, runs, literals = rle_encode(to_rgbe(sky))
    encode_s = time.perf_counter() - t0
    check(runs > 0 and literals > 0, f"the sky's RLE has {runs} runs and "
          f"{literals} literals")
    native_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = native.hdr_decode(payload, w, h)
        native_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = assets.hdr_decode_plain(payload, w, h)
    plain_s = time.perf_counter() - t0
    check(got.shape == (h, w, 3) and bool(np.isfinite(got).all()),
          "the native decode is not finite")
    check(np.array_equal(got.view(np.uint32), plain.view(np.uint32)),
          "the native decode differs from the plain decode")
    check(bool((np.abs(got - sky) <= sky.max(axis=-1, keepdims=True) / 128
                ).all()), "the decoded sky strays from the sky")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sky.hdr")
        with open(path, "wb") as f:
            f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                    + f"-Y {h} +X {w}\n".encode() + payload)
        check(np.array_equal(assets.read_hdr(path).view(np.uint32),
                             got.view(np.uint32)),
              "assets.read_hdr differs from native.hdr_decode")
    res = {"build_s": build_s, "native_decode_s": statistics.median(
        native_s), "plain_decode_s": plain_s, "encode_s": encode_s,
        "width": w, "height": h, "payload_bytes": len(payload),
        "runs": runs, "literals": literals}
    log(f"host library nrcio, host times on the card's machine [{CARD}]: "
        f"c++ build {build_s:.3f} s; {w}x{h} RLE .hdr ({len(payload)} bytes, "
        f"{runs} runs, {literals} literals): native decode "
        f"{res['native_decode_s']:.4f} s (median of {len(native_s)}), plain "
        f"decode {plain_s:.4f} s, bitwise equal")
    return res


def exact_config(small: bool = False, lights: bool = False,
                 fused: bool = False):
    """``reference_exact()`` at PRESET_SIDE as it ships (no light on, the
    plain query MLP); ``small`` cuts it to the tests' scale
    (tests/test_torch_exact.py), ``lights`` turns the dir and point
    lights on (tests/test_torch_oracle.py:with_lights), ``fused`` puts K1
    f32 on its cache query."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    r = dataclasses.replace
    side = 32 if small else PRESET_SIDE
    cfg = cfg_mod.reference_exact(side, side)
    if small:
        cfg = small_cut(cfg)
    if lights:
        cfg = r(cfg, dir_light=r(cfg.dir_light, enabled=True, strength=2.0,
                                 zenith=-1.0, azimuth=0.5),
                point_light=r(cfg.point_light, enabled=True, strength=3.0,
                              position=(5.0, 3.0, -2.0),
                              color=(1.0, 0.5, 0.25)))
    if fused:
        cfg = r(cfg, mlp=r(cfg.mlp, fused_inference=True))
    return cfg


def pixel_agreement(got: np.ndarray, ref: np.ndarray):
    """(share of pixels within 1e-4 + 1e-3 |ref|, relative difference of
    the means, max abs difference) of two (..., 3) images."""
    got, ref = got.reshape(-1, 3), ref.reshape(-1, 3)
    ok = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    return (float(ok.mean()), abs(got.mean() - ref.mean()) / abs(ref.mean()),
            float(np.abs(got - ref).max()))


def reference_exact_frames(dev, dens, env) -> int:
    """``reference_exact()`` as it ships at 800x800 (phase 17a): 2
    frame_steps under the tracer (no K1, the quadrature kernel launched),
    32 train_only_steps (their mse logged, not gated: the reference's
    momentum SGD learns more slowly than Adam), then one frame with
    ``fused_inference`` on the same state and draws as one more frame as it
    ships: K1 f32 launches once there and its image stays within the render
    bound of the plain MLP's. Returns K1's launches in that frame."""
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import (frame, pathtrace,
                                                        targets)
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    cfg = exact_config()
    check(cfg.path.sampler == "reference" and all(
        dataclasses.astuple(cfg.quirks)) and not cfg.mlp.fused_inference,
        "reference_exact no longer ships as this phase expects")
    scene = scn.make_scene(cfg, dens, env, device=dev)
    levels = scene.density_grid * 255.0
    check(float((levels - torch.round(levels)).abs().max()) < 1e-4,
          "the reference_exact scene is not quantized to 8 bits")
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    check(state.mlp_second is None and state.opt_step is None,
          "reference_exact's state carries Adam fields")
    gen = torch.Generator(device=dev).manual_seed(17)

    def frames():
        nonlocal state
        outs = []
        for _ in range(2):
            state, out = frame.frame_step(state, scene, gen, cfg)
            outs.append((float(out.mse), out.image))
        return outs

    outs, n = traced(dev, frames)
    mses = [m for m, _ in outs]
    means = [float(img.mean()) for _, img in outs]
    check(all(tuple(img.shape) == (PRESET_SIDE, PRESET_SIDE, 3)
              and bool(torch.isfinite(img).all()) for _, img in outs)
          and all(np.isfinite(mses)), "reference_exact frame not finite")
    del outs
    check(n["span k1"] == 0, "reference_exact as it ships launched K1")
    k3 = n["k3_launches"] / len(mses)
    K3_BY_PATH["reference_exact frame"] = k3
    check(k3 > 0, "reference_exact's frames did not launch the quadrature "
          "kernel")
    log(f"reference_exact frame_step {PRESET_SIDE}x{PRESET_SIDE}: mse "
        f"{[round(m, 6) for m in mses]}; image means "
        f"{[round(m, 5) for m in means]}; K1 launches "
        f"{n['k1_f32_launches'] + n['k1_bf16_launches']}, K2 "
        f"{n['k2_launches']}, quadrature kernel {k3:g} a frame")

    steps = []
    for _ in range(TRAIN_STEPS):
        state, mse = frame.train_only_step(state, scene, gen, cfg)
        steps.append(mse)
    steps = [float(m) for m in steps]
    check(bool(np.isfinite(steps).all()), "reference_exact mse not finite")
    log(f"reference_exact: {TRAIN_STEPS} train_only_steps, mse "
        f"{[round(m, 6) for m in steps]} (logged, not gated), "
        f"mean of the first 8 {np.mean(steps[:8]):.6f}, of the last 8 "
        f"{np.mean(steps[-8:]):.6f}")

    # the same frame with K1 f32 on the query: one set of draws, one state
    u_t = targets.draw_train_uniforms(cfg, gen, dev)
    u_r = pathtrace.draw_path_uniforms(cfg, PRESET_SIDE ** 2, True, gen,
                                       device=dev)
    (_, plain), n = traced(dev, lambda: frame.frame_step(
        state, scene, None, cfg, train_uniforms=u_t, uniforms=u_r))
    check(n["span k1"] == 0, "the plain-MLP frame launched K1")
    fused_cfg = exact_config(fused=True)
    (_, fused), n = traced(dev, lambda: frame.frame_step(
        state, scene, None, fused_cfg, train_uniforms=u_t, uniforms=u_r))
    launches = n["k1_f32_launches"]
    check(launches == 1 and n["k1_bf16_launches"] == 0,
          f"K1 f32 launched {launches} times in the fused reference_exact "
          f"frame")
    frac, rel, diff = pixel_agreement(fused.image.cpu().numpy(),
                                      plain.image.cpu().numpy())
    log(f"reference_exact with fused_inference: K1 f32 launches {launches}; "
        f"against the plain MLP's frame on the same state and draws: "
        f"{frac:.4f} of pixels within 1e-4 + 1e-3|ref|, mean rel diff "
        f"{rel:.3e}, max abs diff {diff:.3e}; mse {float(fused.mse):.6f} vs "
        f"{float(plain.mse):.6f}")
    mse_rel = abs(float(fused.mse) - float(plain.mse)) / float(plain.mse)
    check(frac >= SMALL_FRAC_OK and rel <= SMALL_REL_MEAN
          and mse_rel <= 1e-6,
          "the fused reference_exact frame disagrees with the plain one")
    return launches


def exact_small_vs_cpu(dev) -> None:
    """The card vs the CPU port at 32x32 (phase 17b): one reference_exact
    frame_step from one state and one set of draws (drawn on the CPU), as
    it ships and with the lights on, at the train tests' bounds (every
    hash entry within 1e-6: plain SGD has no eps to amplify a rounding)."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import (frame, pathtrace,
                                                        targets)
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    rng = np.random.default_rng(0)
    dens = rng.random((16, 12, 20), dtype=np.float32) * 0.5
    env = assets.synthesize_sky(32, 64)
    for lights in (False, True):
        cfg = exact_config(small=True, lights=lights)
        cpu_gen = torch.Generator().manual_seed(12)
        u_t = targets.draw_train_uniforms(cfg, cpu_gen, "cpu")
        u_r = pathtrace.draw_path_uniforms(cfg, 32 * 32, True, cpu_gen)
        state = nrc.init_state(torch.Generator().manual_seed(2), cfg,
                               device="cpu")
        out = []
        for d in ("cpu", dev):
            sc = scn.make_scene(cfg, dens, env, device=d)
            st, o = frame.frame_step(state_to(state, d), sc, None, cfg,
                                     train_uniforms=to_device(u_t, d),
                                     uniforms=to_device(u_r, d))
            out.append((state_to(st, "cpu"), o.image.cpu().numpy(),
                        float(o.mse)))
        sync()
        (st_c, img_c, mse_c), (st_g, img_g, mse_g) = out
        frac, rel, diff = pixel_agreement(img_g, img_c)
        mse_rel = abs(mse_g - mse_c) / abs(mse_c)
        p_err = max(float(((getattr(st_g, t)[k] - getattr(st_c, t)[k]).abs()
                           - 1e-5 * getattr(st_c, t)[k].abs()).max())
                    for t in ("mlp_params", "mlp_momentum")
                    for k in st_c.mlp_params)
        h_diff = float((st_g.hash_table - st_c.hash_table).abs().max())
        label = "lights on" if lights else "as it ships"
        log(f"card vs CPU port, reference_exact frame_step 32x32 ({label}): "
            f"{frac:.4f} of pixels within 1e-4 + 1e-3|ref|, mean rel diff "
            f"{rel:.3e}, max abs diff {diff:.3e}; mse {mse_g:.6f} vs "
            f"{mse_c:.6f} (rel {mse_rel:.3e}); MLP parameters and momentum "
            f"max (|diff| - 1e-5|ref|) {p_err:.3e}; hash max abs diff "
            f"{h_diff:.3e}")
        check(frac >= SMALL_FRAC_OK and rel <= SMALL_REL_MEAN,
              f"the card's reference_exact frame ({label}) disagrees")
        check(mse_rel <= SMALL_MSE_REL and p_err <= SMALL_PARAM_TOL
              and h_diff <= SMALL_PARAM_TOL,
              f"the card's reference_exact train step ({label}) disagrees")


def slice_checks(dev, dens) -> None:
    """The slice's small pieces on the card (phase 17c): the raw-grid
    trilinear fetch against the corner table (bitwise) and the CPU port,
    render_tiled against render_banded at 32x32 with the cache off and on,
    a trace from utils.profiling under out/, and utils.debug.nan_check."""
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.ops import volume
    from neuralradiancecaching_tpu_torch.render import tiled
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    from neuralradiancecaching_tpu_torch.utils import debug, profiling
    grid = torch.as_tensor(dens, device=dev)
    uvw = torch.rand((1 << 20, 3), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev) * 1.4 - 0.2
    raw = volume.sample_grid_trilinear(grid, uvw)
    table = volume.sample_corner_trilinear(volume.build_corner_table(grid),
                                           uvw, grid.shape)
    cpu = volume.sample_grid_trilinear(grid.cpu(), uvw.cpu())
    cpu_err = float(((raw.cpu() - cpu).abs() - 1e-5 * cpu.abs()).max())
    log(f"sample_grid_trilinear on the card, {uvw.shape[0]} samples of the "
        f"{tuple(grid.shape)} cloud: bitwise equal to the corner table "
        f"{bool(torch.equal(raw, table))}; against the CPU port max "
        f"(|diff| - 1e-5|ref|) {cpu_err:.3e}")
    check(torch.equal(raw, table), "the raw-grid fetch differs from the "
          "corner table's on the card")
    check(cpu_err <= 1e-6, "the card's raw-grid fetch disagrees with the CPU")

    band = 8
    rng = np.random.default_rng(0)
    s_dens = rng.random((16, 12, 20), dtype=np.float32) * 0.5
    s_env = assets.synthesize_sky(32, 64)
    for use_nn in (False, True):
        cfg = exact_config(small=True, lights=True)
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, use_nn=use_nn))
        sc = scn.make_scene(cfg, s_dens, s_env, device=dev)
        state = nrc.init_state(torch.Generator(device=dev).manual_seed(1),
                               cfg, device=dev)
        u = to_device(draw_band_uniforms(cfg, 32 // band, 32 * band,
                                         torch.Generator().manual_seed(6)),
                      dev)
        a = tiled.render_tiled(state, sc, None, cfg, band, uniforms=u)
        b = tiled.render_banded(state, sc, None, cfg, band, uniforms=u)
        sync()
        frac, rel, diff = pixel_agreement(a.cpu().numpy(), b.cpu().numpy())
        log(f"render_tiled vs render_banded 32x32 in {band}-row bands "
            f"(reference_exact, cache {'on' if use_nn else 'off'}): bitwise "
            f"{bool(torch.equal(a, b))}, {frac:.4f} of pixels within the "
            f"bound, max abs diff {diff:.3e}")
        check(bool(torch.isfinite(a).all()) and frac >= SMALL_FRAC_OK
              and rel <= SMALL_REL_MEAN,
              "render_tiled disagrees with render_banded on the card")

    out_dir = REPO / "out" / "chip_smoke_trace"
    with profiling.trace(str(out_dir)) as prof:
        volume.sample_grid_trilinear(grid, uvw[:4096])
        sync()
    files = sorted(out_dir.glob("*.pt.trace.json"))
    kernels_ = sum(1 for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    log(f"utils.profiling.trace: {[f.name for f in files]} "
        f"{[f.stat().st_size for f in files]} bytes, {kernels_} device "
        f"kernels in its table")
    check(len(files) >= 1 and files[-1].stat().st_size > 0,
          "utils.profiling.trace wrote no trace")

    x = torch.tensor([0.0, 1.0], device=dev)
    _ = x / 0.0  # outside the context: no check
    raised = False
    try:
        with debug.nan_check():
            _ = x * 2.0
            _ = x / 0.0
    except FloatingPointError as e:
        raised = True
        log(f"utils.debug.nan_check on the card raised: {e}")
    check(raised, "nan_check let a NaN through on the card")


def device_kernels(fn, notes=()) -> collections.Counter:
    """The kernels ``fn()`` runs on the card, by name, from one
    ``torch.profiler`` window that idles PROFILE_PAD seconds before and
    after ``fn`` (from a synchronize to a synchronize): device events that
    are no copy, memset or annotation (``notes``: the span names, which
    the device's annotations carry)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD)
        fn()
        sync()
        time.sleep(PROFILE_PAD)
    n = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and name not in notes
                and not name.startswith(("Memcpy", "Memset"))):
            n[name] += 1
    return n


def log_records(label: str, records) -> None:
    """A traced frame's spans: device and host ms, counts, caps."""
    for r in records:
        caps = ", ".join(f"{k} {c['live']}/{c['cap']} dropped {c['dropped']}"
                         for k, c in r.caps.items())
        log(f"  {label} span {r.name}: device {r.device_ms:.3f} ms, host "
            f"{(r.host_end_ns - r.host_start_ns) / 1e6:.3f} ms"
            + (f", counts {r.counts}" if r.counts else "")
            + (f", caps {caps}" if caps else ""))


def tracer_phase(dev, dens, env) -> dict:
    """The tracer on the card (phase 20): one ``.item()`` inside a span
    counts as one sync (and the block restores the sync debug mode); then
    config 5's 1080p frame (train, bake, render_banded over the bench's
    caps and hoists) and config 4's 800x800 ``frame_step``, each traced
    once after a warm-up: its spans logged, K1's ``rows`` equal to the
    query's row count (config 5: the packed lanes); the frame's kernels
    with the tracer off equal the traced frame's with ``profiling.cap``
    stubbed out; and the frame's image traced, no further from its
    nearest untraced repeat than TRACER_NOISE_MARGIN times the largest gap
    between two of TRACER_UNTRACED untraced repeats (bit for bit where
    those agree). Returns what it measured."""
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.render import frame, tiled
    from neuralradiancecaching_tpu_torch.scene import scene as scn
    from neuralradiancecaching_tpu_torch.utils import profiling
    out = {}
    with profiling.tracing(dev) as rec:
        with profiling.span("probe"):
            value = (torch.ones(4, device=dev) * 2).sum().item()
    probe = rec.records()[0]
    out["item_syncs"] = probe.counts.get("syncs", 0)
    log(f"tracer: one .item() inside a span: {out['item_syncs']} sync(s) "
        f"counted, {rec.loose_syncs} outside spans")
    check(value == 8.0 and out["item_syncs"] == 1 and rec.loose_syncs == 0,
          "the tracer did not count the .item() as one sync")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the tracing block left the sync debug mode on")

    def traced_checks(label, run, rows):
        """run(seed) -> image; the frame off/on/off, its records, its
        kernels with the tracer off and on with the cap arithmetic
        stubbed out."""
        run(1)  # warm-up
        off = [run(2)]
        sync()
        with profiling.tracing(dev) as rec:
            with rec.frame(2):
                on = run(2)
        records, sites = rec.records(), rec.sync_sites
        off += [run(2) for _ in range(TRACER_UNTRACED - 1)]
        sync()
        log_records(label, records)
        for site, k in sorted(sites.items(), key=lambda kv: -kv[1])[:12]:
            log(f"  {label} syncs at {site}: {k}")
        k1_rows = sum(r.counts.get("rows", 0) for r in records
                      if r.name == "k1")
        syncs = sum(r.counts.get("syncs", 0) for r in records
                    if r.name != "frame")
        notes = {r.name for r in records}
        k_off = device_kernels(lambda: run(3))
        real_cap, profiling.cap = profiling.cap, lambda *a, **k: None
        try:
            with profiling.tracing(dev) as rec:
                def on_frame():
                    with rec.frame(3):
                        run(3)
                k_on = device_kernels(on_frame, notes)
        finally:
            profiling.cap = real_cap
        if k_on != k_off:
            log(f"  {label}: kernels off against on: "
                f"{dict((k_off - k_on) + (k_on - k_off))}")

        def gap(a, b):
            return float((a - b).abs().max())
        noise = max(gap(a, b) for k, a in enumerate(off) for b in off[k + 1:])
        res = {"k1_rows": k1_rows, "syncs": syncs,
               "kernels_off": sum(k_off.values()),
               "kernels_on_without_caps": sum(k_on.values()),
               "gaps_on": [gap(on, a) for a in off], "gap_off": noise}
        log(f"tracer, {label}: K1 rows {k1_rows} (expected {rows}), syncs "
            f"inside program spans {syncs}, kernels with the tracer off "
            f"{res['kernels_off']}, traced with the cap arithmetic stubbed "
            f"out {res['kernels_on_without_caps']}; image traced vs "
            f"{len(off)} untraced, max gaps "
            f"{[f'{g:.3e}' for g in res['gaps_on']]}; largest gap between "
            f"two untraced {noise:.3e} [{CARD}]")
        check(k1_rows == rows, f"{label}: K1 took {k1_rows} rows")
        check(k_off == k_on, f"{label}: the tracer changed the kernels")
        check(min(res["gaps_on"]) <= TRACER_NOISE_MARGIN * noise,
              f"{label}: tracing changed the image beyond the untraced "
              f"frames' own spread")
        return res

    cfg = progressive_config(P_WIDTH, P_HEIGHT)
    scene = scn.make_scene(cfg, dens, env, device=dev)
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(cfg.seed),
                           cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(100)
    for _ in range(P_WARMUP_STEPS):
        state, _ = frame.train_only_step(state, scene, gen, cfg)
    cfg, _ = probe_caps(cfg, scene, dev)
    env_rgb = tiled.frame_env_color(scene, cfg)
    pack = tiled.frame_live_pack(scene, cfg, BAND_ROWS)

    def progressive(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        st, _ = frame.train_only_step(state, scene, g, cfg)
        return tiled.render_banded(st, scene, g, cfg, BAND_ROWS,
                                   env_rgb=env_rgb, baked=nrc.bake(st, cfg),
                                   pack=pack)
    out["config5"] = traced_checks(
        "config 5 1080p frame", progressive,
        cfg.render.spp * pack.ro_p.shape[0] * pack.ro_p.shape[1])
    del scene, state, env_rgb, pack
    torch.cuda.empty_cache()

    c4 = preset_config("config4")
    scene = scn.make_scene(c4, dens, env, device=dev)
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(0), c4,
                           device=dev)

    def online(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return frame.frame_step(state, scene, g, c4)[1].image
    out["config4"] = traced_checks("config 4 800x800 frame", online,
                                   PRESET_SIDE ** 2)
    del scene, state
    torch.cuda.empty_cache()
    return out


def camera_segments(rows: int, steps: int, vol, dev):
    """``rows`` segments through the box in a camera's pixel order from 64
    units out (the orbit's radius), so neighbouring rows are neighbouring
    rays as on the main path: entry to exit for 32 and more steps, from
    the ray's midpoint in the box to the box exit along another pixel-
    ordered direction for 16 (the shade's sky rays)."""
    from neuralradiancecaching_tpu_torch.ops import volume
    side = int(np.ceil(np.sqrt(rows)))
    u = (torch.arange(side, device=dev, dtype=torch.float32) + 0.5) / side
    gy, gx = torch.meshgrid(u - 0.5, u - 0.5, indexing="ij")
    rd = torch.stack([gx * 1.2, gy * 1.2, torch.ones_like(gx)], dim=-1)
    rd = (rd / torch.linalg.vector_norm(rd, dim=-1, keepdim=True)
          ).reshape(-1, 3)[:rows].contiguous()
    ro = torch.tensor([0.0, 0.0, -64.0], device=dev).expand(rows, 3)
    entry, exit_p, _ = volume.entry_exit_points(ro, rd, vol.box_size,
                                                vol.box_center)
    if steps > 16:
        return entry, exit_p
    mid = 0.5 * (entry + exit_p)
    sky = torch.stack([rd[:, 1], -rd[:, 2], rd[:, 0]], dim=-1)
    _, out, _ = volume.entry_exit_points(mid, sky, vol.box_size,
                                         vol.box_center)
    return mid, out


def transmittance_phase(dev, dens) -> dict:
    """The quadrature kernel against the plain path (phase 21): bit for bit
    at each of TRANSMITTANCE_SHAPES on the 8-bit stand-in table with
    reference_exact's volume, over camera-ordered segments; the kernel's
    time (the wrapper's torch operations included: the segment, its
    length and step size and the step sum; and the finish kernel), the
    plain path's, the bound (each byte read or written once: the table,
    the segments' ends, the samples written and summed, and the result,
    over HBM_BYTES_S) and the time every sample's 32-byte row would take
    from device memory (most come from L1 or L2). The checked call runs
    under the tracer: two launches; the timed calls run untraced."""
    from neuralradiancecaching_tpu_torch.ops import volume
    vol = exact_config().volume
    table = volume.build_corner_table(volume.quantize_8bit(
        torch.as_tensor(dens, device=dev)))
    out = {}
    for rows, steps in TRANSMITTANCE_SHAPES:
        start, end = camera_segments(rows, steps, vol, dev)
        got, n = traced(dev, lambda: volume.transmittance(table, start, end,
                                                          steps, vol))
        want = volume.transmittance_plain(table, start, end, steps, vol)
        sync()
        equal = torch.equal(got, want)
        check(n["k3_launches"] == 2,
              "transmittance did not launch its two kernels on the card")
        check(equal, f"the transmittance kernel differs from the plain path "
              f"at {rows} x {steps}")

        def kernel():
            return volume.transmittance_kernel(table, start, end, steps, vol)

        def plain():
            return volume.transmittance_plain(table, start, end, steps, vol)
        t_p1, t_k1 = time_ms(plain, 2, 3), time_ms(kernel, 10, 5)
        t_k2, t_p2 = time_ms(kernel, 10, 5), time_ms(plain, 2, 3)
        k_ms, p_ms = statistics.median([t_k1, t_k2]), statistics.median(
            [t_p1, t_p2])
        b_ms = (table.numel() * 4 + rows * (24 + 4) + rows * steps * 8
                ) / HBM_BYTES_S * 1e3
        rows_ms = rows * steps * 32.0 / HBM_BYTES_S * 1e3
        key = f"{rows}x{steps}"
        out[key] = {"equal": equal, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "roofline_pct": 100.0 * b_ms / k_ms,
                    "row_traffic_ms": rows_ms,
                    "gsamples_s": rows * steps / k_ms / 1e6,
                    "mean_t": float(got.mean())}
        log(f"transmittance kernel {key}: bitwise equal {equal}; kernel "
            f"{k_ms:.4f} ms ({t_k1:.4f}, {t_k2:.4f}), plain {p_ms:.3f} ms "
            f"({t_p1:.3f}, {t_p2:.3f}), {p_ms / k_ms:.1f}x; bound {b_ms:.4f} "
            f"ms by bytes ({100.0 * b_ms / k_ms:.1f}% of the kernel's time); "
            f"every sample's row from device memory {rows_ms:.4f} ms; "
            f"{rows * steps / k_ms / 1e6:.2f} G samples/s; mean T "
            f"{float(got.mean()):.4f}; {CARD}")
        del start, end, got, want
    torch.cuda.empty_cache()
    return out


def main() -> int:
    global T_START
    T_START = t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "neuralradiancecaching_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from neuralradiancecaching_tpu_torch.io import assets
    from neuralradiancecaching_tpu_torch import kernels
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.ops import matmul
    from neuralradiancecaching_tpu_torch.render import (frame, pathtrace,
                                                        targets)
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn

    # -- 1. device --------------------------------------------------------
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    global CARD
    CARD = smi
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)
    phase("2: build")
    # -- 2. build K1 and K2 from the sources in the checkout, together -------
    t0 = time.perf_counter()
    kernels.build_all(kernels.CUDA_KERNELS)
    for kname in kernels.CUDA_KERNELS:
        kernels.load(kname)
        log(f"build {kname}: nvcc {kernels.BUILD_SECONDS[kname]:.2f} s -> "
            f"{kernels.library_path(kname).relative_to(REPO)}")
        for line in kernels.BUILD_LOG[kname].splitlines():
            log(f"  nvcc: {line}")
    log(f"the builds: {time.perf_counter() - t0:.2f} s wall")
    for kname in ("fused_mlp", "matmul"):
        n_hgmma = kernels.sass(kname).count("HGMMA")
        log(f"{kname}: {n_hgmma} HGMMA (wgmma) instructions in its SASS")
        check(n_hgmma > 0, f"{kname} has no wgmma instruction")

    cfg = slice_config(WIDTH, HEIGHT)
    gen = torch.Generator(device=dev).manual_seed(0)

    phase("3: K1 and K2 vs plain")
    # -- 3. K1 vs plain on random rows, and timings -----------------------
    params_he = he_params(cfg.mlp, gen, dev)
    k1_err = k1_err_f64 = 0.0
    for n in K1_SIZES + (PRESET_SIDE ** 2,):
        x = torch.randn((n, cfg.mlp.in_features), generator=gen, device=dev)
        abs_e, rel_e, f64_e, plain_f64 = compare_k1(params_he, x, cfg.mlp)
        k1_err, k1_err_f64 = max(k1_err, abs_e), max(k1_err_f64, f64_e)
        log(f"K1 vs plain n={n}: max abs {abs_e:.3e} max rel {rel_e:.3e}; "
            f"vs float64: kernel {f64_e:.3e}, plain {plain_f64:.3e}")
    check_k1_nonfinite(params_he, cfg.mlp, torch.float32, dev)
    for params in (params_he, nrc.init_state(torch.Generator(
            device=dev).manual_seed(0), cfg).mlp_params):
        check_k1_pack(params, cfg.mlp, False, dev)
    check_k1_wide(dev)
    # timed at the row count of the config-4-preset frame's query (800^2)
    x_big = torch.randn((PRESET_SIDE ** 2, cfg.mlp.in_features),
                        generator=gen, device=dev)
    k1_times = time_k1(params_he, x_big, cfg.mlp)
    k1_flop, k1_bytes = k1_work(cfg.mlp, PRESET_SIDE ** 2, 4 * 64)
    log_k1_times("K1", PRESET_SIDE ** 2, k1_times, k1_flop, k1_bytes)

    # -- 3b. K2 vs plain and float64: the JAX test's shapes, two ragged
    #    ones, 4096^3 ---------------------------------------------------------
    k2_err = k2_err_f64 = 0.0
    for m, k, n in K2_SHAPES:
        a = torch.randn((m, k), generator=gen, device=dev)
        b = torch.randn((k, n), generator=gen, device=dev)
        res = compare_k2(a, b)
        k2_err = max(k2_err, res["kernel_vs_plain"][0])
        k2_err_f64 = max(k2_err_f64, res["kernel_vs_exact"][0])
        log(f"K2 {m}x{k}x{n}: max abs diff (outputs outside "
            f"{K2_TOL:g} + {K2_TOL:g}|ref|): kernel vs plain "
            f"{res['kernel_vs_plain'][0]:.3e} ({res['kernel_vs_plain'][1]}), "
            f"kernel vs float64 {res['kernel_vs_exact'][0]:.3e} "
            f"({res['kernel_vs_exact'][1]}), plain vs float64 "
            f"{res['plain_vs_exact'][0]:.3e} ({res['plain_vs_exact'][1]}), "
            f"float64 vs plain ({res['exact_vs_plain'][1]}); held to plain: "
            f"{res['plain_held']}")
    k2 = lambda: matmul.matmul_kernel(a, b)  # noqa: E731
    k2_plain = lambda: matmul.matmul_plain(a, b)  # noqa: E731
    for fn in (k2_plain, k2):  # warm-up
        fn()
    sync()
    t_mm_a, t_k2_a = time_ms(k2_plain, 5, 3), time_ms(k2, 5, 3)
    t_k2_b, t_mm_b = time_ms(k2, 5, 3), time_ms(k2_plain, 5, 3)
    k2_ms = statistics.median([t_k2_a, t_k2_b])
    mm_ms = statistics.median([t_mm_a, t_mm_b])
    k2_flop, k2_bytes = 2.0 * m * n * k, 4.0 * (m * k + k * n + m * n)
    k2_bound, k2_by = bound_ms(k2_flop, k2_bytes)
    log(f"K2 at {m}x{k}x{n} (split pre-pass + tensor-core kernel): "
        f"{k2_ms:.4f} ms ({t_k2_a:.4f}, {t_k2_b:.4f}), "
        f"{k2_flop / k2_ms / 1e9:.2f} TFLOP/s useful; torch.matmul (TF32 "
        f"off) {mm_ms:.4f} ms ({t_mm_a:.4f}, {t_mm_b:.4f}); bound "
        f"{k2_bound:.4f} ms by {k2_by}; FP32 FMA bound "
        f"{fp32_fma_bound_ms(k2_flop, k2_bytes):.4f} ms")
    del a, b

    phase("4-6: config 4 collision")
    # -- 4. scene at full size ---------------------------------------------
    import bench_torch
    dens, env, cloud_src, env_src = bench_torch.load_assets()
    log(f"cloud {dens.shape}: {cloud_src}; env {env.shape}: {env_src}")

    phase("21: quadrature kernel")
    transmittance_times = transmittance_phase(dev, dens)
    scene = scn.make_scene(cfg, dens, env)
    log(f"scene on {scene.density.device}:")
    for field in ("env_t_field", "env_s_field", "coll_field"):
        t = getattr(scene, field)
        check(t.device.type == "cuda", f"{field} on {t.device}")
        check(bool(torch.isfinite(t).all()), f"{field} not finite")
        log(f"  {field} {tuple(t.shape)} mean {float(t.mean()):.5f}")

    # -- 5. cache state ----------------------------------------------------
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(0), cfg)
    check(state.hash_table.device.type == "cuda", "state not on the card")

    # -- 6. frames through the serving entry point, under the tracer -------
    cams = [camera.make_camera(cfg.camera, dev,
                               *camera.orbit_position(i, ORBIT_POSES))
            for i in range(N_FRAMES)]
    walk_gen = torch.Generator(device=dev).manual_seed(1)
    imgs, n = traced(dev, lambda: [frame.render_only_step(
        state, dataclasses.replace(scene, camera=cam), walk_gen, cfg)
        for cam in cams])
    means = []
    for i, img in enumerate(imgs):
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"frame {i} not finite")
        means.append(float(img.mean()))
    del imgs
    launches = n["k1_f32_launches"]
    check(launches >= N_FRAMES, f"K1 launched {launches} times in "
          f"{N_FRAMES} frames")
    check(all(1e-3 < m < 1e3 for m in means), f"frame means {means}")
    log(f"render_only_step {WIDTH}x{HEIGHT}: means "
        f"{[round(m, 5) for m in means]}, K1 launches {launches}, K2 "
        f"launches {n['k2_launches']}")

    # -- 6b. K1 vs plain on the first frame's real feature rows -------------
    ro, rd = camera.pixel_rays(cams[0], WIDTH, HEIGHT)
    res = pathtrace.trace_path(dataclasses.replace(scene, camera=cams[0]),
                               cfg, ro, rd, walk_gen, use_nn=True)
    feats = nrc.encode_baked(state, nrc.bake(state, cfg), res.query_pos,
                             res.query_dir, cfg)
    log(f"real feature rows {tuple(feats.shape)}, "
        f"{float((res.query_weight > 0).float().mean()):.4f} querying")
    for label, params in (("state weights", state.mlp_params),
                          ("O(1) weights", params_he)):
        abs_e, rel_e, f64_e, plain_f64 = compare_k1(params, feats, cfg.mlp)
        k1_err, k1_err_f64 = max(k1_err, abs_e), max(k1_err_f64, f64_e)
        log(f"K1 vs plain on real rows ({label}): max abs {abs_e:.3e} "
            f"max rel {rel_e:.3e}; vs float64: kernel {f64_e:.3e}, plain "
            f"{plain_f64:.3e}")
    del res, feats

    # -- 6c. online frames through frame_step (train, then render) ----------
    train_gen = torch.Generator(device=dev).manual_seed(5)

    def online():
        nonlocal state
        outs = []
        for cam in cams:
            state, out = frame.frame_step(
                state, dataclasses.replace(scene, camera=cam), train_gen, cfg)
            outs.append((float(out.mse), out.image))
        return outs

    outs, n = traced(dev, online)
    mses = [m for m, _ in outs]
    for i, (mse, img) in enumerate(outs):
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"online frame {i} not finite")
        check(np.isfinite(mse), f"online frame {i}: mse {mse}")
    del outs
    launches_online = n["k1_f32_launches"]
    k2_launches = n["k2_launches"]
    check(launches_online >= N_FRAMES, f"K1 launched {launches_online} times "
          f"in {N_FRAMES} online frames")
    check(int(state.opt_step) == N_FRAMES,
          f"opt_step {int(state.opt_step)}")
    log(f"frame_step {WIDTH}x{HEIGHT} (train {cfg.train.train_width}x"
        f"{cfg.train.train_height} x {cfg.train.vertex_oversample}): mse "
        f"{[round(m, 5) for m in mses]}; K1 launches {launches_online}, K2 "
        f"launches {k2_launches}")

    # -- 6d. the cache learns: TRAIN_STEPS train_only_steps -----------------
    train_scene = dataclasses.replace(scene, camera=cams[1])
    steps = []
    for _ in range(TRAIN_STEPS):
        state, mse = frame.train_only_step(state, train_scene, train_gen, cfg)
        steps.append(mse)
    steps = [float(m) for m in steps]
    first, last = np.mean(steps[:8]), np.mean(steps[-8:])
    log(f"{TRAIN_STEPS} train_only_steps: mse "
        f"{[round(m, 4) for m in steps]}, mean of the first 8 {first:.5f}, "
        f"of the last 8 {last:.5f}")
    check(bool(np.isfinite(steps).all()), "train mse not finite")
    check(last < first, f"the mse did not fall: {first} -> {last}")

    phase("7: card vs CPU")
    # -- 7. the card vs the CPU port at a small size ------------------------
    small = slice_config(32, 32, small=True)
    rng = np.random.default_rng(0)
    s_dens = rng.random(small.volume.grid_shape, dtype=np.float32) * 0.5
    s_env = assets.synthesize_sky(32, 64)
    s_state = nrc.init_state(torch.Generator().manual_seed(2), small,
                             device="cpu")
    he_state = dataclasses.replace(s_state, mlp_params=he_params(
        small.mlp, torch.Generator().manual_seed(3), "cpu"))
    k_steps = min(small.path.coll_max_events, small.path.max_bounces)
    u = torch.rand((k_steps, 4, 32 * 32), generator=torch.Generator()
                   .manual_seed(4))
    t_u = targets.draw_train_uniforms(small, torch.Generator().manual_seed(6),
                                      "cpu")
    imgs, onl = [], []
    for d in ("cpu", dev):
        sc = scn.make_scene(small, s_dens, s_env, device=d)
        imgs.append(frame.render_only_step(state_to(he_state, d), sc, None,
                                           small, uniforms=u.to(d))
                    .cpu().numpy())
        st, out = frame.frame_step(state_to(he_state, d), sc, None, small,
                                   train_uniforms=to_device(t_u, d),
                                   uniforms=u.to(d))
        onl.append((state_to(st, "cpu"), out.image.cpu().numpy(),
                    float(out.mse)))
    sync()

    def pixels(got, ref):
        ok = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
        return ok.mean(), abs(got.mean() - ref.mean()) / abs(ref.mean())

    frac, rel_mean = pixels(imgs[1], imgs[0])
    log(f"card vs CPU port, render_only_step 32x32: {frac:.4f} of pixels "
        f"within 1e-4 + 1e-3|ref|, mean rel diff {rel_mean:.3e}")
    check(frac >= SMALL_FRAC_OK and rel_mean <= SMALL_REL_MEAN,
          "the card's render disagrees with the CPU port")
    (st_c, img_c, mse_c), (st_g, img_g, mse_g) = onl
    frac, rel_mean = pixels(img_g, img_c)
    mse_rel = abs(mse_g - mse_c) / abs(mse_c)
    p_err = max(float((st_g.mlp_params[k] - st_c.mlp_params[k]).abs().max())
                for k in st_c.mlp_params)
    h_diff = (st_g.hash_table - st_c.hash_table).abs()
    h_frac = float((h_diff <= SMALL_PARAM_TOL).float().mean())
    h_bound = 2 * small.mrhe.learning_rate
    log(f"card vs CPU port, frame_step 32x32 (train 16x16): {frac:.4f} of "
        f"pixels within 1e-4 + 1e-3|ref|, mean rel diff {rel_mean:.3e}; mse "
        f"{mse_g:.6f} vs {mse_c:.6f} (rel {mse_rel:.3e}); MLP parameters "
        f"max abs diff {p_err:.3e}; hash entries within "
        f"{SMALL_PARAM_TOL:g}: {h_frac:.6f}, max abs diff "
        f"{float(h_diff.max()):.3e} (2 lr = {h_bound:g})")
    check(frac >= SMALL_FRAC_OK and rel_mean <= SMALL_REL_MEAN,
          "the card's online frame image disagrees with the CPU port")
    check(mse_rel <= SMALL_MSE_REL, "the card's train mse disagrees")
    check(p_err <= SMALL_PARAM_TOL, "the card's MLP step disagrees")
    check(h_frac >= SMALL_HASH_FRAC
          and float(h_diff.max()) <= h_bound * 1.0001,
          "the card's hash-table step disagrees")

    phase("8: config 5")
    # -- 8. config 5's progressive 1080p frame ------------------------------
    del scene, train_scene, state, x_big
    torch.cuda.empty_cache()
    k1_bf16, legs = progressive_frame(dev, dens, env, params_he)

    phase("9-10: configs 3 and 4")
    # -- 9-10. configs 3 and 4 as they ship --------------------------------
    torch.cuda.empty_cache()
    launches_preset, err, err_f64, launches_dense, launches_dp = \
        preset_frames(dev, dens, env, params_he)
    k1_err, k1_err_f64 = max(k1_err, err), max(k1_err_f64, err_f64)
    log(f"K1 f32 launches: {launches_online} on the {N_FRAMES} collision "
        f"online frames, {launches_preset} on the {N_FRAMES} config-4-preset "
        f"frames, {launches_dense} on the {DENSE_FRAMES} dense/hash config-4 "
        f"frames, {launches_dp} on the data-parallel config-4 frame")

    phase("11: presets card vs CPU")
    # -- 11. the card vs the CPU port: the oracle and config 4's frame, and
    #    config 4's frame with the dense bake and the hash train encode ------
    presets_small_vs_cpu(dev)
    dense_hash_small_vs_cpu(dev)

    phase("17: reference_exact")
    # -- 17. reference_exact() as it ships at 800x800 and with K1 on its
    #    query, the card vs the CPU port at 32x32, the raw-grid fetch,
    #    render_tiled, utils.profiling and utils.debug -----------------------
    torch.cuda.empty_cache()
    launches_exact = reference_exact_frames(dev, dens, env)
    exact_small_vs_cpu(dev)
    slice_checks(dev, dens)

    phase("12: CLI")
    # -- 12. the CLI at its default sizes, each run in its own process -----
    torch.cuda.empty_cache()
    runs = cli_runs()

    phase("13: banded card vs CPU")
    # -- 13. the card vs the CPU port on the banded branches --------------
    banded_small_vs_cpu(dev)

    phase("14: side workloads")
    # -- 14. the side workloads: image-fit in its own process, mnist ------
    torch.cuda.empty_cache()
    fit = image_fit_run()
    image_fit_small_vs_cpu(dev)
    mnist = mnist_run()

    phase("15: offline tracer")
    # -- 15. the offline path tracer ----------------------------------------
    torch.cuda.empty_cache()
    offline = offline_trace(dev, dens)

    phase("16d-f: data parallel")
    # -- 16d-f. two gloo ranks on the card, the walks' new branches card vs
    #    CPU, the CLI's data-parallel frames under torchrun -----------------
    torch.cuda.empty_cache()
    dp_two_ranks(dev)
    walk_branches_small_vs_cpu(dev)
    dp_cli_runs()
    log("dp: " + json.dumps(DP_LOG))
    from neuralradiancecaching_tpu_torch.parallel import close_mesh
    close_mesh()

    phase("19: host library")
    # -- 19. the host library: its build and the native HDR decode ---------
    host = host_library()

    phase("20: tracer")
    # -- 20. the tracer where the CPU cannot look: syncs, K1's rows, the
    #    kernels and the image with the tracer off and on ------------------
    torch.cuda.empty_cache()
    log("tracer: " + json.dumps(tracer_phase(dev, dens, env)))
    log("quality: " + json.dumps(legs))
    log("cli: " + json.dumps({k: {f: v for f, v in run.items()
                                  if f != "stdout"}
                              for k, run in runs.items()}))
    log("workloads: " + json.dumps({"image_fit": fit, "mnist": mnist,
                                    "offline_trace": offline}))
    log("host_library: " + json.dumps(host))

    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s")
    record = {"kernels": [
        k1_record("fused_mlp", launches_preset + launches_dense
                  + launches_dp + launches_exact, k1_err, k1_err_f64,
                  k1_times, k1_flop, k1_bytes),
        k1_bf16,
        {"name": "matmul", "route": "cuda",
         "source": "neuralradiancecaching_tpu_torch/csrc/matmul.cu",
         "replaces": "neuralradiancecaching_tpu/ops/pallas_matmul.py:30",
         "launches": k2_launches, "max_abs_err": k2_err,
         "max_abs_err_f64": k2_err_f64, "ms": k2_ms, "plain_ms": mm_ms,
         "bound_ms": k2_bound, "bound_by": k2_by,
         "fp32_fma_bound_ms": fp32_fma_bound_ms(k2_flop, k2_bytes),
         "library_ms": mm_ms},
        {"name": "transmittance", "route": "cuda",
         "source": "neuralradiancecaching_tpu_torch/csrc/transmittance.cu",
         "replaces": "none (XLA array code in the JAX package)",
         "launches": K3_BY_PATH.get("reference_exact frame"),
         "launches_by_path": K3_BY_PATH, "shapes": transmittance_times}]}
    log(json.dumps(record))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
