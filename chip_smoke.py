#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (neuralradiancecaching_tpu_torch)
on one NVIDIA GPU.

Drives the port's serving path -- config 4's cached 512x512 render with the
collision sampler and the fused query MLP -- at full model width (6x64 MLP,
L=16 T=16384 F=2 hash table, random weights from a seed) and full scene
size (125x85x153 density grid, fields at (32, 24, 40) x (16, 32) buckets),
and holds every hand-written kernel on that path to its plain PyTorch
version at the shapes the path gives it. Run from the repository root:

    python3 chip_smoke.py

Phases: device; kernel build; kernel vs plain on random rows with timings;
scene bake; cache state; frames through ``render_only_step`` (launch counts
reset just before, read just after); the frame's profile; kernel vs plain
on the frame's real
feature rows; the port on the card vs the port on the CPU at a small size
with the same walk uniforms (the CPU path is the one the tests hold to the
JAX package). Any failure raises and exits non-zero. Without a CUDA device,
or outside a checkout of the repository, it exits 2 and prints no result.
After the frames it breaks one frame down by layer (CUDA events around
each stage called alone) and by op and kernel (torch.profiler). The line
before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WIDTH = HEIGHT = 512
N_FRAMES = 4
ORBIT_POSES = 8
K1_SIZES = (1, 5, 511, 513, WIDTH * HEIGHT)
# K1 vs the plain torch MLP, both exact fp32 with another summation order
# over 64 terms per layer: |kernel - plain| <= K1_ATOL + K1_RTOL * |plain|
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# the card vs the CPU port at the small size: the render test's tolerance
SMALL_FRAC_OK, SMALL_REL_MEAN = 0.995, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


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


def slice_config(width: int, height: int, small: bool = False):
    """Config 4 + the collision sampler + the fused query MLP; ``small``
    cuts the scene to the tests' size."""
    from neuralradiancecaching_tpu_torch import config as cfg_mod
    r = dataclasses.replace
    cfg = cfg_mod.nrc_online_config(width, height)
    cfg = r(cfg, path=r(cfg.path, sampler="collision"),
            mlp=r(cfg.mlp, fused_inference=True))
    if small:
        cfg = r(cfg, path=r(cfg.path, collision_field_steps=8),
                volume=r(cfg.volume, grid_shape=(16, 12, 20),
                         field_shape=(6, 5, 8)),
                env_map=r(cfg.env_map, scatter_quad_dirs=(8, 16)))
    return cfg


def he_params(cfg, gen: torch.Generator, device) -> dict:
    """MLP weights whose activations stay O(1) through every layer (the
    0.01 init shrinks them ~20x per layer), so the comparison is not one of
    near-zero numbers."""
    from neuralradiancecaching_tpu_torch.ops import mlp as mlp_ops
    dims = mlp_ops.layer_dims(cfg.mlp)
    out = {}
    for i in range(cfg.mlp.n_layers):
        out[f"w{i}"] = torch.randn((dims[i], dims[i + 1]), generator=gen,
                                   device=device) * (2.0 / dims[i]) ** 0.5
        out[f"b{i}"] = torch.randn((dims[i + 1],), generator=gen,
                                   device=device) * 0.1
    return out


def compare_k1(params, x, mlp_cfg):
    """Launch K1 and the plain version on x; returns (max_abs, max_rel)."""
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    got = fused_mlp.apply_kernel(params, x, mlp_cfg)
    ref = fused_mlp.apply_plain(params, x, mlp_cfg)
    sync()
    check(got.shape == ref.shape, f"K1 shape {tuple(got.shape)}")
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), "K1 output not finite")
    check(bool((err <= K1_ATOL + K1_RTOL * ref.abs()).all()),
          f"K1 disagrees with plain at n={x.shape[0]}: max abs "
          f"{float(err.max())}")
    rel = float((err / ref.abs().clamp(min=1e-6)).max()) if err.numel() else 0
    return float(err.max()) if err.numel() else 0.0, rel


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


def profile_frame(state, scene, cfg, gen) -> None:
    """One frame's device time by layer, then by kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from neuralradiancecaching_tpu_torch.models import nrc
    from neuralradiancecaching_tpu_torch.ops import envmap, volume
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace
    from neuralradiancecaching_tpu_torch.scene import camera

    def stage(label, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        out = fn()
        end.record()
        sync()
        log(f"  layer {label}: {start.elapsed_time(end):.3f} ms")
        return out

    vol = cfg.volume
    ro, rd = stage("pixel_rays", lambda: camera.pixel_rays(
        scene.camera, cfg.render.width, cfg.render.height))
    baked = stage("nrc.bake (oct rows)", lambda: nrc.bake(state, cfg))
    entry, _, _ = volume.entry_exit_points(ro, rd, vol.box_size,
                                           vol.box_center)
    _, exit_e, _ = volume.entry_exit_points(entry, rd, vol.box_size,
                                            vol.box_center)
    stage("entry-tau quadrature (inside the walk)", lambda:
          volume.transmittance(scene.density, entry, exit_e,
                               cfg.path.entry_tau_steps, vol))
    res = stage("trace_path (walk + shade, incl. entry tau)", lambda:
                pathtrace.trace_path(scene, cfg, ro, rd, gen, use_nn=True))
    feats = stage("encode_baked", lambda: nrc.encode_baked(
        state, baked, res.query_pos, res.query_dir, cfg))
    stage("query_mlp (K1)", lambda: nrc.query_mlp(state, feats, cfg))
    stage("env composite", lambda: envmap.sample_direct(scene.env, rd,
                                                        hpm=False))
    stage("whole render_only_step", lambda: frame.render_only_step(
        state, scene, gen, cfg))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame.render_only_step(state, scene, gen, cfg)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels_, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            (kernels_ if on_device else ops).append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in kernels_)
    log(f"profiled frame: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%, idle "
        f"{100 - 100 * busy / wall_us:.1f}%), "
        f"{sum(r[1] for r in kernels_)} kernel launches")
    for label, rows in (("op", ops), ("kernel", kernels_)):
        for dev_us, count, key in sorted(rows, reverse=True)[:15]:
            log(f"  {label} {dev_us / 1e3:8.3f} ms {count:5d}x  {key[:80]}")


def asset_source(cands) -> str:
    found = next((p for p in cands if os.path.exists(p)), None)
    return f"file {found}" if found else "deterministic synthesized stand-in"


def main() -> int:
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
    from neuralradiancecaching_tpu_torch.ops import fused_mlp
    from neuralradiancecaching_tpu_torch.render import frame, pathtrace
    from neuralradiancecaching_tpu_torch.scene import camera, scene as scn

    # -- 1. device --------------------------------------------------------
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # -- 2. build K1 from the sources in the checkout ----------------------
    t0 = time.perf_counter()
    kernels.load("fused_mlp")
    log(f"build fused_mlp: {time.perf_counter() - t0:.2f} s wall, nvcc "
        f"{kernels.BUILD_SECONDS['fused_mlp']:.2f} s -> "
        f"{kernels.library_path('fused_mlp').relative_to(REPO)}")
    for line in kernels.BUILD_LOG["fused_mlp"].splitlines():
        log(f"  nvcc: {line}")

    cfg = slice_config(WIDTH, HEIGHT)
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 3. K1 vs plain on random rows, and timings -----------------------
    params_he = he_params(cfg, gen, dev)
    k1_err = 0.0
    for n in K1_SIZES:
        x = torch.randn((n, cfg.mlp.in_features), generator=gen, device=dev)
        abs_e, rel_e = compare_k1(params_he, x, cfg.mlp)
        k1_err = max(k1_err, abs_e)
        log(f"K1 vs plain n={n}: max abs {abs_e:.3e} max rel {rel_e:.3e}")
    x_big = torch.randn((WIDTH * HEIGHT, cfg.mlp.in_features),
                        generator=gen, device=dev)
    k1 = lambda: fused_mlp.apply_kernel(params_he, x_big, cfg.mlp)  # noqa
    plain = lambda: fused_mlp.apply_plain(params_he, x_big, cfg.mlp)  # noqa
    for fn in (plain, k1):  # warm-up
        fn()
    sync()
    # in turns on one card: plain, kernel, kernel, plain
    t_plain_a, t_k1_a = time_ms(plain), time_ms(k1)
    t_k1_b, t_plain_b = time_ms(k1), time_ms(plain)
    k1_ms = statistics.median([t_k1_a, t_k1_b])
    plain_ms = statistics.median([t_plain_a, t_plain_b])
    flop = 2 * WIDTH * HEIGHT * sum(
        a * b for a, b in zip([64] * cfg.mlp.n_layers,
                              [64] * (cfg.mlp.n_layers - 1) + [3]))
    log(f"K1 at {WIDTH * HEIGHT} rows: {k1_ms:.4f} ms ({t_k1_a:.4f}, "
        f"{t_k1_b:.4f}); plain {plain_ms:.4f} ms ({t_plain_a:.4f}, "
        f"{t_plain_b:.4f}); K1 {flop / k1_ms / 1e9:.2f} TFLOP/s fp32")

    # -- 4. scene at full size ---------------------------------------------
    cloud_src = asset_source([
        os.path.join(assets.REFERENCE_DATA, "cloud_sixteenth"),
        os.path.join(assets.CACHE_DIR, "cloud_sixteenth")])
    env_src = asset_source([
        os.path.join(assets.REFERENCE_DATA, "image/photostudio_4k.hdr"),
        os.path.join(assets.REFERENCE_DATA, "image/photostudio.hdr"),
        os.path.join(assets.CACHE_DIR, "photostudio.hdr")])
    dens = assets.load_cloud()
    env = assets.load_env_map()
    log(f"cloud {dens.shape}: {cloud_src}; env {env.shape}: {env_src}")
    torch.cuda.reset_peak_memory_stats()
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    scene = scn.make_scene(cfg, torch.from_numpy(dens).to(dev),
                           torch.from_numpy(env).to(dev), timings=timings)
    sync()
    bake_s = time.perf_counter() - t0
    log(f"scene bake {bake_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in timings.items()))
    for field in ("env_t_field", "env_s_field", "coll_field"):
        t = getattr(scene, field)
        check(bool(torch.isfinite(t).all()), f"{field} not finite")
        log(f"  {field} {tuple(t.shape)} mean {float(t.mean()):.5f}")
    log(f"peak memory during the bake: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # -- 5. cache state ----------------------------------------------------
    state = nrc.init_state(torch.Generator(device=dev).manual_seed(0), cfg)
    sync()

    # -- 6. frames through the serving entry point --------------------------
    cams = [camera.make_camera(cfg.camera, dev,
                               *camera.orbit_position(i, ORBIT_POSES))
            for i in range(N_FRAMES + 1)]
    walk_gen = torch.Generator(device=dev).manual_seed(1)

    def render(i):
        return frame.render_only_step(
            state, dataclasses.replace(scene, camera=cams[i]), walk_gen, cfg)

    render(0)  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.LAUNCHES = 0
    frame_ms, means = [], []
    for i in range(1, N_FRAMES + 1):
        sync()
        t0 = time.perf_counter()
        img = render(i)
        sync()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"frame {i} not finite")
        means.append(float(img.mean()))
    launches = fused_mlp.LAUNCHES
    peak_frames = torch.cuda.max_memory_allocated()
    check(launches >= N_FRAMES, f"K1 launched {launches} times in "
          f"{N_FRAMES} frames")
    check(all(1e-3 < m < 1e3 for m in means), f"frame means {means}")
    med = statistics.median(frame_ms)
    log(f"frames {WIDTH}x{HEIGHT}: ms {[round(t, 3) for t in frame_ms]}, "
        f"median {med:.3f} ms, {WIDTH * HEIGHT / med / 1e3:.3f} Mrays/s, "
        f"means {[round(m, 5) for m in means]}, K1 launches {launches}, "
        f"peak memory {peak_frames / 2**30:.3f} GiB")

    profile_frame(state, dataclasses.replace(scene, camera=cams[1]), cfg,
                  walk_gen)

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
        abs_e, rel_e = compare_k1(params, feats, cfg.mlp)
        k1_err = max(k1_err, abs_e)
        log(f"K1 vs plain on real rows ({label}): max abs {abs_e:.3e} "
            f"max rel {rel_e:.3e}")
    sync()

    # -- 7. the card vs the CPU port at a small size ------------------------
    small = slice_config(32, 32, small=True)
    rng = np.random.default_rng(0)
    s_dens = rng.random(small.volume.grid_shape, dtype=np.float32) * 0.5
    s_env = assets.synthesize_sky(32, 64)
    s_state = nrc.init_state(torch.Generator().manual_seed(2), small)
    s_state.mlp_params = he_params(small, torch.Generator().manual_seed(3),
                                   "cpu")
    k_steps = min(small.path.coll_max_events, small.path.max_bounces)
    u = torch.rand((k_steps, 4, 32 * 32), generator=torch.Generator()
                   .manual_seed(4))
    imgs = []
    for d in ("cpu", dev):
        sc = scn.make_scene(small, torch.from_numpy(s_dens).to(d),
                            torch.from_numpy(s_env).to(d))
        st = dataclasses.replace(
            s_state, mlp_params={k: v.to(d) for k, v in
                                 s_state.mlp_params.items()},
            hash_table=s_state.hash_table.to(d))
        imgs.append(frame.render_only_step(st, sc, None, small,
                                           uniforms=u.to(d)).cpu().numpy())
    sync()
    ref, got = imgs
    ok = np.all(np.abs(got - ref) <= 1e-4 + 1e-3 * np.abs(ref), axis=-1)
    rel_mean = abs(got.mean() - ref.mean()) / abs(ref.mean())
    log(f"card vs CPU port at 32x32: {ok.mean():.4f} of pixels within "
        f"1e-4 + 1e-3|ref|, mean rel diff {rel_mean:.3e}")
    check(ok.mean() >= SMALL_FRAC_OK and rel_mean <= SMALL_REL_MEAN,
          "the card's render disagrees with the CPU port")

    record = {"kernels": [{
        "name": "fused_mlp", "route": "cuda",
        "source": "neuralradiancecaching_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "neuralradiancecaching_tpu/ops/pallas_mlp.py:37",
        "launches": launches, "max_abs_err": k1_err, "ms": k1_ms,
        "plain_ms": plain_ms}]}
    log(json.dumps(record))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
