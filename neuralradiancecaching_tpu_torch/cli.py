"""Command-line entry points of the port -- the subcommands of
``neuralradiancecaching_tpu/cli.py`` (the reference's ``RunNrcHpm`` main
loop, src/main.cpp:109-284, one headless subcommand per workload) with the
same arguments, defaults and control flow, on one device: EXR and PNG
output for swapchain presentation, JSONL metrics for the ImGui panel.

  python -m neuralradiancecaching_tpu_torch.cli mnist
  python -m neuralradiancecaching_tpu_torch.cli image-fit --steps 500
  python -m neuralradiancecaching_tpu_torch.cli pathtrace --out out
  python -m neuralradiancecaching_tpu_torch.cli nrc-online --frames 8 --out out
  python -m neuralradiancecaching_tpu_torch.cli progressive --frames 4 --out out
  python -m neuralradiancecaching_tpu_torch.cli --device cpu pathtrace \\
      --width 64 --height 64

Everything runs on the card (``--device cuda``, the default); without one
the CLI exits with an error unless ``--device cpu`` asks for the CPU.
Frames above 512x512 render in row bands (``tiled.render_banded``). The
JAX package's random keys become ``torch.Generator``s seeded with its seed
arithmetic, one per frame. A frame's wall time ends at a device
synchronize; metrics rows carry it unrounded, and on the card the peak
device memory of the frames since the previous row (the scene bake
excluded).

``mnist`` reads its idx label files from the checkout's ``data/mnist/``
(``io/assets.py:MNIST_DIRS``; none ships, nothing is downloaded) and exits
with an error without them.

Data parallel (``--mesh off|auto|N`` on ``nrc-online`` and
``progressive``): one process per card, launched by ``torchrun``; the
ranks shard the rays (``parallel/data_parallel.py``) and rank 0 alone
writes the EXR, PNG, JSONL and checkpoints:

  torchrun --nproc-per-node 4 -m neuralradiancecaching_tpu_torch.cli \
      progressive --mesh auto

``--mesh N`` must equal the launcher's world size (exit 2 otherwise);
NCCL joins the ranks on the cards, gloo with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from neuralradiancecaching_tpu_torch import config as cfg_mod
from neuralradiancecaching_tpu_torch.io import assets, checkpoint, exr
from neuralradiancecaching_tpu_torch.models import image_fit, mnist_mlp, nrc
from neuralradiancecaching_tpu_torch.parallel import data_parallel as dp
from neuralradiancecaching_tpu_torch.parallel import mesh as mesh_mod
from neuralradiancecaching_tpu_torch.render import frame as frame_mod
from neuralradiancecaching_tpu_torch.render import pathtrace, tiled
from neuralradiancecaching_tpu_torch.scene import camera as cam_mod
from neuralradiancecaching_tpu_torch.scene.scene import make_scene
from neuralradiancecaching_tpu_torch.utils.metrics import MetricsLogger


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="out")
    p.add_argument("--metrics", type=str, default=None,
                   help="JSONL metrics path")


def _save_frame(out_dir: str, name: str, image: torch.Tensor) -> None:
    image = image.float().cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    exr.write_exr(os.path.join(out_dir, name + ".exr"), image)
    exr.write_png(os.path.join(out_dir, name + ".png"), exr.tonemap(image))


def _build_scene(cfg, device: torch.device):
    return make_scene(cfg, assets.load_cloud(), assets.load_env_map(),
                      device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start_frames(device: torch.device) -> None:
    """Peak memory counts the frames from here (not the scene bake)."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device) -> dict:
    """The peak device memory since the previous metrics row (since the
    frames began, for the first) for a metrics row (card only)."""
    if device.type != "cuda":
        return {}
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    torch.cuda.reset_peak_memory_stats(device)
    return {"peak_gib": peak}


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _band_rows(width: int, height: int, n_dev: int = 1) -> int | None:
    """Band height for tiled rendering of frames above 512x512: the first
    candidate that divides the height (30-row bands measured fastest at
    1080p under the JAX package's packed pipeline on the TPU; 800 rows take
    32). The threshold is the JAX CLI's; PERF.md records what banding costs
    on the card. With n_dev ranks the striped DP renders need height %
    (n_dev * rows) == 0 (1080p on 8 ranks: 27-row bands; 800 rows: 25)."""
    if width * height <= 512 * 512:
        return None
    for rows in (30, 54, 108, 64, 32, 27, 25, 20, 16, 10, 9, 8, 5, 4, 3,
                 2, 1):
        if height % (n_dev * rows) == 0:
            return rows
    return None


def _mesh_from_arg(mesh_arg: str | None, device: torch.device):
    """--mesh off|auto|N -> the data-parallel Mesh, or None when off. 'auto'
    takes the launcher's world size (1 without one), so the same command
    runs on one card and under torchrun on several; N must equal it."""
    if not mesh_arg or mesh_arg == "off":
        return None
    size = mesh_mod.world_size()
    if mesh_arg != "auto" and int(mesh_arg) != size:
        print(f"--mesh {mesh_arg} needs {mesh_arg} ranks; the launcher "
              f"started {size} (torchrun --nproc-per-node {mesh_arg})",
              file=sys.stderr)
        raise SystemExit(2)
    return mesh_mod.make_mesh(size, device)


class _Rank0:
    """What only rank 0 of a mesh does (prints, files); everything without
    a mesh."""

    def __init__(self, mesh):
        self.on = mesh is None or mesh.rank == 0

    def print(self, *a) -> None:
        if self.on:
            print(*a)

    def logger(self, path: str | None) -> MetricsLogger:
        return MetricsLogger(path if self.on else None)


def _render_frame(state, scene, gen, cfg) -> torch.Tensor:
    """Render one frame, banded when large: (H, W, 3) on the device."""
    band = _band_rows(cfg.render.width, cfg.render.height)
    if band:
        return tiled.render_banded(state, scene, gen, cfg, band_rows=band)
    return frame_mod.render_only_step(state, scene, gen, cfg)


def _with_aspect(cfg, width: int, height: int):
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, aspect=width / height))


def _with_sampler(cfg, sampler: str | None):
    if not sampler or sampler == cfg.path.sampler:
        return cfg
    return dataclasses.replace(cfg, path=dataclasses.replace(
        cfg.path, sampler=sampler))


def cmd_mnist(args) -> None:
    """Config 1: the MNIST MLP, then its accuracy on 2048 test rows."""
    dev = args.device
    cfg = cfg_mod.mnist_config()
    x, y = assets.load_mnist("train", limit=args.limit)
    log = MetricsLogger(args.metrics)
    state, loss, acc = mnist_mlp.train(x, y, cfg.mlp, cfg.mlp_opt,
                                       steps=args.steps, seed=args.seed,
                                       device=dev)
    xt, yt = assets.load_mnist("test", limit=2048)
    _, test_acc = mnist_mlp.loss_fn(state.params, torch.as_tensor(xt,
                                                                  device=dev),
                                    torch.as_tensor(yt, device=dev), cfg.mlp)
    log.log(args.steps, train_loss=loss, train_acc=acc,
            test_acc=float(test_acc))
    print(f"mnist: loss={loss:.4f} acc={acc:.3f} test_acc={float(test_acc):.3f}")


def cmd_image_fit(args) -> None:
    """Config 2: fit the env map with the 2-D hash encode, then write the
    fitted image; the metrics row holds the PSNR and the fit's seconds
    (its steps and the full-image PSNR, ending in a synchronize)."""
    dev = args.device
    img = assets.load_env_map()
    log = MetricsLogger(args.metrics)
    _sync(dev)
    t0 = time.perf_counter()
    state, psnr_db = image_fit.fit_image(img, steps=args.steps,
                                         seed=args.seed, device=dev)
    _sync(dev)
    log.log(args.steps, psnr=psnr_db, fit_s=time.perf_counter() - t0)
    print(f"image-fit: psnr={psnr_db:.2f} dB over {args.steps} steps")
    if args.out:
        mrhe_cfg, mlp_cfg, _ = image_fit.default_configs()
        h, w = img.shape[:2]
        uv = image_fit.pixel_uv(torch.arange(h * w, device=dev), h, w)
        pred = image_fit.predict(state, uv, mrhe_cfg, mlp_cfg)
        _save_frame(args.out, "image_fit", pred.reshape(h, w, 3))


def cmd_pathtrace(args) -> None:
    dev = args.device
    cfg = _with_aspect(cfg_mod.pathtrace_config(args.width, args.height,
                                                args.spp),
                       args.width, args.height)
    # 'collision' = baked-field perf sampler; 'delta' = unbiased Woodcock
    # ground truth; 'reference' = the upstream march
    cfg = _with_sampler(cfg, args.sampler)
    scene = _build_scene(cfg, dev)
    state = nrc.init_state(_generator(dev, args.seed), cfg, device=dev)
    log = MetricsLogger(args.metrics)
    _sync(dev)
    _start_frames(dev)
    t0 = time.perf_counter()
    img = _render_frame(state, scene, _generator(dev, args.seed), cfg)
    _sync(dev)
    dt = time.perf_counter() - t0
    mean = float(img.mean())
    log.log(0, frame_s=dt, mean=mean,
            mrays_s=args.width * args.height * args.spp / dt / 1e6,
            **_peak(dev))
    print(f"pathtrace: {args.width}x{args.height} spp={args.spp} "
          f"{dt:.2f}s mean={mean:.4f}")
    _save_frame(args.out, "pathtrace", img)


def cmd_nrc_online(args) -> None:
    mesh = _mesh_from_arg(args.mesh, args.device)
    dev = mesh.device if mesh is not None else args.device
    r0 = _Rank0(mesh)
    cfg = _with_aspect(cfg_mod.nrc_online_config(args.width, args.height),
                       args.width, args.height)
    cfg_base = cfg  # pre-override config: what a default-run checkpoint
    # was saved under (the natural parity flow trains with the default
    # sampler and resumes with --sampler delta)
    cfg = _with_sampler(cfg, args.sampler)
    scene = _build_scene(cfg, dev)
    state = nrc.init_state(_generator(dev, args.seed), cfg, device=dev)
    if args.resume:
        try:
            state = checkpoint.load(
                args.resume, state,
                expect_config_hash=checkpoint.config_hash(cfg))
        except ValueError:
            if cfg is cfg_base:
                raise
            # accept checkpoints trained under the pre-override sampler
            state = checkpoint.load(
                args.resume, state,
                expect_config_hash=checkpoint.config_hash(cfg_base))
            r0.print(f"note: checkpoint config matches the default sampler; "
                     f"evaluating under --sampler {args.sampler}")
        r0.print(f"resumed from {args.resume}")

    log = r0.logger(args.metrics)
    img = None
    band = _band_rows(args.width, args.height,
                      mesh.size if mesh is not None else 1)
    big = band is not None
    _sync(dev)
    _start_frames(dev)
    for i in range(args.frames):
        t0 = time.perf_counter()
        gen = _generator(dev, args.seed * 7919 + i)
        if mesh is not None and big:
            state, img, mse, _ = dp.dp_train_banded_frame(
                state, scene, gen, cfg, mesh, band_rows=band)
        elif mesh is not None:
            state, img, mse = dp.dp_frame_step(state, scene, gen, cfg, mesh)
        elif big:
            # large frames: a train pass, then the banded render
            state, mse = frame_mod.train_only_step(state, scene, gen, cfg)
            img = _render_frame(state, scene, gen, cfg)
        else:
            state, out = frame_mod.frame_step(state, scene, gen, cfg)
            img, mse = out.image, out.mse
        _sync(dev)
        dt = time.perf_counter() - t0
        row = log.log(i, mse=float(mse), frame_s=dt,
                      mrays_s=args.width * args.height / dt / 1e6,
                      **_peak(dev))
        # reference logs MSE every 25 frames (src/main.cpp:220-224)
        if i % max(args.frames // 8, 1) == 0 or i == args.frames - 1:
            r0.print(f"frame {i}: mse={row['mse']:.5f} {dt:.3f}s")
    if img is not None and r0.on:
        _save_frame(args.out, "nrc_online", img)
    if args.checkpoint and r0.on:
        checkpoint.save(args.checkpoint, state,
                        metadata={"frames": args.frames, "seed": args.seed,
                                  "config_hash": checkpoint.config_hash(cfg)})
        print(f"checkpoint -> {args.checkpoint}")


def _probe_caps(args, scene, cfg, mesh, band, live_pack, r0):
    """--probe-caps on a mesh, at each pose: 'auto' sizes the query and
    shade caps to the worst shard (dp.probe_dp_caps, drop-free by
    construction) rounded up to 1/16 so they stay put across poses;
    'uncapped' turns the caps off; 'off' keeps the config's."""
    if args.probe_caps == "auto" and cfg.render.use_nn \
            and pathtrace.shade_deferred(cfg):
        cfg_t, rep = dp.probe_dp_caps(scene, cfg, mesh.size, band_rows=band,
                                      pack=live_pack)
        qc = min(1.0, float(np.ceil(cfg_t.render.query_cap_fraction
                                    / 0.0625) * 0.0625))
        sc = float(np.ceil(cfg_t.render.shade_cap_fraction / 0.0625)
                   * 0.0625)
        r0.print(f"probe-caps: query_cap={qc} shade_cap={sc} (per-shard "
                 f"worst: q={rep.query_frac.max():.4f} "
                 f"ev={rep.event_mean.max():.4f})")
    elif args.probe_caps == "uncapped":
        qc, sc = 1.0, float(cfg.path.max_bounces)
    else:
        return cfg
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, query_cap_fraction=qc, shade_cap_fraction=sc))


def cmd_progressive(args) -> None:
    """Config 5: progressive accumulation along a camera orbit."""
    mesh = _mesh_from_arg(args.mesh, args.device)
    dev = mesh.device if mesh is not None else args.device
    n_dev = mesh.size if mesh is not None else 1
    r0 = _Rank0(mesh)
    cfg = cfg_mod.progressive_1080p_config()
    cfg = _with_aspect(dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, width=args.width, height=args.height)),
        args.width, args.height)
    cfg = _with_sampler(cfg, args.sampler)
    scene = _build_scene(cfg, dev)
    state = nrc.init_state(_generator(dev, args.seed), cfg, device=dev)
    log = r0.logger(args.metrics)

    # the camera moves every `move_every` frames; progressive 1-spp
    # accumulation resets on movement. The accumulation stays on the
    # device, the direct-env composite and the live-ray pack are hoisted
    # per camera pose, the bake re-runs every --bake-every frames, and the
    # host synchronizes once per --sync-every frames.
    band = args.band_rows or _band_rows(args.width, args.height, n_dev)
    if band and args.height % (n_dev * band):
        raise SystemExit(f"height {args.height} is not a multiple of "
                         f"{n_dev} ranks x --band-rows {band}")
    banded = band is not None
    accum = torch.zeros((args.height, args.width, 3), dtype=torch.float32,
                        device=dev)
    n_accum = 0
    env_rgb = baked = live_pack = None
    _sync(dev)
    _start_frames(dev)
    win_t0, win_i = time.perf_counter(), 0
    for i in range(args.frames):
        if i % args.move_every == 0:
            pos, vdir = cam_mod.orbit_position(
                i // args.move_every,
                max(args.frames // args.move_every, 1) * 4, radius=64.0)
            scene = dataclasses.replace(scene, camera=cam_mod.make_camera(
                cfg.camera, dev, position=pos, view_dir=vdir))
            accum = torch.zeros_like(accum)
            n_accum = 0
            env_rgb = tiled.frame_env_color(scene, cfg) if banded else None
            # --live-pack: size the frame-global live-ray pack from the
            # exact pose-static entry-tau mask (drop-free by
            # construction); the 1/8 rounding keeps the cap, and so the
            # lane counts, stable across camera moves
            if (banded and args.live_pack != "off"
                    and pathtrace.shade_deferred(cfg)):
                frac = (tiled.live_fraction(scene, cfg)
                        if args.live_pack == "auto"
                        else float(args.live_pack))
                cap = min(1.0, float(np.ceil((frac * 1.05 + 0.005) / 0.125)
                                     * 0.125))
                if cap != cfg.render.live_pack_fraction:
                    cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                        cfg.render, live_pack_fraction=cap))
            # on a mesh the pack's band count rounds up to the world size
            # (whole packed bands stripe over the ranks)
            live_pack = (tiled.frame_live_pack(scene, cfg, band,
                                               multiple_of=n_dev)
                         if banded and cfg.render.live_pack_fraction > 0.0
                         else None)
            if mesh is not None and banded:
                cfg = _probe_caps(args, scene, cfg, mesh, band, live_pack,
                                  r0)
        gen = _generator(dev, args.seed * 31 + i)
        # --train-every N: the train step every Nth frame, and the bake
        # never on a frame that did not train
        do_train = i % max(args.train_every, 1) == 0
        rebake = baked is None or (do_train
                                   and i % max(args.bake_every, 1) == 0)
        if mesh is not None and banded:
            if do_train:
                state, img, mse, baked2 = dp.dp_train_banded_frame(
                    state, scene, gen, cfg, mesh, band_rows=band,
                    env_rgb=env_rgb, baked=None if rebake else baked,
                    pack=live_pack)
                if rebake:
                    baked = baked2
            elif live_pack is not None:
                img = dp.dp_render_banded_packed(
                    state, scene, gen, cfg, mesh, band_rows=band,
                    env_rgb=env_rgb, baked=baked, pack=live_pack)
            else:
                img = dp.dp_render_banded(state, scene, gen, cfg, mesh,
                                          band_rows=band, env_rgb=env_rgb,
                                          baked=baked)
        elif mesh is not None:
            state, img, mse = dp.dp_frame_step(state, scene, gen, cfg, mesh,
                                               train=do_train)
        elif banded:
            if do_train:
                state, mse = frame_mod.train_only_step(state, scene, gen,
                                                       cfg)
            if rebake:
                baked = nrc.bake(state, cfg)
            img = tiled.render_banded(state, scene, gen, cfg, band_rows=band,
                                      env_rgb=env_rgb, baked=baked,
                                      pack=live_pack)
        else:
            state, out = frame_mod.frame_step(state, scene, gen, cfg,
                                              train=do_train)
            img = out.image
            if do_train:  # no-train frames report 0, not a real loss
                mse = out.mse
        accum = accum + img.reshape(accum.shape)
        n_accum += 1
        # metrics land once per sync window: between syncs the host only
        # enqueues, so the window's average over the hard sync is the rate
        if (i % max(args.sync_every, 1) == args.sync_every - 1
                or i == args.frames - 1):
            _sync(dev)
            frames_w = i + 1 - win_i
            dt_w = (time.perf_counter() - win_t0) / frames_w
            mse_f = float(mse)
            log.log(i, mse=mse_f, frame_s=dt_w, frames=frames_w,
                    mrays_s=args.width * args.height / dt_w / 1e6,
                    **_peak(dev))
            r0.print(f"frame {i}: {dt_w:.3f}s/frame mse={mse_f:.5f}")
            win_t0, win_i = time.perf_counter(), i + 1
    if r0.on:
        _save_frame(args.out, "progressive", accum / n_accum)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="neuralradiancecaching_tpu_torch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("mnist", help="BASELINE config 1")
    _common(sp)
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--limit", type=int, default=10000)
    sp.set_defaults(fn=cmd_mnist)

    sp = sub.add_parser("image-fit", help="BASELINE config 2")
    _common(sp)
    sp.add_argument("--steps", type=int, default=500)
    sp.set_defaults(fn=cmd_image_fit)

    sp = sub.add_parser("pathtrace", help="BASELINE config 3 (cache off)")
    _common(sp)
    sp.add_argument("--width", type=int, default=800)
    sp.add_argument("--height", type=int, default=800)
    sp.add_argument("--spp", type=int, default=1)
    sp.add_argument("--sampler", type=str, default="reference",
                    choices=["reference", "collision", "delta"],
                    help="distance sampler: reference march, baked "
                         "collision field (fast), or unbiased delta "
                         "tracking (ground truth)")
    sp.set_defaults(fn=cmd_pathtrace)

    sp = sub.add_parser("nrc-online", help="BASELINE config 4")
    _common(sp)
    sp.add_argument("--width", type=int, default=800)
    sp.add_argument("--height", type=int, default=800)
    sp.add_argument("--frames", type=int, default=8)
    sp.add_argument("--checkpoint", type=str, default=None)
    sp.add_argument("--resume", type=str, default=None)
    sp.add_argument("--mesh", type=str, default="off",
                    help="data-parallel mesh: off | auto (all devices) | N")
    sp.add_argument("--sampler", type=str, default=None,
                    choices=["reference", "collision", "delta"],
                    help="distance sampler override (delta = unbiased "
                         "ground truth for parity runs)")
    sp.set_defaults(fn=cmd_nrc_online)

    sp = sub.add_parser("progressive", help="BASELINE config 5 (1080p)")
    _common(sp)
    sp.add_argument("--width", type=int, default=1920)
    sp.add_argument("--height", type=int, default=1080)
    sp.add_argument("--frames", type=int, default=4)
    sp.add_argument("--move-every", dest="move_every", type=int, default=4,
                    help="camera orbit step interval (frames)")
    sp.add_argument("--bake-every", dest="bake_every", type=int, default=4,
                    help="oct rebake interval (frames); cache drift per "
                         "frame is tiny at production lr")
    sp.add_argument("--train-every", dest="train_every", type=int, default=1,
                    help="train-step interval (frames): 1 trains every "
                         "frame like the reference (main.cpp:181-246); N>1 "
                         "amortizes the train step over N frames for "
                         "interactive rates (pair with --bake-every)")
    sp.add_argument("--sync-every", dest="sync_every", type=int, default=4,
                    help="host sync interval (frames); the host enqueues "
                         "K frames ahead between syncs")
    sp.add_argument("--mesh", type=str, default="off",
                    help="data-parallel mesh: off | auto (all devices) | N")
    sp.add_argument("--sampler", type=str, default=None,
                    choices=["reference", "collision", "delta"],
                    help="distance sampler override (delta = unbiased "
                         "batched Woodcock; runs the same deferred "
                         "production pipeline)")
    sp.add_argument("--probe-caps", dest="probe_caps", type=str,
                    default="auto", choices=["auto", "off", "uncapped"],
                    help="per-shard cap probing on a mesh: auto probes "
                         "every shard's query/event fractions at each pose "
                         "and sizes the caps to the worst shard (drop-free "
                         "by construction, parallel.probe_dp_caps); off "
                         "keeps config defaults; uncapped disables "
                         "compaction caps (drop-free oracle for tests)")
    sp.add_argument("--band-rows", dest="band_rows", type=int, default=0,
                    help="override the banded-render row height (0 = auto; "
                         "height must divide n_dev * rows)")
    sp.add_argument("--live-pack", dest="live_pack", type=str,
                    default="auto",
                    help="frame-global live-ray packing: auto (probe the "
                         "exact pose-static live fraction, drop-free), a "
                         "fraction, or off. Banded deferred pipelines only")
    sp.set_defaults(fn=cmd_progressive)

    args = p.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        p.error("no CUDA device is available; pass --device cpu to run on "
                "the CPU")
    try:
        args.fn(args)
    finally:
        if getattr(args, "mesh", "off") != "off":
            mesh_mod.close_mesh()


if __name__ == "__main__":
    main()
