"""One rank of a data-parallel job: run a list of SPMD steps, save the
results.

    python -m neuralradiancecaching_tpu_torch.parallel.job JOB OUT_DIR \\
        [--device cpu|cuda|cuda:N] [--backend gloo|nccl]

Run as every rank of a group (``torchrun``, or :func:`.mesh.spawn`). JOB is
a ``torch.save`` file of a dict: ``density`` and ``env`` (numpy arrays) and
``steps``, a list of dicts, each with ``name``, ``fn`` (a function of
:mod:`.data_parallel` taking (state, scene, generator, cfg, mesh, ...)),
``cfg`` (the port's NRCConfig), ``state`` (``models.nrc.state_from_numpy``
input), ``camera`` ((position, view_dir) or None: the config's camera),
``seed`` (a generator seed, or None for the steps that take all their
draws) and ``kwargs`` (tensors anywhere inside go to the rank's device).
Scenes are baked once per (cfg, camera). Each rank writes
``OUT_DIR/rank<r>.pt``: {name: the step's outputs on the CPU, an NRCState
as a dict of its fields}.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import torch

from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.parallel import data_parallel
from neuralradiancecaching_tpu_torch.parallel.mesh import close_mesh, make_mesh
from neuralradiancecaching_tpu_torch.scene import camera as cam_mod
from neuralradiancecaching_tpu_torch.scene.scene import make_scene


def to_device(x, device):
    """x with every tensor inside (tuples, named tuples, lists, dicts) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [to_device(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, nrc.NRCState):
        return {f.name: to_device(getattr(x, f.name), device)
                for f in dataclasses.fields(x)}
    return x


def run(job: dict, mesh) -> dict:
    """Every step of ``job`` on this rank; the outputs on the CPU."""
    dev = mesh.device
    scenes, out = {}, {}
    for step in job["steps"]:
        cfg, cam = step["cfg"], step.get("camera")
        key = (cfg, None if cam is None else tuple(map(tuple, cam)))
        if key not in scenes:
            scene = make_scene(cfg, job["density"], job["env"], device=dev)
            if cam is not None:
                scene = dataclasses.replace(scene, camera=cam_mod.make_camera(
                    cfg.camera, dev, *cam))
            scenes[key] = scene
        state = nrc.state_from_numpy(step["state"], dev)
        gen = (None if step.get("seed") is None
               else torch.Generator(dev).manual_seed(step["seed"]))
        fn = getattr(data_parallel, step["fn"])
        res = fn(state, scenes[key], gen, cfg, mesh,
                 **to_device(step.get("kwargs", {}), dev))
        out[step["name"]] = to_device(res, "cpu")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="neuralradiancecaching_tpu_torch."
                                "parallel.job")
    p.add_argument("job")
    p.add_argument("out_dir")
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    mesh = make_mesh(device=args.device, backend=args.backend)
    try:
        job = torch.load(args.job, weights_only=False)
        out = run(job, mesh)
        torch.save(out, Path(args.out_dir) / f"rank{mesh.rank}.pt")
    finally:
        close_mesh()
    return 0


if __name__ == "__main__":
    sys.exit(main())
