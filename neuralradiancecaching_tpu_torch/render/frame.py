"""The per-frame step: train batch -> train step -> render.

Counterpart of ``neuralradiancecaching_tpu/render/frame.py``: the online
frame ``frame_step`` (one online training pass -- train batch, gradients,
both optimizer steps -- then the render from the updated cache), the
``train_only_step`` of warm-up loops and the serving ``render_only_step``
(primary rays, the oct bake of the current hash table and the path-traced
render with the cache query). Where the JAX frame is one jitted program,
these run eagerly on the device of the scene.

Randomness: each step draws from ``generator`` unless the caller hands in
the draws -- ``train_uniforms`` (render/targets.py:TrainUniforms) for the
train batch and ``uniforms`` for the render walk (render/pathtrace.py).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

from neuralradiancecaching_tpu_torch.config import NRCConfig
from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.render import pathtrace, targets
from neuralradiancecaching_tpu_torch.scene.camera import pixel_rays
from neuralradiancecaching_tpu_torch.scene.scene import Scene
from neuralradiancecaching_tpu_torch.utils import profiling


class FrameOutput(NamedTuple):
    image: torch.Tensor  # (H, W, 3)
    mse: torch.Tensor    # scalar train-loss stat (nrcStats.mseLoss)


@profiling.spanned("train")
def train_only_step(state: nrc.NRCState, scene: Scene,
                    generator: Optional[torch.Generator], cfg: NRCConfig,
                    train_uniforms: Optional[targets.TrainUniforms] = None
                    ) -> Tuple[nrc.NRCState, torch.Tensor]:
    """One online training pass without a render: (new state, mse)."""
    batch = targets.generate_train_batch(scene, cfg, generator,
                                         train_uniforms)
    return nrc.train_step(state, batch.pos, batch.dir, batch.target, cfg)


def frame_step(state: nrc.NRCState, scene: Scene,
               generator: Optional[torch.Generator], cfg: NRCConfig,
               train: bool = True,
               train_uniforms: Optional[targets.TrainUniforms] = None,
               uniforms=None,
               timings: dict[str, float] | None = None
               ) -> Tuple[nrc.NRCState, FrameOutput]:
    """One frame: (optionally) one online training pass, then the render
    from the updated cache. The image is row-major (H, W, 3) linear
    radiance; mse is 0 without training.

    timings: when given, receives the synchronized seconds of the two
    halves under "train" and "render" (a device sync between them)."""
    device = scene.camera.position.device

    def mark():
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = mark()
    mse = torch.zeros((), dtype=torch.float32, device=device)
    if train:
        state, mse = train_only_step(state, scene, generator, cfg,
                                     train_uniforms)
    t1 = mark()
    image = render_only_step(state, scene, generator, cfg, uniforms)
    if timings is not None:
        timings["train"], timings["render"] = t1 - t0, mark() - t1
    return state, FrameOutput(image=image, mse=mse)


@profiling.spanned("render")
def render_only_step(state: nrc.NRCState, scene: Scene,
                     generator: Optional[torch.Generator], cfg: NRCConfig,
                     uniforms=None) -> torch.Tensor:
    """Render one frame from the current cache: (H, W, 3) linear radiance.
    Without the cache (``render.use_nn`` off) neither the bake nor the
    query runs -- the JAX program drops them as dead code. ``uniforms``
    replaces the walk's draws from ``generator`` (what
    ``pathtrace.render_image`` takes)."""
    ro, rd = pixel_rays(scene.camera, cfg.render.width, cfg.render.height)
    query_fn = None
    if cfg.render.use_nn:
        baked = nrc.bake(state, cfg)
        query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    rgb, _ = pathtrace.render_image(scene, cfg, ro, rd, generator,
                                    query_fn=query_fn, uniforms=uniforms)
    return rgb.reshape(cfg.render.height, cfg.render.width, 3)
