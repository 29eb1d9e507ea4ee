"""The per-frame render step of the serving path.

Counterpart of ``neuralradiancecaching_tpu/render/frame.py``'s
``render_only_step``: primary rays, the oct bake of the current hash table,
and the path-traced render with the cache query. The train step
(``frame_step``) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from neuralradiancecaching_tpu.config import NRCConfig
from neuralradiancecaching_tpu_torch.models import nrc
from neuralradiancecaching_tpu_torch.render import pathtrace
from neuralradiancecaching_tpu_torch.scene.camera import pixel_rays
from neuralradiancecaching_tpu_torch.scene.scene import Scene


def render_only_step(state: nrc.NRCState, scene: Scene,
                     generator: Optional[torch.Generator], cfg: NRCConfig,
                     uniforms: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Render one frame from the current cache: (H, W, 3) linear radiance.
    ``uniforms`` replaces the walk's draw from ``generator``
    (render/pathtrace.py)."""
    ro, rd = pixel_rays(scene.camera, cfg.render.width, cfg.render.height)
    baked = nrc.bake(state, cfg)
    query_fn = nrc.make_baked_query_fn(state, baked, cfg)
    rgb, _ = pathtrace.render_image(scene, cfg, ro, rd, generator,
                                    query_fn=query_fn, uniforms=uniforms)
    return rgb.reshape(cfg.render.height, cfg.render.width, 3)
