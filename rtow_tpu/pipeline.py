"""Render dispatch: the one place that picks how a frame is rendered.

Two decisions, both from the scene and the Config: the nearest-hit
search (stackless BVH for meshes, the fused brute-force sweep
otherwise) and the layout (one device, or a (tile, spp) device mesh).
Keeps `render.py` (the scheduler) free of policy.
"""
from __future__ import annotations

import sys

import numpy as np

from .config import Config
from .models.camera import Camera
from .models.scene import Scene
from .render import render


def pick_nearest_hit(scene: Scene, cfg: Config):
    """Choose the nearest-hit implementation for this scene/config."""
    if cfg.use_bvh and scene.n_triangles > 64:
        from .ops import bvh

        nearest = bvh.make_nearest_hit(scene)
        if cfg.verbose:
            from .utils.profiling import bvh_quality

            built = bvh.build_bvh(scene)
            print(f"BVH quality (stupid_volume): {bvh_quality(built):.3f}",
                  file=sys.stderr)
        return nearest
    return None  # integrator defaults to the fused brute-force sweep


def render_auto(
    scene: Scene,
    camera: Camera,
    cfg: Config,
    key=None,
    progress: bool = False,
) -> np.ndarray:
    """Render the mean-radiance image (H, W, 3): sharded over
    ``cfg.n_devices`` devices when more than one is asked for and
    present, on the default device otherwise."""
    import jax

    from .utils.profiling import trace_profile

    nearest = pick_nearest_hit(scene, cfg)
    with trace_profile(cfg.profile_dir):
        if cfg.n_devices > 1 and len(jax.devices()) > 1:
            from .parallel.sharded import render_sharded

            return render_sharded(scene, camera, cfg, key=key,
                                  nearest_hit=nearest, progress=progress)
        return render(scene, camera, cfg, key=key, nearest_hit=nearest,
                      progress=progress)
