"""rtow_tpu — a differentiable path tracer in JAX.

A from-scratch JAX/XLA re-design of joaotavora/raytracing-one-weekend
(C++ CPU path tracer): SoA scenes, counter-based RNG, a wavefront bounce
loop instead of recursion, mesh-sharded rendering via shard_map, and
reverse-mode gradients w.r.t. scene geometry and materials.
"""
import os as _os

import jax as _jax

#: Persistent compilation cache used when neither ``JAX_COMPILATION_CACHE_DIR``
#: nor an embedder names one: one fixed directory inside the checkout (the
#: path is part of the cache key, so it must not move between runs).
DEFAULT_COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)

# The bounce loops take seconds to minutes to compile; cache them across
# processes.  JAX reads JAX_COMPILATION_CACHE_DIR itself.
if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", DEFAULT_COMPILE_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5)

from .config import Config
from .models.builders import (
    cover_scene,
    mesh_scene,
    one_sphere_scene,
    scene_for_config,
    three_sphere_scene,
)
from .models.camera import Camera, Rays, camera_rays, make_camera
from .models.scene import Scene, SceneBuilder
from .render import render

__version__ = "0.1.0"

__all__ = [
    "Config",
    "Camera",
    "Rays",
    "Scene",
    "SceneBuilder",
    "camera_rays",
    "cover_scene",
    "make_camera",
    "mesh_scene",
    "one_sphere_scene",
    "render",
    "scene_for_config",
    "three_sphere_scene",
]
