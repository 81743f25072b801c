"""Thin-lens camera with defocus blur and a motion-blur shutter.

Same optical model as the reference Camera (reference
src/common-model.cpp:136-167): look-from/look-at/up basis, vertical
field-of-view in degrees, focus plane spanned by ``horizontal``/
``vertical``, aperture jitter in the lens disk, and a ray time sampled
uniformly in the shutter interval [t0, t1].  Instead of one scalar
``get_ray(s, t)`` per call, ``camera_rays`` emits a whole wavefront of
rays from vectorised (s, t) arrays — one fused elementwise pass per batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..utils import rng
from ..utils.dtypes import REAL


class Rays(NamedTuple):
    origin: jax.Array  # (L, 3)
    direction: jax.Array  # (L, 3) NOT normalised (reference keeps raw dirs)
    time: jax.Array  # (L,)


def _camera_pytree(cls):
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_camera_pytree
class Camera:
    origin: jax.Array  # (3,)
    u: jax.Array  # (3,) camera-right
    v: jax.Array  # (3,) camera-up
    w: jax.Array  # (3,) camera-back (view dir = -w)
    horizontal: jax.Array  # (3,) focus-plane x extent
    vertical: jax.Array  # (3,) focus-plane y extent
    lower_left: jax.Array  # (3,) focus-plane corner
    lens_radius: jax.Array  # ()
    t0: jax.Array  # () shutter open
    t1: jax.Array  # () shutter close


def make_camera(
    lookfrom,
    lookat,
    vup=(0.0, 1.0, 0.0),
    fov_degrees: float = 90.0,
    aspect_ratio: float = 16.0 / 9.0,
    aperture: float = 0.0,
    focus_dist: Optional[float] = None,
    t0: float = 0.0,
    t1: float = 0.0,
    dtype=REAL,
) -> Camera:
    """Construct the camera basis (reference src/common-model.cpp:136-154).

    ``focus_dist=None`` defaults to the look distance, as in the reference.
    """
    import numpy as np

    lookfrom = np.asarray(lookfrom, dtype=np.float64)
    lookat = np.asarray(lookat, dtype=np.float64)
    vup = np.asarray(vup, dtype=np.float64)

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    v = v / np.linalg.norm(v)

    viewport_height = 2.0 * math.tan(math.radians(fov_degrees) / 2.0)
    viewport_width = aspect_ratio * viewport_height
    fd = float(focus_dist) if focus_dist is not None else float(np.linalg.norm(lookfrom - lookat))

    horizontal = fd * viewport_width * u
    vertical = fd * viewport_height * v
    lower_left = lookfrom - horizontal / 2.0 - vertical / 2.0 - fd * w

    as_real = lambda x: jnp.asarray(x, dtype=dtype)
    return Camera(
        origin=as_real(lookfrom),
        u=as_real(u),
        v=as_real(v),
        w=as_real(w),
        horizontal=as_real(horizontal),
        vertical=as_real(vertical),
        lower_left=as_real(lower_left),
        lens_radius=as_real(aperture / 2.0),
        t0=as_real(t0),
        t1=as_real(t1),
    )


def camera_rays(cam: Camera, key: jax.Array, s: jax.Array, t: jax.Array) -> Rays:
    """Vectorised ``Camera::get_ray`` (reference src/common-model.cpp:156-167).

    ``s``/``t`` are (L,) viewport coordinates in [0, 1] (already
    pixel-jittered by the caller).  Each ray gets an independent lens-disk
    offset and shutter time.
    """
    dtype = cam.origin.dtype
    k_lens, k_time = jax.random.split(key)
    batch = s.shape

    rd = cam.lens_radius * rng.in_unit_disk(k_lens, batch, dtype=dtype)  # (L, 3)
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v  # (L, 3)

    origin = cam.origin + offset
    direction = (
        cam.lower_left
        + s[..., None] * cam.horizontal
        + t[..., None] * cam.vertical
        - origin
    )
    time = rng.uniform(k_time, batch, dtype=dtype) * (cam.t1 - cam.t0) + cam.t0
    return Rays(origin=origin, direction=direction, time=time)


def pixel_coords(
    image_width: int, image_height: int, key: jax.Array, pixel_ids: jax.Array, dtype=REAL
):
    """Jittered viewport (s, t) for flat pixel ids (row-major, row 0 = top).

    Matches the reference's sampling ``u=(j+rand)/(W-1)``,
    ``v=(from_top+rand)/(H-1)`` (src/render.cpp:157-159).
    """
    row = pixel_ids // image_width
    col = pixel_ids % image_width
    ju = rng.uniform(jax.random.fold_in(key, 0), pixel_ids.shape, dtype=dtype)
    jv = rng.uniform(jax.random.fold_in(key, 1), pixel_ids.shape, dtype=dtype)
    s = (col.astype(dtype) + ju) / (image_width - 1)
    t = ((image_height - 1 - row).astype(dtype) + jv) / (image_height - 1)
    return s, t
