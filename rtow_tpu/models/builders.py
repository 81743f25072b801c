"""Scene builders: the procedural cover scene, the OBJ mesh scene, and the
small config-ladder scenes used by tests/benchmarks (BASELINE.json).

``cover_scene`` replicates the *distribution* of the reference's
``lots_of_balls`` (reference src/main.cpp:23-83): same grid, same material
mix probabilities, same parameter ranges, same three hero spheres.  Exact
RNG-stream equality with the reference's default-seeded mt19937 is out of
scope (SURVEY.md §7); we use an explicit numpy PCG64 seed, so images are
compared statistically/converged rather than bitwise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import Config
from ..utils.dtypes import REAL
from ..utils.obj import load_obj
from .camera import Camera, make_camera
from .scene import Scene, SceneBuilder


def cover_scene(cfg: Config, dtype=REAL) -> Tuple[Scene, Camera]:
    """The book-cover ball field (reference src/main.cpp:23-83)."""
    rng = np.random.default_rng(cfg.seed)
    u = lambda lo=0.0, hi=1.0: float(rng.uniform(lo, hi))
    u3 = lambda lo=0.0, hi=1.0: rng.uniform(lo, hi, size=3)

    cam = make_camera(
        lookfrom=(13.0, 2.0, 3.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        fov_degrees=20.0,
        aspect_ratio=cfg.aspect_ratio,
        aperture=0.1,
        focus_dist=10.0,
        t0=0.0,
        t1=1.0,
        dtype=dtype,
    )

    b = SceneBuilder()
    if getattr(cfg, "checker_ground", False):
        # Book 2's opening change to the cover: a checkered ground
        # sphere (no reference counterpart — it stops at book 1).
        ground = b.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=3.2)
    else:
        ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, ground)

    n = cfg.number_of_balls_sqrt
    for a in range(-n, n):
        for bb in range(-n, n):
            choose_mat = u()
            center = np.array([a + 0.9 * u(), 0.2, bb + 0.9 * u()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = u3() * u3()
                mat = b.add_lambertian(albedo)
                if cfg.moving_spheres:
                    center2 = center + np.array([0.0, u(0.0, 0.5), 0.0])
                    b.add_moving_sphere(center, center2, 0.2, mat)
                else:
                    b.add_sphere(center, 0.2, mat)
            elif choose_mat < 0.95:
                mat = b.add_metal(u3(0.5, 1.0), u(0.0, 0.5))
                b.add_sphere(center, 0.2, mat)
            else:
                mat = b.add_dielectric(1.5)
                b.add_sphere(center, 0.2, mat)

    glass = b.add_dielectric(1.5)
    reddish = b.add_lambertian((0.4, 0.2, 0.1))
    reddish_metal = b.add_metal((0.7, 0.6, 0.5))
    b.add_sphere((0.0, 1.0, 0.0), 1.0, glass)
    b.add_sphere((-4.0, 1.0, 0.0), 1.0, reddish)
    b.add_sphere((4.0, 1.0, 0.0), 1.0, reddish_metal)
    return b.build(dtype), cam


def mesh_scene(cfg: Config, dtype=REAL) -> Tuple[Scene, Camera]:
    """OBJ mesh under one gray Lambertian (reference ``foo``,
    src/main.cpp:85-136)."""
    if not cfg.model:
        raise ValueError("mesh_scene requires cfg.model (OBJ path)")
    cam = make_camera(
        lookfrom=(1.0, 0.0, -1.0),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        fov_degrees=35.0,
        aspect_ratio=cfg.aspect_ratio,
        aperture=0.01,
        focus_dist=None,
        t0=0.0,
        t1=1.0,
        dtype=dtype,
    )
    b = SceneBuilder()
    gray = b.add_lambertian((0.5, 0.5, 0.5))
    tris = load_obj(cfg.model)
    b.add_mesh(tris, gray)
    return b.build(dtype), cam


def one_sphere_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL) -> Tuple[Scene, Camera]:
    """BASELINE config (a): one Lambertian sphere + ground."""
    cam = make_camera(
        lookfrom=(0.0, 0.0, 0.0),
        lookat=(0.0, 0.0, -1.0),
        fov_degrees=90.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=1.0,
        dtype=dtype,
    )
    b = SceneBuilder()
    mat = b.add_lambertian((0.5, 0.5, 0.5))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, mat)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    return b.build(dtype), cam


def three_sphere_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL) -> Tuple[Scene, Camera]:
    """BASELINE config (b): lambertian/metal/dielectric trio with a
    defocus-blur camera."""
    cam = make_camera(
        lookfrom=(3.0, 3.0, 2.0),
        lookat=(0.0, 0.0, -1.0),
        fov_degrees=20.0,
        aspect_ratio=aspect_ratio,
        aperture=0.3,
        focus_dist=None,  # defaults to look distance
        dtype=dtype,
    )
    b = SceneBuilder()
    ground = b.add_lambertian((0.8, 0.8, 0.0))
    center = b.add_lambertian((0.1, 0.2, 0.5))
    left = b.add_dielectric(1.5)
    right = b.add_metal((0.8, 0.6, 0.2), 0.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, center)
    b.add_sphere((-1.0, 0.0, -1.0), 0.5, left)
    b.add_sphere((-1.0, 0.0, -1.0), -0.45, left)  # hollow-glass trick
    b.add_sphere((1.0, 0.0, -1.0), 0.5, right)
    return b.build(dtype), cam


def light_scene(aspect_ratio: float = 16.0 / 9.0, dtype=REAL) -> Tuple[Scene, Camera]:
    """Emissive-material demo: two area lights over a dark ground, black
    background — the "rest of your life" extension past the reference's
    sky-only lighting (SceneBuilder.add_light)."""
    cam = make_camera(
        lookfrom=(6.0, 2.0, 4.0),
        lookat=(0.0, 0.8, 0.0),
        fov_degrees=30.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=None,
        dtype=dtype,
    )
    b = SceneBuilder()
    ground = b.add_lambertian((0.4, 0.4, 0.4))
    red = b.add_lambertian((0.65, 0.1, 0.1))
    mirror = b.add_metal((0.9, 0.9, 0.9), 0.02)
    lamp = b.add_light((6.0, 5.5, 4.5))  # warm, intensity > 1
    glow = b.add_light((1.0, 2.0, 6.0))  # cool accent
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((0.0, 0.8, 0.0), 0.8, red)
    b.add_sphere((-1.8, 0.6, 0.8), 0.6, mirror)
    b.add_sphere((1.4, 2.6, -1.0), 0.5, lamp)
    b.add_sphere((2.2, 0.35, 1.2), 0.35, glow)
    return b.build(dtype, background=(0.0, 0.0, 0.0)), cam


def textures_scene(aspect_ratio: float = 1.5, dtype=REAL) -> Tuple[Scene, Camera]:
    """Procedural-texture demo (book 2's texture chapters; no reference
    counterpart — it stops at book 1): checkered ground, a marble
    (hash value-noise) sphere, and a near-mirror metal sphere that
    reflects both.  Rendered as ``samples/textures.png``."""
    cam = make_camera(
        lookfrom=(0.0, 1.2, 3.2),
        lookat=(0.0, 0.4, 0.0),
        fov_degrees=40.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=3.2,
        dtype=dtype,
    )
    b = SceneBuilder()
    ground = b.add_checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9), scale=6.0)
    marble = b.add_noise((0.92, 0.92, 0.92), (0.25, 0.1, 0.05), scale=3.0)
    mirror = b.add_metal((0.85, 0.85, 0.9), 0.03)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((-0.7, 0.55, 0.0), 0.55, marble)
    b.add_sphere((0.75, 0.45, 0.6), 0.45, mirror)
    return b.build(dtype), cam


def cornell_scene(aspect_ratio: float = 1.0, dtype=REAL) -> Tuple[Scene, Camera]:
    """Cornell box: emissive TRIANGLES (ceiling area light), colored
    walls, a mirror sphere and the classic tall rotated box (book 2's
    rotate_y/translate instances, baked into the vertex table by
    ``SceneBuilder.add_box``) — the classic global-illumination test,
    beyond the reference's scope (sky-only lighting, no quads).

    Walls are triangle pairs wound so face normals point INTO the box
    (the renderer keeps the reference's backface cull, det >= 1e-6 — see
    reference src/common-model.cpp:104-125 — so interior rays
    always approach from the front side)."""
    cam = make_camera(
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        fov_degrees=40.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=10.0,
        dtype=dtype,
    )
    b = SceneBuilder()
    white = b.add_lambertian((0.73, 0.73, 0.73))
    red = b.add_lambertian((0.65, 0.05, 0.05))
    green = b.add_lambertian((0.12, 0.45, 0.15))
    lamp = b.add_light((15.0, 15.0, 15.0))
    mirror = b.add_metal((0.95, 0.95, 0.95), 0.0)

    quad = b.add_quad  # corners CCW as seen from the normal side
    s = 555.0
    # Floor (normal +y), ceiling (normal -y), back wall (normal -z,
    # toward the camera); x=s is image-LEFT from this camera (+x left
    # when looking along +z with y up) -> red wall at x=s, green at
    # x=0: the classic red-left/green-right Cornell orientation.
    # (Windings verified numerically: cross(e1, e2) points inward.)
    quad((0, 0, s), (s, 0, s), (s, 0, 0), (0, 0, 0), white)
    quad((s, s, 0), (s, s, s), (0, s, s), (0, s, 0), white)
    quad((0, s, s), (s, s, s), (s, 0, s), (0, 0, s), white)
    quad((s, 0, s), (s, s, s), (s, s, 0), (s, 0, 0), red)
    quad((0, s, 0), (0, s, s), (0, 0, s), (0, 0, 0), green)
    # Ceiling light: a 130x105 emissive quad slightly below the ceiling.
    quad((343, s - 1, 227), (343, s - 1, 332), (213, s - 1, 332),
         (213, s - 1, 227), lamp)
    b.add_sphere((190.0, 90.0, 190.0), 90.0, mirror)
    # The book's tall box (165x330x165, rotated 15 deg) — instanced by
    # the build-time vertex bake, not per-ray inverse transforms.
    b.add_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white,
              rotate_y=15.0, translate=(265.0, 0.0, 295.0))
    return b.build(dtype, background=(0.0, 0.0, 0.0)), cam


def make_earth_texture(height: int = 256, seed: int = 7) -> np.ndarray:
    """Procedural (H, 2H, 3) earth-like equirectangular texture: fBm
    value-noise continents over ocean, polar caps.  The book ships
    earthmap.jpg; this repo has no binary assets, so the globe demo
    generates one deterministically."""
    h, w = height, 2 * height
    rng = np.random.default_rng(seed)
    # fBm: 4 octaves of smooth noise, built by upsampling coarse grids.
    acc = np.zeros((h, w))
    for octave, cells in enumerate((8, 16, 32, 64)):
        grid = rng.standard_normal((cells + 1, 2 * cells + 1))
        ys = np.linspace(0, cells, h, endpoint=False)
        xs = np.linspace(0, 2 * cells, w, endpoint=False)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        g = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
             + grid[y0][:, x0 + 1] * (1 - fy) * fx
             + grid[y0 + 1][:, x0] * fy * (1 - fx)
             + grid[y0 + 1][:, x0 + 1] * fy * fx)
        acc += g * (0.5 ** octave)
    land = acc > 0.25
    lat = np.abs(np.linspace(-1.0, 1.0, h))[:, None]  # 1 at poles
    img = np.empty((h, w, 3))
    img[..., 0] = np.where(land, 0.35 + 0.25 * acc.clip(0, 1), 0.05)
    img[..., 1] = np.where(land, 0.45 + 0.20 * acc.clip(0, 1), 0.15)
    img[..., 2] = np.where(land, 0.25, 0.45 + 0.2 * (1 - lat))
    ice = np.broadcast_to(lat > 0.92, (h, w))
    img[ice] = 0.9
    return img.clip(0.0, 1.0)


def globe_scene(aspect_ratio: float = 1.5, dtype=REAL) -> Tuple[Scene, Camera]:
    """Image-texture demo (book 2 ch. 4.3's earth globe): a textured
    sphere over a gray ground, sky-lit.  JNP path only — texel lookups
    are gathers (see models/scene.py IMAGE)."""
    cam = make_camera(
        lookfrom=(0.0, 1.6, 6.0),
        lookat=(0.0, 1.0, 0.0),
        fov_degrees=32.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=6.0,
        dtype=dtype,
    )
    b = SceneBuilder()
    ground = b.add_lambertian((0.6, 0.6, 0.6))
    earth = b.add_image(make_earth_texture())
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((0.0, 1.1, 0.0), 1.1, earth)
    return b.build(dtype), cam


def smoke_scene(aspect_ratio: float = 1.0, dtype=REAL) -> Tuple[Scene, Camera]:
    """Cornell smoke (book 2 ch. 9's closing scene): the box interior
    with two constant-density media in place of the solid boxes — dark
    smoke in the tall box (rotate_y 15), white fog in the short one
    (rotate_y -18), the book's exact instance transforms (medium
    boundaries stay analytic: rays are inverse-rotated per volume)."""
    cam = make_camera(
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        fov_degrees=40.0,
        aspect_ratio=aspect_ratio,
        aperture=0.0,
        focus_dist=10.0,
        dtype=dtype,
    )
    b = SceneBuilder()
    white = b.add_lambertian((0.73, 0.73, 0.73))
    red = b.add_lambertian((0.65, 0.05, 0.05))
    green = b.add_lambertian((0.12, 0.45, 0.15))
    lamp = b.add_light((7.0, 7.0, 7.0))
    s = 555.0
    quad = b.add_quad
    quad((0, 0, s), (s, 0, s), (s, 0, 0), (0, 0, 0), white)
    quad((s, s, 0), (s, s, s), (0, s, s), (0, s, 0), white)
    quad((0, s, s), (s, s, s), (s, 0, s), (0, 0, s), white)
    quad((s, 0, s), (s, s, s), (s, s, 0), (s, 0, 0), red)
    quad((0, s, 0), (0, s, s), (0, 0, s), (0, 0, 0), green)
    # Bigger light than the solid Cornell: fog eats most paths.
    quad((443, s - 1, 127), (443, s - 1, 432), (113, s - 1, 432),
         (113, s - 1, 127), lamp)
    b.add_fog_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 0.01,
                  albedo=(0.0, 0.0, 0.0), rotate_y=15.0,
                  translate=(265.0, 0.0, 295.0))
    b.add_fog_box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), 0.01,
                  albedo=(1.0, 1.0, 1.0), rotate_y=-18.0,
                  translate=(130.0, 0.0, 65.0))
    return b.build(dtype, background=(0.0, 0.0, 0.0)), cam


def scene_for_config(cfg: Config, dtype=REAL) -> Tuple[Scene, Camera]:
    """CLI dispatch mirroring reference main.cpp:165-169 (plus the
    --lights/--cornell demos, which have no reference counterpart)."""
    if getattr(cfg, "lights_demo", False):
        return light_scene(cfg.aspect_ratio, dtype)
    if getattr(cfg, "cornell_demo", False):
        return cornell_scene(cfg.aspect_ratio, dtype)
    if getattr(cfg, "textures_demo", False):
        return textures_scene(cfg.aspect_ratio, dtype)
    if getattr(cfg, "smoke_demo", False):
        return smoke_scene(cfg.aspect_ratio, dtype)
    if getattr(cfg, "globe_demo", False):
        return globe_scene(cfg.aspect_ratio, dtype)
    if cfg.model:
        return mesh_scene(cfg, dtype)
    return cover_scene(cfg, dtype)
