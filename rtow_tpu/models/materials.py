"""Branchless material scatter over whole ray wavefronts.

The reference dispatches ``Material::scatter`` through a virtual call per
hit (reference src/common-model.h:115-121) and each concrete material
draws from the global RNG.  Over a wavefront, divergent per-lane
dispatch is the enemy: with only three material kinds it is cheaper to
evaluate *all* scatter rules on every live lane and ``select`` by the
hit's material kind.  One shared unit-vector draw serves lambertian diffusion, metal
fuzz and dielectric fuzz (each reference material draws exactly one unit
vector per scatter, so the per-lane draw count matches).

Behavioral parity notes:
 * Metal reflects the *unnormalised* incoming direction and never checks
   the below-horizon case — exactly like the reference
   (src/common-model.cpp:24-31, SURVEY.md quirks ledger: "match").
 * Dielectric: Schlick reflectance vs a uniform draw, total internal
   reflection, the non-book ``fuzz`` extension, attenuation (1,1,1)
   (src/common-model.cpp:40-62).
 * Lambertian degenerate direction (random unit vector ≈ -normal):
   the book substitutes the normal; the reference instead absorbs when
   the draw ≈ +normal (src/common-model.cpp:16-18).  Both are
   probability-zero events for true unit vectors; we take the book's
   NaN-free substitution (documented divergence).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import vec
from ..utils import rng
from .scene import CHECKER, DIELECTRIC, EMISSIVE, METAL, NOISE


class HitRecord(NamedTuple):
    """Flat per-lane hit info (the reference's Hit + material params,
    src/common-model.h:40-57, gathered from the SoA tables)."""

    t: jax.Array  # (L,)
    hit: jax.Array  # (L,) bool
    point: jax.Array  # (L, 3)
    normal: jax.Array  # (L, 3) unit, flipped to face the ray
    front: jax.Array  # (L,) bool
    mat_kind: jax.Array  # (L,) int32
    albedo: jax.Array  # (L, 3)
    fuzz: jax.Array  # (L,)
    ir: jax.Array  # (L,)


class ScatterResult(NamedTuple):
    direction: jax.Array  # (L, 3) new ray direction
    attenuation: jax.Array  # (L, 3)


def schlick(cosine: jax.Array, ref_idx: jax.Array) -> jax.Array:
    """Schlick's reflectance approximation (src/common-model.cpp:33-38)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)


def scatter(key: jax.Array, in_direction: jax.Array, rec: HitRecord) -> ScatterResult:
    """Evaluate every material rule and select by ``rec.mat_kind``.

    ``in_direction`` is the incoming (unnormalised) ray direction.
    Returns the scattered direction and per-lane attenuation.
    """
    dtype = in_direction.dtype
    k_unit, k_choice = jax.random.split(key)
    unit = rng.unit_vectors(k_unit, rec.t.shape, dtype=dtype)  # (L, 3)
    n = rec.normal

    # --- Lambertian: normal + unit vector --------------------------------
    lam_dir = n + unit
    degenerate = vec.length2(lam_dir) < 1e-12
    lam_dir = jnp.where(degenerate[..., None], n, lam_dir)

    # --- Metal: reflect raw direction + fuzz * unit -----------------------
    metal_dir = vec.reflect(in_direction, n) + rec.fuzz[..., None] * unit

    # --- Dielectric: Snell + TIR + Schlick choice + fuzz ------------------
    unit_in = vec.normalize(in_direction)
    cos_theta = jnp.minimum(vec.dot(-unit_in, n), 1.0)
    sin_theta = vec.safe_sqrt(1.0 - cos_theta * cos_theta)
    # ir can be 0 on padded/miss lanes (zero rows of the one-hot param
    # fetch); guard the reciprocal so no inf/NaN leaks into autodiff.
    ir_safe = jnp.where(rec.ir > 0.0, rec.ir, 1.0)
    ratio = jnp.where(rec.front, 1.0 / ir_safe, ir_safe)
    cannot_refract = ratio * sin_theta > 1.0
    reflect_prob = schlick(cos_theta, ratio)
    choice = rng.uniform(k_choice, rec.t.shape, dtype=dtype)
    must_reflect = cannot_refract | (reflect_prob > choice)
    refr = vec.refract(unit_in, n, ratio[..., None])
    refl = vec.reflect(unit_in, n)
    diel_dir = jnp.where(must_reflect[..., None], refl, refr)
    diel_dir = diel_dir + rec.fuzz[..., None] * unit

    # --- select by kind (Lambertian-like kinds are the default branch,
    # so CHECKER — a Lambertian with a point-dependent albedo resolved
    # in hit_record_from — needs no case here) ------------------------
    kind = rec.mat_kind[..., None]
    direction = jnp.where(
        kind == METAL,
        metal_dir,
        jnp.where(kind == DIELECTRIC, diel_dir, lam_dir),
    )
    attenuation = jnp.where(
        kind == DIELECTRIC, jnp.ones_like(rec.albedo), rec.albedo
    )
    return ScatterResult(direction=direction, attenuation=attenuation)


def sky_color(direction: jax.Array) -> jax.Array:
    """Background gradient (reference src/render.cpp:125-128):
    white→(0.5, 0.7, 1.0) lerped on the unit-direction y component."""
    unit = vec.normalize(direction)
    tt = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.asarray([1.0, 1.0, 1.0], dtype=direction.dtype)
    blue = jnp.asarray([0.5, 0.7, 1.0], dtype=direction.dtype)
    return (1.0 - tt)[..., None] * white + tt[..., None] * blue


def background_color(scene, direction: jax.Array) -> jax.Array:
    """Miss radiance: the reference sky gradient, or the scene's static
    flat background color (light-driven scenes pass black)."""
    if scene.background == "sky":
        return sky_color(direction)
    return jnp.broadcast_to(
        jnp.asarray(scene.background, dtype=direction.dtype),
        direction.shape,
    )


def _hash01(xi, yi, zi):
    """Lattice hash -> uniform [0, 1): murmur3-style finalizer over the
    three integer coordinates.  Pure uint32 arithmetic — no permutation
    tables (the book's Perlin noise reads two)."""
    h = (xi.astype(jnp.uint32) * np.uint32(0x9E3779B1)
         ^ yi.astype(jnp.uint32) * np.uint32(0x85EBCA77)
         ^ zi.astype(jnp.uint32) * np.uint32(0xC2B2AE3D))
    h = h ^ (h >> 16)
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * np.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    # Mosaic has no uint32->f32 cast; (h >> 8) < 2^24 fits int32 exactly.
    return ((h >> 8).astype(jnp.int32).astype(jnp.float32)
            * np.float32(1.0 / (1 << 24)))


def value_noise(px, py, pz):
    """Trilinear hash value noise -> [0, 1) (book 2's Perlin analogue)."""
    ix = jnp.floor(px)
    iy = jnp.floor(py)
    iz = jnp.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    # Hermite smoothing (the book's smoothstep fade).
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)
    xi, yi, zi = ix.astype(jnp.int32), iy.astype(jnp.int32), iz.astype(
        jnp.int32)

    def corner(dx, dy, dz):
        return _hash01(xi + dx, yi + dy, zi + dz)

    def lerp(a, b, t):
        return a + (b - a) * t

    c00 = lerp(corner(0, 0, 0), corner(1, 0, 0), ux)
    c10 = lerp(corner(0, 1, 0), corner(1, 1, 0), ux)
    c01 = lerp(corner(0, 0, 1), corner(1, 0, 1), ux)
    c11 = lerp(corner(0, 1, 1), corner(1, 1, 1), ux)
    return lerp(lerp(c00, c10, uy), lerp(c01, c11, uy), uz)


def marble_t(px, py, pz, scale):
    """Marble mix weight in [0, 1]: a z-stripe displaced by 3-octave
    value-noise turbulence (the book's `sin(scale*z + 10*turb)`)."""
    turb = (value_noise(px * scale, py * scale, pz * scale)
            + 0.5 * value_noise(px * scale * 2.0 + 17.0,
                                py * scale * 2.0, pz * scale * 2.0)
            + 0.25 * value_noise(px * scale * 4.0,
                                 py * scale * 4.0 + 31.0,
                                 pz * scale * 4.0)) / 1.75
    return 0.5 * (1.0 + jnp.sin(scale * pz + 10.0 * turb))


def checker_albedo(kind, point, scale, even, odd):
    """Textured albedo: CHECKER picks even/odd by cell parity, NOISE
    lerps even <-> odd by the marble weight; other kinds keep ``even``
    (their ordinary albedo).  ``scale`` rides the ir column."""
    s = scale[..., None] * point
    odd_cell = (jnp.sin(s[..., 0]) * jnp.sin(s[..., 1])
                * jnp.sin(s[..., 2])) < 0.0
    use_odd = (kind == CHECKER) & odd_cell
    out = jnp.where(use_odd[..., None], odd, even)
    is_noise = kind == NOISE
    t = marble_t(point[..., 0], point[..., 1], point[..., 2], scale)
    return jnp.where(is_noise[..., None],
                     even + (odd - even) * t[..., None], out)


def sphere_uv(nx, ny, nz):
    """Equirectangular (u, v) from the outward unit normal (book 2
    ch. 4.4: theta = acos(-y), phi = atan2(-z, x) + pi)."""
    theta = jnp.arccos(jnp.clip(-ny, -1.0, 1.0))
    phi = jnp.arctan2(-nz, nx) + np.pi
    return phi * np.float32(0.5 / np.pi), theta * np.float32(1.0 / np.pi)


def image_albedo(texture, nx, ny, nz):
    """Bilinear texel lookup at the sphere (u, v) -> (..., 3) albedo.

    Per-lane texel fetches are gathers.  The lookup is differentiable
    w.r.t. ``texture`` — the bilinear weights distribute the cotangent
    over the four texels (inverse texture painting)."""
    H, W = texture.shape[0], texture.shape[1]
    u, v = sphere_uv(nx, ny, nz)
    x = u * (W - 1)
    y = (1.0 - v) * (H - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, W - 1)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, H - 1)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    fx = (x - x0.astype(x.dtype))[..., None]
    fy = (y - y0.astype(y.dtype))[..., None]
    t00 = texture[y0, x0]
    t10 = texture[y0, x1]
    t01 = texture[y1, x0]
    t11 = texture[y1, x1]
    top = t00 + (t10 - t00) * fx
    bot = t01 + (t11 - t01) * fx
    return top + (bot - top) * fy


def emitted(rec: HitRecord) -> jax.Array:
    """Per-lane emitted radiance (L, 3): the EMISSIVE material's albedo
    columns hold the emitted color; every other kind emits black.
    Emission needs no scatter budget — it is added on every live hit,
    then the lane terminates (see integrator)."""
    is_emis = (rec.mat_kind == EMISSIVE)[..., None]
    return jnp.where(is_emis, rec.albedo, 0.0)
