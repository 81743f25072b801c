"""Constant-density participating media (book 2 ch. 9, RTW "smoke").

The book wraps a boundary primitive in a ``constant_medium`` whose
``hit()`` draws a random free-flight distance and fakes a hit inside the
boundary (RTW book 2 ch. 9).  Per-ray virtual dispatch and a stateful
RNG inside ``hit()`` are both poison for a wavefront; here media are a
separate SMALL static table of ANALYTIC boundaries (spheres and
axis-aligned boxes — entry/exit in closed form), sampled once per bounce
AFTER the surface sweep:

 1. the surface sweep finds ``t_surf`` as usual (media are invisible to
    it — no surface, nothing added to the tables),
 2. for each volume (static unroll, <= 8): clip the boundary interval
    [t_in, t_out] against [T_MIN, t_surf],
 3. free-flight ``t_scat = t_in + Exp(sigma) / |d|``; the event stands
    if ``t_scat < t_out``; the nearest event across volumes wins,
 4. a volume event overrides the surface interaction: isotropic scatter
    (uniform unit direction — the same draw the surface path uses),
    throughput *= volume albedo, one bounce of budget consumed.

Estimator notes: sampling ``t`` from sigma*exp(-sigma*s) and continuing
on survival IS the transmittance estimator — no explicit exp() weight
appears (its expectation is exp(-sigma*L), tested analytically).  With
NEE the volume event samples a light too; the isotropic phase pdf is
the constant 1/(4 pi), so the direct term is ``albedo * w * 1/4`` (the
table weight ``w`` folds emit/(pi * pdf) — see ops/lights.py) and the
MIS balance weight uses pdf_B = 1/(4 pi).

All helpers are pure elementwise f32 arithmetic over per-lane component
arrays + scalar reads from a (V, 14) table (like ops/lights.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..models.scene import Scene

#: volume-table rows are (V, 14) f32 (the light rows' width):
#: sphere ("s"): 0-2 center, 3 radius
#: box ("b"):    0-2 min corner, 3-5 max corner
#: rotated box ("r"): 0-5 LOCAL min/max, 7 rotate_y radians,
#:                    11-13 translation (world = R(angle) @ local + T)
#: 6 density, 8-10 scatter albedo.
MAX_VOLUMES = 8

_BIG = np.float32(1e30)


def build_volume_table(scene: Scene):
    """(V, 14) geometry/density/albedo rows (layout above) + the (V, 3)
    albedo view, from the scene's traced leaves (same
    re-derive-every-trace scheme as ops/lights.build_light_table —
    never stale, jit-safe)."""
    v = scene.volumes
    f32 = jnp.float32
    rows = []
    for k, kind in enumerate(scene.volume_kinds):
        p0 = v.p0[k].astype(f32)
        p1 = v.p1[k].astype(f32)
        den = v.density[k].astype(f32)
        alb = v.albedo[k].astype(f32)
        if kind == "s":
            geo = jnp.concatenate([p0, p1[0][None], jnp.zeros((2,), f32)])
        else:
            geo = jnp.concatenate([p0, p1])
        rows.append(jnp.concatenate([
            geo, den[None], v.rotate_y[k][None].astype(f32), alb,
            v.translate[k].astype(f32),
        ]))
    return jnp.stack(rows), v.albedo.astype(f32)


def _interval(table, k, kind, ox, oy, oz, dx, dy, dz):
    """Boundary interval [t0, t1] of volume ``k`` along the ray (ray
    parameterization of d; valid flag where the ray crosses it).

    Rotated boxes ("r") inverse-transform the RAY into the box's local
    frame (x_l = c*x_w - s*z_w after removing the translation) — per
    volume this is a handful of scalar-broadcast mults, the cheap dual
    of the geometry bake used for solid instances (scene.add_box)."""
    if kind == "s":
        cx, cy, cz, r = table[k, 0], table[k, 1], table[k, 2], table[k, 3]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        a = dx * dx + dy * dy + dz * dz
        h = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = h * h - a * c
        # Double-where sqrt guard: same forward value as
        # sqrt(max(disc, 0)), but reverse mode never sees sqrt'(0) = inf
        # (whose product with the miss-lane's zero cotangent is NaN —
        # without this, ANY ray missing the fog sphere poisons the whole
        # scene gradient).
        deg = disc <= 0.0
        sq = jnp.where(deg, 0.0, jnp.sqrt(jnp.where(deg, 1.0, disc)))
        inv_a = 1.0 / jnp.maximum(a, 1e-24)
        return (-h - sq) * inv_a, (-h + sq) * inv_a, disc > 0.0
    x0, y0, z0 = table[k, 0], table[k, 1], table[k, 2]
    x1, y1, z1 = table[k, 3], table[k, 4], table[k, 5]
    if kind == "r":
        th = table[k, 7]
        c, sn = jnp.cos(th), jnp.sin(th)
        wx = ox - table[k, 11]
        wy = oy - table[k, 12]
        wz = oz - table[k, 13]
        ox, oz = c * wx - sn * wz, sn * wx + c * wz
        oy = wy
        dx, dz = c * dx - sn * dz, sn * dx + c * dz

    def axis(o, d, lo, hi):
        inv = 1.0 / jnp.where(jnp.abs(d) < 1e-24,
                              jnp.where(d < 0, -1e-24, 1e-24), d)
        ta, tb = (lo - o) * inv, (hi - o) * inv
        return jnp.minimum(ta, tb), jnp.maximum(ta, tb)

    ax0, ax1 = axis(ox, dx, x0, x1)
    ay0, ay1 = axis(oy, dy, y0, y1)
    az0, az1 = axis(oz, dz, z0, z1)
    t0 = jnp.maximum(jnp.maximum(ax0, ay0), az0)
    t1 = jnp.minimum(jnp.minimum(ax1, ay1), az1)
    return t0, t1, t0 < t1


def volume_transmittance(table, volume_kinds, ox, oy, oz, dx, dy, dz,
                         t_max):
    """exp(-sum_k sigma_k * overlap_k) along [0, t_max] of the ray —
    the deterministic medium attenuation NEE shadow rays must carry
    (the scatter path attenuates implicitly via free-flight survival;
    without this factor direct-light samples from inside or behind a
    medium overcount — measured +13% on a fog-ball scene)."""
    dlen = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-24))
    tau = jnp.zeros(ox.shape, jnp.float32)
    for k, kind in enumerate(volume_kinds):
        t0, t1, valid = _interval(table, k, kind, ox, oy, oz, dx, dy, dz)
        t_in = jnp.maximum(t0, 0.0)
        t_out = jnp.minimum(t1, t_max)
        overlap = jnp.maximum(t_out - t_in, 0.0)
        # sigma is per WORLD length; overlap is in ray units of d.
        tau = tau + jnp.where(valid, table[k, 6] * overlap * dlen, 0.0)
    return jnp.exp(-tau)


def sample_volume_event(table, albedo, volume_kinds, us, ox, oy, oz,
                        dx, dy, dz, t_surf):
    """Per-lane volume free-flight -> (v_hit, t_v, (ar, ag, ab)).

    ``us``: (V,)-tuple of per-lane uniforms in (0, 1] (one independent
    draw per volume; reusing one draw would correlate overlapping
    media).  ``t_surf``: the surface sweep's winner t (ray
    parameterization of the UNNORMALIZED ``d``; misses carry a huge
    value).  The nearest qualifying event across volumes wins; its
    albedo is selected with masked where (no gather).
    """
    dlen = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-24))
    t_v = jnp.full(ox.shape, _BIG, jnp.float32)
    ar = jnp.zeros(ox.shape, jnp.float32)
    ag = jnp.zeros(ox.shape, jnp.float32)
    ab = jnp.zeros(ox.shape, jnp.float32)
    for k, kind in enumerate(volume_kinds):
        t0, t1, valid = _interval(table, k, kind, ox, oy, oz, dx, dy, dz)
        sigma = table[k, 6]
        t_in = jnp.maximum(t0, np.float32(1e-3))
        t_out = jnp.minimum(t1, t_surf)
        # Exp(sigma) distance in WORLD units -> ray units via 1/|d|.
        step = -jnp.log(jnp.maximum(us[k], 1e-12)) / jnp.maximum(
            sigma, 1e-12) / dlen
        t_k = t_in + step
        ok = valid & (t_in < t_out) & (t_k < t_out)
        win = ok & (t_k < t_v)
        t_v = jnp.where(win, t_k, t_v)
        ar = jnp.where(win, albedo[k, 0], ar)
        ag = jnp.where(win, albedo[k, 1], ag)
        ab = jnp.where(win, albedo[k, 2], ab)
    return t_v < _BIG, t_v, (ar, ag, ab)
