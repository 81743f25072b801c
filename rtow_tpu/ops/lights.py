"""Next-event estimation (NEE): direct light sampling for emissive scenes.

The plain estimator finds lights only by randomly scattering into them —
with a small area light the hit probability is tiny and images need
thousands of samples (the classic Cornell-box noise).  NEE samples a
point on a light explicitly at every diffuse hit, casts one shadow ray,
and adds the direct contribution analytically; the scattered
continuation ray then SUPPRESSES emission on its next hit (tracked by a
came-from-diffuse flag) so no light path is counted twice.

Estimator equivalence (what the tests assert): for a Lambertian hit at
scatter budget b < max_depth, the plain estimator's paths that bounce
once more and land on a light are replaced one-for-one by the NEE
sample; specular (metal/dielectric) chains and direct camera->light
hits keep collecting emission on hit.  Expectations match exactly;
only the variance changes.

Geometry terms (Lambertian BRDF albedo/pi, uniform light pick 1/K):
 * sphere light: uniform direction in the subtended cone,
   pdf = 1 / (2 pi (1 - cos_theta_max)), cos_theta_max =
   sqrt(1 - r^2/d^2); contribution = albedo * emit * cos_theta * K *
   2 (1 - cos_theta_max)  (the pi of the BRDF cancels the 2 pi).
 * triangle light: uniform point on the triangle (area pdf),
   solid-angle pdf = dist^2 / (cos_alpha * area); backface-culled
   lights emit only from their front side (cos_alpha > 0), matching
   the sweep's det >= 1e-6 cull.

The occlusion test is distance-based: the shadow ray's nearest hit must
lie at (or beyond) the sampled light point — no primitive-index
bookkeeping survives the triangle table's Morton reordering, and a
culled back-facing light is correctly "transparent" under this test
(its contribution is zeroed by the cos_alpha term instead).

Scope: forward rendering AND the differentiable path (``diff.render_pixels(nee=True)``).  Under
common random numbers the light-sampling distribution is independent of
material parameters, so NEE gradients w.r.t. albedo / emitted radiance
are exact (FD-gated, tests/test_nee_grad.py); gradients w.r.t. LIGHT
geometry carry the full REPARAMETERIZED interior derivative — the
cone-sampled direction and the 2(1 - cos_max) pdf factor are smooth
functions of center/radius (triangle lights: of the vertices), so
reverse mode recovers light position and size (FD-gated,
tests/test_nee_grad.py::test_nee_light_geometry_grad_matches_fd).
What is NOT estimated is the visibility boundary term (the moving
silhouette of an occluder between shading point and light) — the same
class of omission as the visibility delta terms the plain estimator
already drops.  Every clamped sqrt in
this module uses the double-where guard (forward value unchanged;
backward never sees sqrt'(0) = inf, whose product with a zero cotangent
is NaN) so reverse mode is finite on degenerate lanes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Scene

#: light-table rows are (K, 14) f32:
#: sphere:   1-3 center0, 4-6 dcenter, 7 radius
#: triangle: 1-3 v0, 4-6 e1, 7-9 e2, 10 area
#: cols 11-13: emitted radiance (col 0 unused; light KINDS are static —
#: scene.light_ids metadata — so no kind column is consulted at trace).
MAX_LIGHTS = 16


def build_light_table(scene: Scene) -> jax.Array:
    """(K, 16) f32 light table assembled from the scene's leaves.

    ``scene.light_ids`` (static build-time metadata: a tuple of
    ("s"|"t", prim_index)) drives STATIC indexing into the traced
    scene arrays, so this works identically on concrete scenes and
    under jit — and never goes stale, since rows are re-derived from
    the current leaves every trace.
    """
    rows = []
    f32 = jnp.float32
    for kind, i in scene.light_ids:
        if kind == "s":
            c0 = scene.spheres.center0[i].astype(f32)
            dc = scene.spheres.dcenter[i].astype(f32)
            r = scene.spheres.radius[i].astype(f32)
            emit = scene.materials.albedo[scene.spheres.material[i]]
            rows.append(jnp.concatenate([
                jnp.zeros((1,), f32), c0, dc, r[None],
                jnp.zeros((3,), f32), emit.astype(f32),
            ]))
        else:
            v = scene.triangles.verts[i].astype(f32)
            v0, e1, e2 = v[0], v[1] - v[0], v[2] - v[0]
            area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2))
            emit = scene.materials.albedo[scene.triangles.material[i]]
            rows.append(jnp.concatenate([
                jnp.ones((1,), f32), v0, e1, e2, area[None].astype(f32),
                emit.astype(f32),
            ]))
    if not rows:
        return jnp.zeros((1, 14), jnp.float32)
    return jnp.stack(rows)


def _onb(wx, wy, wz):
    """Branchless orthonormal basis around unit w (Frisvad/Duff)."""
    sign = jnp.where(wz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + wz)
    b = wx * wy * a
    ux = 1.0 + sign * wx * wx * a
    uy = sign * b
    uz = -sign * wx
    vx = b
    vy = sign + wy * wy * a
    vz = -wy
    return (ux, uy, uz), (vx, vy, vz)


def sample_light_dirs(table, light_kinds, pick, u1, u2, px, py, pz, tm):
    """Per-lane light sample -> (dx, dy, dz, t_light, weight3, pdf).

    ``light_kinds`` is the static tuple of "s"/"t" from
    ``scene.light_ids``; ``pick``/``u1``/``u2`` are per-lane uniforms
    in [0, 1); ``p*`` the shading points; ``tm`` the ray times (moving
    sphere lights).  ``weight3`` is emit * (geometry terms) * K —
    multiply by the Lambertian albedo (the BRDF's pi is cancelled) and
    cos_theta at the shading point, then gate on the shadow ray being
    unoccluded.  ``pdf`` is the EFFECTIVE solid-angle density of the
    whole strategy (picked light's pdf / K; 0 where the sample is
    degenerate) — the MIS balance weight's light-side term.

    All lanes evaluate all K light rows and select by the pick index
    (K <= MAX_LIGHTS; masked selects, no gather) — the same
    evaluate-all-and-select scheme as material dispatch.
    """
    n_lights = len(light_kinds)
    k_idx = jnp.minimum((pick * n_lights).astype(jnp.int32), n_lights - 1)
    shape = px.shape
    dx = jnp.zeros(shape, jnp.float32)
    dy = jnp.zeros(shape, jnp.float32)
    dz = jnp.zeros(shape, jnp.float32)
    tl = jnp.full(shape, 1e30, jnp.float32)
    w0 = jnp.zeros(shape, jnp.float32)
    w1 = jnp.zeros(shape, jnp.float32)
    w2 = jnp.zeros(shape, jnp.float32)
    pdf = jnp.zeros(shape, jnp.float32)

    for k, lkind in enumerate(light_kinds):
        sel = k_idx == k
        er, eg, eb = table[k, 11], table[k, 12], table[k, 13]
        if lkind == "s":  # sphere light
            cx = table[k, 1] + tm * table[k, 4]
            cy = table[k, 2] + tm * table[k, 5]
            cz = table[k, 3] + tm * table[k, 6]
            r = jnp.abs(table[k, 7])
            tox, toy, toz = cx - px, cy - py, cz - pz
            d2 = tox * tox + toy * toy + toz * toz
            d = jnp.sqrt(jnp.maximum(d2, 1e-12))
            inv_d = 1.0 / d
            wx_, wy_, wz_ = tox * inv_d, toy * inv_d, toz * inv_d
            # Inside the sphere -> degenerate; zero the weight below.
            # Double-where sqrt guards: same forward values as
            # sqrt(max(arg, 0)), finite reverse mode at arg <= 0.
            arg_cm = 1.0 - (r * r) / jnp.maximum(d2, 1e-12)
            deg_cm = arg_cm <= 0.0
            cos_max = jnp.where(
                deg_cm, 0.0, jnp.sqrt(jnp.where(deg_cm, 1.0, arg_cm)))
            cos_t = 1.0 - u1 * (1.0 - cos_max)
            arg_st = 1.0 - cos_t * cos_t
            deg_st = arg_st <= 1e-12
            sin_t = jnp.where(
                deg_st, 0.0, jnp.sqrt(jnp.where(deg_st, 1.0, arg_st)))
            phi = 2.0 * np.pi * u2
            (ux, uy, uz), (vx, vy, vz) = _onb(wx_, wy_, wz_)
            sx = (jnp.cos(phi) * sin_t * ux + jnp.sin(phi) * sin_t * vx
                  + cos_t * wx_)
            sy = (jnp.cos(phi) * sin_t * uy + jnp.sin(phi) * sin_t * vy
                  + cos_t * wy_)
            sz = (jnp.cos(phi) * sin_t * uz + jnp.sin(phi) * sin_t * vz
                  + cos_t * wz_)
            # Ray-sphere t along the sampled direction (near root).
            oc_d = -(tox * sx + toy * sy + toz * sz)
            disc = oc_d * oc_d - (d2 - r * r)
            deg_d = disc <= 0.0
            t_k = -oc_d - jnp.where(
                deg_d, 0.0, jnp.sqrt(jnp.where(deg_d, 1.0, disc)))
            ok = (d2 > r * r) & (disc > 0.0)
            # pdf = 1/(2 pi (1 - cos_max)); weight = emit/(pi*pdf)*K
            # -> emit * 2 (1 - cos_max) * K.
            geo = jnp.where(ok, 2.0 * (1.0 - cos_max) * n_lights, 0.0)
            pdf_k = jnp.where(ok, 1.0 / jnp.maximum(
                2.0 * np.pi * (1.0 - cos_max) * n_lights, 1e-12), 0.0)
            dx = jnp.where(sel, sx, dx)
            dy = jnp.where(sel, sy, dy)
            dz = jnp.where(sel, sz, dz)
            tl = jnp.where(sel, jnp.maximum(t_k, 1e-4), tl)
            w0 = jnp.where(sel, er * geo, w0)
            w1 = jnp.where(sel, eg * geo, w1)
            w2 = jnp.where(sel, eb * geo, w2)
            pdf = jnp.where(sel, pdf_k, pdf)
        else:  # triangle light
            v0x, v0y, v0z = table[k, 1], table[k, 2], table[k, 3]
            e1x, e1y, e1z = table[k, 4], table[k, 5], table[k, 6]
            e2x, e2y, e2z = table[k, 7], table[k, 8], table[k, 9]
            area = table[k, 10]
            su = jnp.sqrt(jnp.maximum(u1, 1e-12))
            bu = 1.0 - su
            bv = u2 * su
            qx = v0x + bu * e1x + bv * e2x
            qy = v0y + bu * e1y + bv * e2y
            qz = v0z + bu * e1z + bv * e2z
            tox, toy, toz = qx - px, qy - py, qz - pz
            d2 = tox * tox + toy * toy + toz * toz
            d = jnp.sqrt(jnp.maximum(d2, 1e-12))
            inv_d = 1.0 / d
            sx, sy, sz = tox * inv_d, toy * inv_d, toz * inv_d
            # Light normal (unnormalized cross, same orientation as the
            # sweep's det test).
            nx = e1y * e2z - e1z * e2y
            ny = e1z * e2x - e1x * e2z
            nz = e1x * e2y - e1y * e2x
            nlen = jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz,
                                        1e-24))
            # cos at the light: front side when the shadow ray opposes
            # the normal (matches det = -(d . n) >= eps cull).
            cos_a = -(sx * nx + sy * ny + sz * nz) / nlen
            ok = cos_a > 1e-6
            # pdf_solid = d^2/(cos_a * area);
            # weight = emit * cos_a * area / (pi * ... ) * pi-cancel:
            # BRDF albedo/pi x emit x cos_theta / pdf x K
            # = albedo * emit * cos_theta * cos_a * area * K/(pi d^2).
            geo = jnp.where(
                ok, cos_a * area * n_lights / (np.pi * jnp.maximum(
                    d2, 1e-12)), 0.0)
            pdf_k = jnp.where(ok, d2 / jnp.maximum(
                cos_a * area * n_lights, 1e-12), 0.0)
            dx = jnp.where(sel, sx, dx)
            dy = jnp.where(sel, sy, dy)
            dz = jnp.where(sel, sz, dz)
            tl = jnp.where(sel, jnp.maximum(d, 1e-4), tl)
            w0 = jnp.where(sel, er * geo, w0)
            w1 = jnp.where(sel, eg * geo, w1)
            w2 = jnp.where(sel, eb * geo, w2)
            pdf = jnp.where(sel, pdf_k, pdf)
    return dx, dy, dz, tl, (w0, w1, w2), pdf


def light_pdf_toward(table, light_kinds, ox, oy, oz, dx, dy, dz, t_hit,
                     tm):
    """Effective light-strategy pdf of direction d from origin o, given
    the path's nearest hit lies at ``t_hit`` — the MIS balance weight's
    light-side term at a BRDF-sampled emissive hit.

    Sums each light's solid-angle pdf / K over the lights whose first
    intersection along d matches ``t_hit`` (only the light actually hit
    matches; the sum form needs no hit-primitive id and is exactly the
    density with which :func:`sample_light_dirs` generates this path).
    ``d`` may be unnormalized (scatter directions are raw ``n + unit``,
    reference semantics) as long as ``t_hit`` parameterizes the same
    ray — both are rescaled to unit length here.
    """
    n_lights = len(light_kinds)
    dlen = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-24))
    inv_l = 1.0 / dlen
    dx, dy, dz = dx * inv_l, dy * inv_l, dz * inv_l
    t_hit = t_hit * dlen
    pdf = jnp.zeros(ox.shape, jnp.float32)
    for k, lkind in enumerate(light_kinds):
        if lkind == "s":
            cx = table[k, 1] + tm * table[k, 4]
            cy = table[k, 2] + tm * table[k, 5]
            cz = table[k, 3] + tm * table[k, 6]
            r = jnp.abs(table[k, 7])
            tox, toy, toz = cx - ox, cy - oy, cz - oz
            d2 = tox * tox + toy * toy + toz * toz
            oc_d = -(tox * dx + toy * dy + toz * dz)
            disc = oc_d * oc_d - (d2 - r * r)
            deg_d = disc <= 0.0
            t_k = -oc_d - jnp.where(
                deg_d, 0.0, jnp.sqrt(jnp.where(deg_d, 1.0, disc)))
            arg_cm = 1.0 - (r * r) / jnp.maximum(d2, 1e-12)
            deg_cm = arg_cm <= 0.0
            cos_max = jnp.where(
                deg_cm, 0.0, jnp.sqrt(jnp.where(deg_cm, 1.0, arg_cm)))
            ok = (d2 > r * r) & (disc > 0.0) & (t_k > 0.0)
            pdf_k = 1.0 / jnp.maximum(
                2.0 * np.pi * (1.0 - cos_max) * n_lights, 1e-12)
        else:
            v0x, v0y, v0z = table[k, 1], table[k, 2], table[k, 3]
            e1x, e1y, e1z = table[k, 4], table[k, 5], table[k, 6]
            e2x, e2y, e2z = table[k, 7], table[k, 8], table[k, 9]
            area = table[k, 10]
            # Moeller-Trumbore against the light triangle (front side
            # only, matching the sweep's det >= 1e-6 cull).
            px_ = dy * e2z - dz * e2y
            py_ = dz * e2x - dx * e2z
            pz_ = dx * e2y - dy * e2x
            det = e1x * px_ + e1y * py_ + e1z * pz_
            inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
            sx_, sy_, sz_ = ox - v0x, oy - v0y, oz - v0z
            u = (sx_ * px_ + sy_ * py_ + sz_ * pz_) * inv
            qx_ = sy_ * e1z - sz_ * e1y
            qy_ = sz_ * e1x - sx_ * e1z
            qz_ = sx_ * e1y - sy_ * e1x
            v = (dx * qx_ + dy * qy_ + dz * qz_) * inv
            t_k = (e2x * qx_ + e2y * qy_ + e2z * qz_) * inv
            ok = ((det >= 1e-6) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t_k > 0.0))
            nx = e1y * e2z - e1z * e2y
            ny = e1z * e2x - e1x * e2z
            nz = e1x * e2y - e1y * e2x
            nlen = jnp.sqrt(jnp.maximum(nx * nx + ny * ny + nz * nz,
                                        1e-24))
            cos_a = -(dx * nx + dy * ny + dz * nz) / nlen
            d2 = t_k * t_k
            pdf_k = d2 / jnp.maximum(
                cos_a * area * n_lights, 1e-12)
        match = ok & (jnp.abs(t_k - t_hit)
                      <= 1e-3 * jnp.maximum(t_hit, 1.0))
        pdf = pdf + jnp.where(match, pdf_k, 0.0)
    return pdf
