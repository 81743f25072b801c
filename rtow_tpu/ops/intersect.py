"""Wavefront ray-primitive intersection.

The reference intersects one ray against one primitive at a time through
virtual/variant dispatch (reference src/common-model.cpp:64-125).  Here
intersection is a dense (rays × primitives) computation: every lane of the
wavefront tests every primitive of a kind in one fused pass, then a
single argmin picks the nearest hit.  The scene is tiny (hundreds of
primitives, a few KB) while the wavefront is huge (10^5-10^6 rays), so the
(L, N) sweep keeps every lane busy with no divergence; the BVH
(ops/bvh.py) replaces the full sweep with per-lane traversal for large
meshes.

All functions are shape-polymorphic over a leading batch axis L and are
differentiable w.r.t. scene geometry.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.materials import HitRecord
from ..models.scene import Scene, Spheres, Triangles
from . import vec

#: Self-intersection epsilon — the reference's ``root.hit(ray, 0.001, inf)``
#: default (src/render.cpp:32-34).
T_MIN = 1e-3


def sphere_ts(
    spheres: Spheres,
    origin: jax.Array,
    direction: jax.Array,
    time: jax.Array,
    tmin: float = T_MIN,
    tmax=jnp.inf,
) -> jax.Array:
    """Nearest valid hit parameter per (ray, sphere) pair -> (L, N), +inf on miss.

    Same quadratic as ``sphere_hit_helper`` (reference
    src/common-model.cpp:64-91): half-b form, near root preferred, far
    root accepted when the near root is out of range.  Branchless.
    Motion blur: the center is lerped by the per-ray time
    (src/oo-primitives.h:63-66), which folds into the quadratic's
    coefficients without materialising per-pair centers.
    """
    # center(t) = c0 + time * dc;  oc = o - center
    # h = oc.d = o.d - c0.d - time*(dc.d)
    # c = oc.oc - r^2
    #   = o.o - 2 o.c0 + c0.c0 - r^2  - 2*time*(o.dc - c0.dc) + time^2 dc.dc
    o, d, tm = origin, direction, time[..., None]  # (L,3),(L,3),(L,1)
    c0, dc, r = spheres.center0, spheres.dcenter, spheres.radius  # (N,3),(N,3),(N,)

    # Broadcast (L,1,3) vs (N,3) -> every op elementwise over (L,N[,3]), so
    # XLA fuses the whole quadratic into the downstream min/argmin reduction
    # with no (L,N) materialisation in device memory.  No matmul form:
    # matmul outputs break that fusion, and f32 precision is mandatory
    # here (the expanded quadratic catastrophically cancels for the
    # |c|~1e3 ground sphere at reduced matmul precision).
    center = c0[..., None, :, :] + tm[..., None] * dc[..., None, :, :]  # (L,N,3)
    oc = o[..., None, :] - center  # (L, N, 3)
    a = vec.length2(d)[..., None]  # (L, 1)
    h = jnp.sum(oc * d[..., None, :], axis=-1)  # (L, N)
    c = jnp.sum(oc * oc, axis=-1) - r * r  # (L, N)

    disc = h * h - a * c
    sq = vec.safe_sqrt(disc)  # guarded: no inf derivative on miss lanes
    near = (-h - sq) / a
    far = (-h + sq) / a
    near_ok = (near >= tmin) & (near <= tmax)
    far_ok = (far >= tmin) & (far <= tmax)
    root = jnp.where(near_ok, near, far)
    valid = (disc > 0.0) & (near_ok | far_ok)
    return jnp.where(valid, root, jnp.inf)


def triangle_ts(
    triangles: Triangles,
    origin: jax.Array,
    direction: jax.Array,
    tmin: float = T_MIN,
    tmax=jnp.inf,
    cull_backfaces: bool = True,
) -> jax.Array:
    """Hit parameter per (ray, triangle) -> (L, M), +inf on miss.

    Möller–Trumbore in the reference's determinant form
    (src/common-model.cpp:104-125).  The reference backface-culls
    (``det >= 1e-6``); ``cull_backfaces=False`` gives the two-sided
    variant (SURVEY.md quirks ledger: culling is a flag here).
    """
    a = triangles.verts[:, 0]  # (M, 3)
    e1 = triangles.verts[:, 1] - a
    e2 = triangles.verts[:, 2] - a
    n = vec.cross(e1, e2)  # (M, 3)

    o, d = origin, direction
    det = -jnp.matmul(d, n.T, precision=jax.lax.Precision.HIGHEST)  # (L, M)
    # ao and dao are per-pair; decompose via scalar-triple-product algebra:
    #   u = e2.(ao × d) = ao.(d × e2),   v = -e1.(ao × d) = -ao.(d × e1)
    # with ao = o - a.  cross(ao, d) per pair would be (L, M, 3); instead
    # use u*det form:  ao.(d × e2) = o.(d × e2) - a.(d × e2).
    # d × e2 and d × e1 still pair L with M; keep the (L, M, 3) form simple
    # and let XLA fuse — M is small for sphere scenes, and meshes route
    # through the BVH which chunks M.
    ao = o[..., None, :] - a  # (L, M, 3)
    dao = jnp.cross(ao, d[..., None, :])  # (L, M, 3)
    # Guarded reciprocal: 1/det is inf for parallel rays, and inf * zero
    # cotangent = NaN in reverse mode even on masked lanes.
    det_ok = jnp.abs(det) >= 1e-6
    invdet = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
    u = vec.dot(jnp.broadcast_to(e2, dao.shape), dao) * invdet
    v = -vec.dot(jnp.broadcast_to(e1, dao.shape), dao) * invdet
    t = vec.dot(ao, jnp.broadcast_to(n, ao.shape)) * invdet

    facing = det >= 1e-6 if cull_backfaces else jnp.abs(det) >= 1e-6
    valid = facing & (t >= tmin) & (t <= tmax) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return jnp.where(valid, t, jnp.inf)


def fetch_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Row ``idx`` of a (K, C) parameter table per lane -> (..., C).

    A plain gather.  Kept as its own function so that tests can swap in
    a one-hot matmul reference and require identical hit records."""
    return table[idx]


def hit_record_from(
    scene: Scene,
    origin: jax.Array,
    direction: jax.Array,
    time: jax.Array,
    t: jax.Array,
    prim_idx: jax.Array,
    cull_backfaces: bool = True,
) -> HitRecord:
    """Reconstruct full hit info for the winning primitive index.

    ``prim_idx`` indexes spheres first then triangles (global primitive
    id); lanes with ``t == +inf`` are misses.

    The winner's parameters are one row gathered per lane from a packed
    (N, 13) sphere / (M, 15) triangle table; gradients scatter-add back
    into the table and on into the scene leaves.  A lane whose winner is
    of the other kind reads a clamped row that the final ``where``
    discards.
    """
    n_sph = scene.n_spheres
    n_tri = scene.n_triangles
    dtype = origin.dtype
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 1.0)
    point = origin + t_safe[..., None] * direction
    mats = scene.materials

    def mat_cols(mat_ids):
        """Per-primitive material param block (K, 6): albedo, fuzz, ir,
        kind — plus the checker odd color (K, 9) when the scene has
        checker materials (static gate, normal scenes stay at 6)."""
        cols = [
            mats.albedo[mat_ids],
            mats.fuzz[mat_ids, None],
            mats.ir[mat_ids, None],
            mats.kind[mat_ids, None].astype(dtype),
        ]
        if scene.has_checker:
            cols.append(mats.albedo2[mat_ids])
        return jnp.concatenate(cols, axis=1)

    if n_sph:
        sph_table = jnp.concatenate(
            [
                scene.spheres.center0,
                scene.spheres.dcenter,
                scene.spheres.radius[:, None],
                mat_cols(scene.spheres.material),
            ],
            axis=1,
        )  # (N, 13)
        ps = fetch_rows(sph_table, jnp.clip(prim_idx, 0, n_sph - 1))
        c0, dc, r = ps[..., 0:3], ps[..., 3:6], ps[..., 6]
        center = c0 + time[..., None] * dc
        # Outward unit normal (p-c)/|r|, then the reference's hollow-glass
        # convention: front XOR (radius < 0), normal flipped to match
        # (src/common-model.cpp:88-90).
        r_safe = jnp.where(r == 0.0, 1.0, jnp.abs(r))
        n_s = (point - center) / r_safe[..., None]
        front_s = (vec.dot(direction, n_s) < 0.0) ^ (r < 0.0)
        n_s = jnp.where(front_s[..., None], n_s, -n_s)
        mat_s = ps[..., 7:]
    if n_tri:
        tri_table = jnp.concatenate(
            [
                scene.triangles.verts.reshape(n_tri, 9),
                mat_cols(scene.triangles.material),
            ],
            axis=1,
        )  # (M, 15)
        pt = fetch_rows(tri_table, jnp.clip(prim_idx - n_sph, 0, n_tri - 1))
        va, e1 = pt[..., 0:3], pt[..., 3:6] - pt[..., 0:3]
        e2 = pt[..., 6:9] - pt[..., 0:3]
        n_t = vec.normalize(vec.cross(e1, e2))
        if not cull_backfaces:
            n_t = jnp.where(vec.dot(direction, n_t)[..., None] < 0.0, n_t, -n_t)
        # Reference reports triangles as always front-facing
        # (src/common-model.cpp:122).
        front_t = jnp.ones_like(hit)
        mat_t = pt[..., 9:]

    if n_sph and n_tri:
        is_sph = (prim_idx < n_sph)[..., None]
        normal = jnp.where(is_sph, n_s, n_t)
        front = jnp.where(is_sph[..., 0], front_s, front_t)
        mat = jnp.where(is_sph, mat_s, mat_t)
    elif n_sph:
        normal, front, mat = n_s, front_s, mat_s
    else:
        normal, front, mat = n_t, front_t, mat_t

    kind = jnp.round(mat[..., 5]).astype(jnp.int32)
    albedo = mat[..., 0:3]
    if scene.has_checker:
        from ..models.materials import checker_albedo

        # Resolve the checker color here so every consumer (scatter
        # attenuation, NEE direct term) sees the effective albedo.
        albedo = checker_albedo(kind, point, mat[..., 4], albedo,
                                mat[..., 6:9])
    if scene.has_image and n_sph:
        from ..models.materials import image_albedo
        from ..models.scene import IMAGE

        # Outward unit normal: unflip the facing correction (flip was
        # front ? +1 : -1, an involution).
        out_n = n_s * jnp.where(front_s, 1.0, -1.0)[..., None]
        tex = image_albedo(scene.texture,
                           out_n[..., 0], out_n[..., 1], out_n[..., 2])
        is_img = kind == IMAGE
        if n_tri:
            is_img = is_img & is_sph[..., 0]
        albedo = jnp.where(is_img[..., None], tex, albedo)
    return HitRecord(
        t=t,
        hit=hit,
        point=point,
        normal=normal,
        front=front,
        mat_kind=kind,
        albedo=albedo,
        fuzz=mat[..., 3],
        ir=mat[..., 4],
    )


def nearest_hit_bruteforce(
    scene: Scene,
    origin: jax.Array,
    direction: jax.Array,
    time: jax.Array,
    tmin: float = T_MIN,
    cull_backfaces: bool = True,
) -> HitRecord:
    """Nearest hit over the whole scene by dense sweep + argmin.

    The semantic equivalent of ``BVHNode::hit`` root traversal
    (reference src/render.cpp:52-71) without the tree: exact same nearest
    hit, no traversal divergence.
    """
    ts = []
    if scene.n_spheres:
        ts.append(sphere_ts(scene.spheres, origin, direction, time, tmin))
    if scene.n_triangles:
        ts.append(
            triangle_ts(scene.triangles, origin, direction, tmin, cull_backfaces=cull_backfaces)
        )
    t_all = jnp.concatenate(ts, axis=-1) if len(ts) > 1 else ts[0]
    # min + argmin both fuse into the same (L, N) reduction loop.
    prim_idx = jnp.argmin(t_all, axis=-1).astype(jnp.int32)
    t = jnp.min(t_all, axis=-1)
    return hit_record_from(
        scene, origin, direction, time, t, prim_idx, cull_backfaces=cull_backfaces
    )
