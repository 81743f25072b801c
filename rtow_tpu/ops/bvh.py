"""Stackless BVH: host-side build, flattened arrays, vectorized traversal.

The reference builds a pointer-chasing binary BVH of ``unique_ptr`` nodes
and traverses it recursively per ray (reference src/render.cpp:22-110).
Redesign for a wavefront of lanes:

* **Build on host** (NumPy, microseconds for these scenes): largest-extent
  centroid axis, median split — a strictly better variant of the
  reference's first-vs-last-bbox heuristic (render.cpp:80-106), which
  SURVEY.md's quirks ledger marks free to redesign.
* **Flatten to arrays** in preorder: for every node the *left child is
  node+1* and a precomputed ``skip`` index says where to jump when the
  subtree is culled or done — no stack, no recursion.
* **Traverse as data**: every lane carries a node cursor; one
  ``lax.while_loop`` advances all cursors until every lane has escaped.
  Leaf hits test a bounded number of primitives with masks.

Differentiability: the traversal (while_loop) only *finds* the winning
primitive id — non-differentiable by construction.  The hit parameter
``t`` is then *recomputed* for the winner with the ordinary intersection
math, so gradients flow into geometry exactly as on the brute-force path.

Negative-radius note: the reference packs ``center ± r`` into sphere
AABBs (src/common-model.cpp:168-171), which produces an *inverted* (never
hittable) box for the negative-radius hollow-glass spheres; we use |r|,
so hollow glass works under the BVH too (documented fix).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.materials import HitRecord
from ..models.scene import Scene
from . import intersect, vec

#: Max primitives per leaf. The reference uses 6 (render.cpp:74); 4 keeps
#: the masked leaf sweep cheap on the vector unit.
LEAF_SIZE = 4


def _pytree_dataclass(cls):
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])


@_pytree_dataclass
class FlatBVH:
    bbox_min: jax.Array  # (Nn, 3)
    bbox_max: jax.Array  # (Nn, 3)
    first: jax.Array  # (Nn,) leaf: first slot in prim_ids; inner: unused
    count: jax.Array  # (Nn,) leaf: #prims (>0); inner: 0
    skip: jax.Array  # (Nn,) node to visit when culled/done (Nn = exit)
    prim_ids: jax.Array  # (Np_padded,) global primitive ids, leaf-contiguous


def primitive_aabbs(scene: Scene) -> Tuple[np.ndarray, np.ndarray]:
    """Host AABBs for all primitives in global-id order (spheres then
    triangles), matching the reference boxes (src/common-model.cpp:168-207)
    except for the |r| fix."""
    mins, maxs = [], []
    if scene.n_spheres:
        c0 = np.asarray(scene.spheres.center0, np.float64)
        dc = np.asarray(scene.spheres.dcenter, np.float64)
        r = np.abs(np.asarray(scene.spheres.radius, np.float64))[:, None]
        # Union of the t=0 and t=1 boxes (MovingSphere::bounding_box).
        mins.append(np.minimum(c0, c0 + dc) - r)
        maxs.append(np.maximum(c0, c0 + dc) + r)
    if scene.n_triangles:
        v = np.asarray(scene.triangles.verts, np.float64)
        mins.append(v.min(axis=1))
        maxs.append(v.max(axis=1))
    return np.concatenate(mins), np.concatenate(maxs)


def build_bvh(
    scene: Scene, leaf_size: int = LEAF_SIZE, dtype=None, use_native: bool = True
) -> FlatBVH:
    """Build the flattened BVH on host.

    Dispatches to the iterative C++ builder (rtow_tpu.native, bit-identical
    trees via stable sorting) for large primitive counts; the NumPy
    recursion below is the fallback and parity oracle."""
    if dtype is None:
        dtype = scene.spheres.center0.dtype if scene.n_spheres else scene.triangles.verts.dtype
    pmin, pmax = primitive_aabbs(scene)
    if use_native and pmin.shape[0] >= 1024:
        try:
            from .. import native

            if native.available():
                bmin, bmax, first, count, skip, ids = native.build_bvh_arrays(
                    pmin, pmax, leaf_size
                )
                return FlatBVH(
                    bbox_min=jnp.asarray(bmin, dtype),
                    bbox_max=jnp.asarray(bmax, dtype),
                    first=jnp.asarray(first),
                    count=jnp.asarray(count),
                    skip=jnp.asarray(skip),
                    prim_ids=jnp.asarray(ids),
                )
        except Exception:
            pass
    centroid = 0.5 * (pmin + pmax)
    n = pmin.shape[0]

    bbox_min: list = []
    bbox_max: list = []
    first: list = []
    count: list = []
    skip: list = []
    order: list = []

    def emit(ids: np.ndarray) -> int:
        """Append the subtree over ``ids``; returns its node index."""
        me = len(bbox_min)
        bbox_min.append(pmin[ids].min(axis=0))
        bbox_max.append(pmax[ids].max(axis=0))
        first.append(0)
        count.append(0)
        skip.append(-1)  # patched by caller
        if len(ids) <= leaf_size:
            first[me] = len(order)
            count[me] = len(ids)
            order.extend(int(i) for i in ids)
            return me
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        half = len(ids) // 2
        left = emit(ids[:half])
        skip[left] = -2  # placeholder: left's skip = right's index
        right = emit(ids[half:])
        skip[left] = right
        return me

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 64 + 2 * n))
    try:
        emit(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    n_nodes = len(bbox_min)
    skip_arr = np.asarray(skip, np.int32)
    # Nodes whose skip is unpatched escape to their ancestor's skip; walk
    # once from the root: root skips to the sentinel n_nodes.
    # emit() patched only left siblings; right siblings and the root fall
    # through to their parent's skip. Compute by a second pass: preorder
    # guarantees a node's subtree is [me, skip) — rebuild via a stack.
    fixed_skip = np.full(n_nodes, n_nodes, np.int32)
    stack = [(0, n_nodes)]  # (node, escape)
    counts = np.asarray(count, np.int32)
    while stack:
        node, esc = stack.pop()
        fixed_skip[node] = esc
        if counts[node] == 0:  # inner: children are node+1 and skip_arr[node+1... ]
            left = node + 1
            right = skip_arr[left]
            stack.append((left, right))
            stack.append((right, esc))

    # Pad prim order so leaf gathers never index out of range.
    order_arr = np.asarray(order + [0] * leaf_size, np.int32)

    return FlatBVH(
        bbox_min=jnp.asarray(np.asarray(bbox_min), dtype),
        bbox_max=jnp.asarray(np.asarray(bbox_max), dtype),
        first=jnp.asarray(np.asarray(first, np.int32)),
        count=jnp.asarray(counts),
        skip=jnp.asarray(fixed_skip),
        prim_ids=jnp.asarray(order_arr),
    )


def _single_prim_t(
    scene: Scene,
    origin: jax.Array,
    direction: jax.Array,
    time: jax.Array,
    prim_id: jax.Array,
    tmin: float,
    tmax: jax.Array,
    cull_backfaces: bool,
) -> jax.Array:
    """Hit parameter of ONE primitive per lane (gathered params) -> (L,).

    Same math as the (L, N) sweeps in ops.intersect, specialised to a
    single gathered primitive per lane; +inf on miss.  Differentiable.
    """
    n_sph = scene.n_spheres
    out = jnp.full(prim_id.shape, jnp.inf, origin.dtype)

    if n_sph:
        si = jnp.clip(prim_id, 0, n_sph - 1)
        c = scene.spheres.center0[si] + time[..., None] * scene.spheres.dcenter[si]
        r = scene.spheres.radius[si]
        oc = origin - c
        a = vec.dot(direction, direction)
        h = vec.dot(oc, direction)
        cc = vec.dot(oc, oc) - r * r
        disc = h * h - a * cc
        sq = vec.safe_sqrt(disc)  # guarded: no inf derivative on miss lanes
        near = (-h - sq) / a
        far = (-h + sq) / a
        near_ok = (near >= tmin) & (near <= tmax)
        far_ok = (far >= tmin) & (far <= tmax)
        t_s = jnp.where(near_ok, near, far)
        ok_s = (disc > 0.0) & (near_ok | far_ok) & (prim_id < n_sph)
        out = jnp.where(ok_s, t_s, out)

    if scene.n_triangles:
        ti = jnp.clip(prim_id - n_sph, 0, scene.n_triangles - 1)
        va = scene.triangles.verts[ti, 0]
        e1 = scene.triangles.verts[ti, 1] - va
        e2 = scene.triangles.verts[ti, 2] - va
        nrm = vec.cross(e1, e2)
        det = -vec.dot(direction, nrm)
        det_ok = jnp.abs(det) >= 1e-6
        invdet = jnp.where(det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0)
        ao = origin - va
        dao = vec.cross(ao, direction)
        u = vec.dot(e2, dao) * invdet
        v = -vec.dot(e1, dao) * invdet
        t_t = vec.dot(ao, nrm) * invdet
        facing = det >= 1e-6 if cull_backfaces else jnp.abs(det) >= 1e-6
        ok_t = (
            facing
            & (t_t >= tmin)
            & (t_t <= tmax)
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (prim_id >= n_sph)
        )
        out = jnp.where(ok_t, t_t, out)
    return out


def traverse(
    bvh: FlatBVH,
    scene: Scene,
    origin: jax.Array,
    direction: jax.Array,
    time: jax.Array,
    tmin: float = intersect.T_MIN,
    cull_backfaces: bool = True,
    leaf_size: int = LEAF_SIZE,
) -> Tuple[jax.Array, jax.Array]:
    """Nearest-hit search -> (t, global prim id) per lane.

    ``leaf_size`` must be >= the leaf capacity the tree was built with
    (it bounds the unrolled leaf sweep).

    All lanes walk the flattened tree in lockstep on their own cursors;
    the loop ends when every cursor has escaped past the last node.
    Non-differentiable (callers recompute t for the winner).
    """
    n_nodes = bvh.count.shape[0]
    lanes = time.shape
    dtype = origin.dtype

    inv_d = 1.0 / direction  # IEEE inf semantics give correct slab tests

    def aabb_hit(node, t_best):
        bmin = bvh.bbox_min[node]
        bmax = bvh.bbox_max[node]
        t0 = (bmin - origin) * inv_d
        t1 = (bmax - origin) * inv_d
        tsm = jnp.minimum(t0, t1)
        tbg = jnp.maximum(t0, t1)
        enter = jnp.maximum(jnp.max(tsm, axis=-1), tmin)
        exit_ = jnp.minimum(jnp.min(tbg, axis=-1), t_best)
        # Reference slab test rejects on t_max <= t_min
        # (src/common-model.h:71-84).
        return exit_ > enter

    def cond(state):
        node, _, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t_best, id_best = state
        node_c = jnp.minimum(node, n_nodes - 1)
        active = node < n_nodes
        box_ok = aabb_hit(node_c, t_best) & active
        cnt = bvh.count[node_c]
        is_leaf = (cnt > 0) & box_ok

        first = bvh.first[node_c]
        t_new, id_new = t_best, id_best
        for k in range(leaf_size):
            pid = bvh.prim_ids[first + k]
            lane_on = is_leaf & (k < cnt)
            t_k = _single_prim_t(
                scene, origin, direction, time, pid, tmin, t_new, cull_backfaces
            )
            better = lane_on & (t_k < t_new)
            t_new = jnp.where(better, t_k, t_new)
            id_new = jnp.where(better, pid, id_new)

        # inner node + box hit -> descend (left child = node+1);
        # otherwise escape via skip.
        descend = box_ok & (cnt == 0)
        nxt = jnp.where(descend, node_c + 1, bvh.skip[node_c])
        nxt = jnp.where(active, nxt, node)
        return nxt, t_new, id_new

    node0 = jnp.zeros(lanes, jnp.int32)
    t0 = jnp.full(lanes, jnp.inf, dtype)
    id0 = jnp.zeros(lanes, jnp.int32)
    _, t_best, id_best = jax.lax.while_loop(cond, body, (node0, t0, id0))
    return t_best, id_best


def make_nearest_hit(scene: Scene, leaf_size: int = LEAF_SIZE):
    """Build the BVH once and return a nearest-hit fn with the integrator's
    signature (drop-in for intersect.nearest_hit_bruteforce)."""
    bvh = build_bvh(scene, leaf_size)

    def nearest_hit(scene_rt: Scene, origin, direction, time, tmin=intersect.T_MIN,
                    cull_backfaces: bool = True) -> HitRecord:
        t_nd, prim_idx = traverse(
            bvh, jax.lax.stop_gradient(scene_rt), origin, direction, time,
            tmin, cull_backfaces, leaf_size=leaf_size,
        )
        prim_idx = jax.lax.stop_gradient(prim_idx)
        # Recompute the winner's t differentiably.
        t = _single_prim_t(
            scene_rt, origin, direction, time, prim_idx, tmin,
            jnp.full(time.shape, jnp.inf, origin.dtype), cull_backfaces,
        )
        t = jnp.where(jnp.isfinite(t_nd), t, jnp.inf)
        return intersect.hit_record_from(
            scene_rt, origin, direction, time, t, prim_idx,
            cull_backfaces=cull_backfaces,
        )

    return nearest_hit
