"""Nearest-sphere sweep as a Pallas kernel on the Triton route.

The same search as ``intersect.sphere_ts`` + min/argmin, written for one
GPU program per block of lanes: each program loads its lanes' rays once,
walks the sphere table, and keeps ``best_t``/``best_k`` in registers, so
no (lanes × spheres) value is ever written to device memory.  Forward
only: it finds the winner, and ``intersect.hit_record_from`` rebuilds the
hit record.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..models.scene import Scene, Spheres
from . import intersect

#: Lanes per program (a power of two, as Triton requires).
BLOCK = 256


def _sweep_kernel(ox, oy, oz, dx, dy, dz, tm, sph, t_out, k_out, *,
                  n_sph: int, tmin: float):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    time = tm[...]
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]

    def body(k, carry):
        best_t, best_k = carry
        row = k * 8
        oc = [o[j] - (sph[row + j] + time * sph[row + 3 + j])
              for j in range(3)]
        r = sph[row + 6]
        h = oc[0] * d[0] + oc[1] * d[1] + oc[2] * d[2]
        c = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
        disc = h * h - a * c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        near = (-h - sq) / a
        far = (-h + sq) / a
        near_ok = near >= tmin
        far_ok = far >= tmin
        root = jnp.where(near_ok, near, far)
        t = jnp.where((disc > 0.0) & (near_ok | far_ok), root, jnp.inf)
        better = t < best_t
        return jnp.where(better, t, best_t), jnp.where(better, k, best_k)

    best_t, best_k = jax.lax.fori_loop(
        0, n_sph, body,
        (jnp.full(time.shape, jnp.inf, jnp.float32),
         jnp.zeros(time.shape, jnp.int32)))
    t_out[...] = best_t
    k_out[...] = best_k


@functools.partial(jax.jit, static_argnames=("tmin", "interpret"))
def nearest_sphere(spheres: Spheres, origin, direction, time,
                   tmin: float = intersect.T_MIN, interpret: bool = False):
    """(t, sphere index) of the nearest hit per lane -> ((L,), (L,)).

    ``t`` is +inf on a miss (index 0 then, as ``argmin`` gives)."""
    lanes = time.shape[0]
    padded = -(-lanes // BLOCK) * BLOCK
    n_sph = spheres.radius.shape[0]
    cols = [origin[:, j] for j in range(3)] + [direction[:, j] for j in range(3)]
    cols = [jnp.pad(c.astype(jnp.float32), (0, padded - lanes))
            for c in [*cols, time]]
    sph = jnp.concatenate(
        [spheres.center0, spheres.dcenter, spheres.radius[:, None],
         jnp.zeros((n_sph, 1), spheres.radius.dtype)], axis=1,
    ).astype(jnp.float32).reshape(-1)
    sph = jnp.pad(sph, (0, pl.next_power_of_2(sph.shape[0]) - sph.shape[0]))
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    t, k = pl.pallas_call(
        functools.partial(_sweep_kernel, n_sph=n_sph, tmin=tmin),
        grid=(padded // BLOCK,),
        in_specs=[lane_spec] * 7 + [pl.BlockSpec(sph.shape, lambda i: (0,))],
        out_specs=[lane_spec, lane_spec],
        out_shape=[jax.ShapeDtypeStruct((padded,), jnp.float32),
                   jax.ShapeDtypeStruct((padded,), jnp.int32)],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="nearest_sphere_sweep",
    )(*cols, sph)
    return t[:lanes], k[:lanes]


def applies(scene: Scene) -> bool:
    """Whether the forward renderer takes this kernel: sphere-only scenes
    on a GPU, where it beat XLA's fusion of ``intersect.sphere_ts`` end
    to end on the cover scene.  Elsewhere the plain sweep runs."""
    return (scene.n_triangles == 0 and scene.n_spheres > 0
            and jax.default_backend() == "gpu")


def nearest_hit(scene: Scene, origin, direction, time,
                tmin: float = intersect.T_MIN, cull_backfaces: bool = True):
    """Drop-in for ``intersect.nearest_hit_bruteforce`` on sphere-only
    scenes (forward rendering; no gradient flows through the search)."""
    t, k = nearest_sphere(scene.spheres, origin, direction, time, tmin)
    return intersect.hit_record_from(scene, origin, direction, time, t, k,
                                     cull_backfaces=cull_backfaces)
