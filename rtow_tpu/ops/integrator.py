"""Wavefront path-tracing integrator.

The reference estimates radiance with bounded recursion per ray
(``ray_color``, reference src/render.cpp:112-129).  Recursion is
anathema to XLA; here the whole wavefront advances together through an
iterative bounce loop (``lax.fori_loop``) carrying masked per-lane state
(origin, direction, time, throughput, radiance, alive) — the classic
wavefront formulation of a path tracer.

Semantics replicated exactly (SURVEY.md §3.2):
 * miss  -> radiance += throughput * sky gradient; lane dies,
 * hit with exhausted bounce budget -> black (the reference checks depth
   *after* the hit test, src/render.cpp:113-115: budget ``D`` allows D
   scatters and D+1 hit tests),
 * scatter -> throughput *= attenuation, ray moves to the hit point.

The loop is differentiable w.r.t. scene geometry/materials (grads flow
through hit positions, normals and attenuations; the discrete hit/miss
and material choices are treated as piecewise-constant).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.camera import Rays
from ..models.materials import background_color, emitted, scatter
from ..models.scene import CHECKER, EMISSIVE, IMAGE, LAMBERTIAN, NOISE, Scene
from . import intersect


class WavefrontState(NamedTuple):
    origin: jax.Array  # (L, 3)
    direction: jax.Array  # (L, 3)
    time: jax.Array  # (L,)
    throughput: jax.Array  # (L, 3)
    radiance: jax.Array  # (L, 3)
    alive: jax.Array  # (L,) bool
    #: NEE/MIS only: solid-angle pdf of the previous (Lambertian)
    #: scatter, 0 for camera/specular rays — emission on this ray's
    #: next hit is weighted by the balance heuristic
    #: prev_pdf / (prev_pdf + light_pdf) so the path is shared with
    #: that bounce's direct-light sample instead of double-counted.
    prev_pdf: jax.Array


NearestHitFn = Callable[..., "intersect.HitRecord"]

#: Russian roulette starts after this many scatters (paths shorter than
#: RR_START are never killed — bias-free variance control on the short
#: paths that carry most radiance).
RR_START = 3
#: Survival probability floor (clamp avoids unbounded 1/p boosts).
RR_PMIN = 0.05


def _roulette(key, throughput, alive, scatters_done, dtype):
    """Masked-lane Russian roulette (BASELINE north star; OFF by default
    to preserve reference fidelity — the reference terminates by depth
    budget alone, src/render.cpp:114-115).

    After RR_START scatters a lane survives with probability
    p = clamp(max throughput channel, RR_PMIN, 1) and its throughput is
    boosted 1/p — an unbiased estimator by construction
    (E[I(u < p)/p] = 1), tested vs the plain estimator in
    tests/test_roulette.py.  Returns (throughput, alive).
    """
    u = jax.random.uniform(key, alive.shape, dtype=dtype)
    p = jnp.clip(jnp.max(throughput, axis=-1), RR_PMIN, 1.0)
    consider = alive & (scatters_done >= RR_START)
    kill = consider & (u >= p)
    boost = jnp.where(consider & ~kill, 1.0 / p, 1.0)
    return throughput * boost[..., None], alive & ~kill


def trace(
    scene: Scene,
    rays: Rays,
    key: jax.Array,
    max_depth: int,
    nearest_hit: Optional[NearestHitFn] = None,
    cull_backfaces: bool = True,
    grad_reduce_axes: tuple = (),
    nee: Optional[bool] = None,
    russian_roulette: bool = False,
) -> jax.Array:
    """Trace a wavefront to completion -> per-lane radiance (L, 3).

    ``max_depth`` is the reference's ``max_child_rays`` bounce budget
    (src/render.h:17).  ``nearest_hit`` defaults to the brute-force sweep;
    the BVH traversal slots in through the same signature.

    ``grad_reduce_axes``: mesh axis names to ``psum`` scene cotangents
    over *per bounce* in the backward scan (overlapped gradient
    all-reduce — see :func:`rtow_tpu.diff.psum_in_bwd`).  Only valid
    under ``shard_map`` with those axes; the resulting scene gradient is
    then already globally reduced.

    ``nee``: next-event estimation (ops/lights.py) — sample a light
    directly at every Lambertian hit and suppress emission on that
    ray's next hit.  Same expectation as the plain estimator, far lower
    variance for small lights.  Default: on for emissive scenes.  The
    gradient path (diff.py) passes ``nee=False`` — light-sample
    reparameterization is out of scope, and the plain estimator's
    gradients are already exact.

    ``russian_roulette``: probabilistically kill low-throughput lanes
    after RR_START scatters (see :func:`_roulette`).  Off by default —
    the reference terminates by depth budget only.
    """
    if nearest_hit is None:
        nearest_hit = intersect.nearest_hit_bruteforce
    if nee is None:
        nee = scene.has_emissive and bool(scene.light_ids)
    if nee:
        from .lights import (
            build_light_table, light_pdf_toward, sample_light_dirs,
        )

        ltable = build_light_table(scene)
        lkinds = tuple(k for k, _ in scene.light_ids)
    vkinds = scene.volume_kinds
    if vkinds:
        from ..utils import rng as _rng
        from .volumes import build_volume_table, sample_volume_event

        vtable, valbedo = build_volume_table(scene)

    dtype = rays.origin.dtype
    lanes = rays.time.shape

    init = WavefrontState(
        origin=rays.origin,
        direction=rays.direction,
        time=rays.time,
        throughput=jnp.ones((*lanes, 3), dtype=dtype),
        radiance=jnp.zeros((*lanes, 3), dtype=dtype),
        alive=jnp.ones(lanes, dtype=bool),
        prev_pdf=jnp.zeros(lanes, dtype=dtype),
    )

    def bounce(st: WavefrontState, i: jax.Array):
        if grad_reduce_axes:
            from ..diff import psum_in_bwd

            scene_b = psum_in_bwd(scene, grad_reduce_axes)
        else:
            scene_b = scene
        rec = nearest_hit(
            scene_b, st.origin, st.direction, st.time,
            cull_backfaces=cull_backfaces
        )

        if vkinds:
            # Constant-density media (ops/volumes.py): a free-flight
            # scatter before the surface hit overrides the surface
            # interaction (and the sky on misses).
            k_vol = jax.random.fold_in(jax.random.fold_in(key, i), 104729)
            us = jax.random.uniform(k_vol, (len(vkinds), *lanes),
                                    dtype=dtype)
            v_hit, t_v, (var_, vag_, vab_) = sample_volume_event(
                vtable, valbedo, vkinds, us,
                st.origin[..., 0], st.origin[..., 1], st.origin[..., 2],
                st.direction[..., 0], st.direction[..., 1],
                st.direction[..., 2],
                jnp.where(rec.hit, rec.t, jnp.inf),
            )
            v_hit = v_hit & st.alive
            v_can = v_hit & (i < max_depth)
            v_point = st.origin + t_v[..., None] * st.direction
            v_alb = jnp.stack([var_, vag_, vab_], axis=-1).astype(dtype)
            k_iso = jax.random.fold_in(jax.random.fold_in(key, i), 60013)
            v_dir = _rng.unit_vectors(k_iso, lanes, dtype=dtype)
        else:
            v_hit = v_can = jnp.zeros(lanes, dtype=bool)

        missed = st.alive & ~rec.hit & ~v_hit
        radiance = st.radiance + jnp.where(
            missed[..., None],
            st.throughput * background_color(scene, st.direction), 0.0,
        )

        # A hit on the final iteration has no scatter budget left -> black
        # (reference src/render.cpp:114-115).
        can_scatter = st.alive & rec.hit & (i < max_depth) & ~v_hit
        if scene.has_emissive:
            # Emission needs no scatter budget: add on every live hit,
            # then retire the lane (diffuse_light semantics).  Under NEE
            # a ray that came off a Lambertian bounce skips it — that
            # bounce's direct-light sample already counted this path.
            is_emis = rec.mat_kind == EMISSIVE
            lit = st.alive & rec.hit & is_emis & ~v_hit
            w_emit = jnp.ones(lanes, dtype=dtype)
            if nee:
                # MIS balance heuristic: a BRDF-sampled emissive hit
                # shares its path with the previous bounce's light
                # sample; weight by pdf_brdf/(pdf_brdf + pdf_light).
                p_light = light_pdf_toward(
                    ltable, lkinds,
                    st.origin[..., 0], st.origin[..., 1],
                    st.origin[..., 2],
                    st.direction[..., 0], st.direction[..., 1],
                    st.direction[..., 2], rec.t, st.time,
                ).astype(dtype)
                w_emit = jnp.where(
                    st.prev_pdf > 0.0,
                    st.prev_pdf / jnp.maximum(st.prev_pdf + p_light,
                                              1e-12),
                    1.0)
            radiance = radiance + jnp.where(
                lit[..., None],
                st.throughput * emitted(rec) * w_emit[..., None], 0.0,
            )
            can_scatter = can_scatter & ~is_emis

        is_diffuse = ((rec.mat_kind == LAMBERTIAN)
                      | (rec.mat_kind == CHECKER)
                      | (rec.mat_kind == NOISE)
                      | (rec.mat_kind == IMAGE))
        if nee:
            k_nee = jax.random.fold_in(jax.random.fold_in(key, i), 7919)
            pick, u1, u2 = jax.random.uniform(k_nee, (3, *lanes),
                                              dtype=dtype)
            # Shading point: the volume event's when one fired.
            spoint = (jnp.where(v_can[..., None], v_point, rec.point)
                      if vkinds else rec.point)
            ldx, ldy, ldz, t_l, (w0, w1, w2), l_pdf = sample_light_dirs(
                ltable, lkinds, pick, u1, u2,
                spoint[..., 0], spoint[..., 1], spoint[..., 2],
                st.time,
            )
            ldir = jnp.stack([ldx, ldy, ldz], axis=-1)
            srec = nearest_hit(scene_b, spoint, ldir, st.time,
                               cull_backfaces=cull_backfaces)
            open_ = (~srec.hit) | (srec.t >= t_l * (1.0 - 1e-3))
            cos_t = jnp.maximum(
                jnp.sum(rec.normal * ldir, axis=-1), 0.0)
            # Balance heuristic vs the BRDF strategy: cosine pdf at
            # surfaces, the constant 1/(4 pi) phase at volume events
            # (where the cos factor becomes 1/4 — see ops/volumes.py).
            phase = cos_t / jnp.pi
            factor = cos_t
            calbedo = rec.albedo
            if vkinds:
                inv4pi = jnp.asarray(1.0 / (4.0 * np.pi), dtype)
                phase = jnp.where(v_can, inv4pi, phase)
                factor = jnp.where(v_can, 0.25, factor)
                calbedo = jnp.where(v_can[..., None], v_alb, calbedo)
            w_l = l_pdf / jnp.maximum(l_pdf + phase, 1e-12)
            if vkinds:
                from .volumes import volume_transmittance

                factor = factor * volume_transmittance(
                    vtable, vkinds,
                    spoint[..., 0], spoint[..., 1], spoint[..., 2],
                    ldx, ldy, ldz, t_l).astype(dtype)
            direct = (calbedo * jnp.stack([w0, w1, w2], axis=-1)
                      * (factor * w_l)[..., None])
            add = ((can_scatter & is_diffuse) | v_can) & open_
            radiance = radiance + jnp.where(
                add[..., None], st.throughput * direct, 0.0)

        sc = scatter(jax.random.fold_in(key, i), st.direction, rec)
        origin = jnp.where(can_scatter[..., None], rec.point, st.origin)
        direction = jnp.where(can_scatter[..., None], sc.direction, st.direction)
        throughput = jnp.where(
            can_scatter[..., None], st.throughput * sc.attenuation, st.throughput
        )
        alive = can_scatter
        if nee:
            # True scatter cosine: directions are raw n + unit.
            dlen = jnp.sqrt(jnp.maximum(
                jnp.sum(sc.direction * sc.direction, axis=-1), 1e-24))
            cos_new = jnp.maximum(
                jnp.sum(rec.normal * sc.direction, axis=-1), 0.0) / dlen
            prev_pdf = jnp.where(can_scatter & is_diffuse,
                                 cos_new / jnp.pi, 0.0)
        else:
            prev_pdf = st.prev_pdf
        if vkinds:
            # Volume event: isotropic scatter from the free-flight
            # point; throughput picks up the medium's albedo.
            origin = jnp.where(v_can[..., None], v_point, origin)
            direction = jnp.where(v_can[..., None], v_dir, direction)
            throughput = jnp.where(v_can[..., None],
                                   st.throughput * v_alb, throughput)
            alive = alive | v_can
            if nee:
                prev_pdf = jnp.where(
                    v_can, jnp.asarray(1.0 / (4.0 * np.pi), dtype),
                    prev_pdf)
        if russian_roulette:
            k_rr = jax.random.fold_in(jax.random.fold_in(key, i), 52361)
            throughput, alive = _roulette(k_rr, throughput, alive, i, dtype)
        return (
            WavefrontState(origin, direction, st.time, throughput, radiance,
                           alive, prev_pdf),
            None,
        )

    # D scatters require D+1 intersection tests (depth checked after the
    # hit test in the reference).  lax.scan (not while_loop) so the loop
    # is reverse-mode differentiable; jax.checkpoint makes the backward
    # keep only each bounce's carry and recompute the bounce, instead of
    # stacking every bounce's (lanes x primitives) residuals.
    final, _ = jax.lax.scan(jax.checkpoint(bounce), init,
                            jnp.arange(max_depth + 1))
    return final.radiance


def trace_progressive(
    scene: Scene,
    camera,
    key: jax.Array,
    pixel_ids: jax.Array,
    *,
    spp: int,
    max_depth: int,
    width: int,
    height: int,
    nearest_hit: Optional[NearestHitFn] = None,
    cull_backfaces: bool = True,
    russian_roulette: bool = False,
) -> jax.Array:
    """Persistent-wavefront render: (P,) pixels -> (P, 3) radiance sums.

    One lane per pixel; each lane traces its ``spp`` samples
    *sequentially*, regenerating a fresh camera ray the moment the
    previous sample's path dies, and accumulates radiance locally.  The
    loop ends when every lane has finished all its samples.

    Why: a flat (pixel × sample) wavefront runs every bounce iteration at
    full width until the *longest* path in the chunk finishes (~max_depth
    for any glass path), while the mean path is ~5 bounces — >10x wasted
    lanes.  Lane-local regeneration keeps utilisation near 100% with zero
    scatters (each lane owns one pixel, so accumulation is elementwise).
    Total iterations ~ spp x mean_path + tail instead of ~max_path, a
    ~5x speedup at spp>=8 on the cover scene.  Forward-only
    (while_loop); use :func:`trace` for gradients.  With no
    ``nearest_hit`` the search is the sweep of ``ops.sphere_sweep`` where
    it applies, the plain fused sweep otherwise.
    """
    from ..models.camera import camera_rays, pixel_coords
    from . import sphere_sweep

    if nearest_hit is None:
        nearest_hit = (sphere_sweep.nearest_hit if sphere_sweep.applies(scene)
                       else intersect.nearest_hit_bruteforce)
    nee = scene.has_emissive and bool(scene.light_ids)
    if nee:
        from .lights import (
            build_light_table, light_pdf_toward, sample_light_dirs,
        )

        ltable = build_light_table(scene)
        lkinds = tuple(k for k, _ in scene.light_ids)
    vkinds = scene.volume_kinds
    if vkinds:
        from ..utils import rng as _rng
        from .volumes import build_volume_table, sample_volume_event

        vtable, valbedo = build_volume_table(scene)

    n_pix = pixel_ids.shape[0]
    dtype = camera.origin.dtype
    zeros3 = jnp.zeros((n_pix, 3), dtype=dtype)

    class _St(NamedTuple):
        origin: jax.Array
        direction: jax.Array
        time: jax.Array
        throughput: jax.Array
        radiance: jax.Array
        alive: jax.Array
        bounce: jax.Array  # scatters used by the current sample
        started: jax.Array  # samples begun on this lane
        it: jax.Array
        prev_pdf: jax.Array  # NEE/MIS: previous scatter's pdf (0 = specular)

    init = _St(
        origin=zeros3,
        direction=jnp.ones((n_pix, 3), dtype=dtype),  # benign placeholder
        time=jnp.zeros((n_pix,), dtype=dtype),
        throughput=zeros3,
        radiance=zeros3,
        alive=jnp.zeros((n_pix,), dtype=bool),
        bounce=jnp.zeros((n_pix,), jnp.int32),
        started=jnp.zeros((n_pix,), jnp.int32),
        it=jnp.int32(0),
        prev_pdf=jnp.zeros((n_pix,), dtype=dtype),
    )

    def cond(st: _St):
        return jnp.any(st.alive | (st.started < spp))

    def body(st: _St) -> _St:
        k = jax.random.fold_in(key, st.it)
        k_pix, k_cam, k_trace = jax.random.split(k, 3)

        # Regenerate: idle lanes with samples left start a fresh camera ray.
        need = (~st.alive) & (st.started < spp)
        s, t = pixel_coords(width, height, k_pix, pixel_ids, dtype=dtype)
        rays = camera_rays(camera, k_cam, s, t)
        nd = need[..., None]
        origin = jnp.where(nd, rays.origin, st.origin)
        direction = jnp.where(nd, rays.direction, st.direction)
        time = jnp.where(need, rays.time, st.time)
        throughput = jnp.where(nd, 1.0, st.throughput)
        bounce = jnp.where(need, 0, st.bounce)
        started = st.started + need.astype(jnp.int32)
        alive = st.alive | need
        prev_pdf = jnp.where(need, 0.0, st.prev_pdf)

        # One bounce for every live lane (reference semantics: miss -> sky,
        # depth-exhausted hit -> black, src/render.cpp:112-129).
        rec = nearest_hit(scene, origin, direction, time,
                          cull_backfaces=cull_backfaces)
        if vkinds:
            k_vol = jax.random.fold_in(k, 104729)
            us = jax.random.uniform(k_vol, (len(vkinds), n_pix),
                                    dtype=dtype)
            v_hit, t_v, (var_, vag_, vab_) = sample_volume_event(
                vtable, valbedo, vkinds, us,
                origin[..., 0], origin[..., 1], origin[..., 2],
                direction[..., 0], direction[..., 1], direction[..., 2],
                jnp.where(rec.hit, rec.t, jnp.inf),
            )
            v_hit = v_hit & alive
            v_can = v_hit & (bounce < max_depth)
            v_point = origin + t_v[..., None] * direction
            v_alb = jnp.stack([var_, vag_, vab_], axis=-1).astype(dtype)
            v_dir = _rng.unit_vectors(jax.random.fold_in(k, 60013),
                                      (n_pix,), dtype=dtype)
        else:
            v_hit = v_can = jnp.zeros((n_pix,), dtype=bool)
        missed = alive & ~rec.hit & ~v_hit
        radiance = st.radiance + jnp.where(
            missed[..., None],
            throughput * background_color(scene, direction), 0.0,
        )
        can = alive & rec.hit & (bounce < max_depth) & ~v_hit
        if scene.has_emissive:
            is_emis = rec.mat_kind == EMISSIVE
            lit = alive & rec.hit & is_emis & ~v_hit
            w_emit = jnp.ones((n_pix,), dtype=dtype)
            if nee:
                # MIS: weight BRDF-sampled emission by the balance
                # heuristic against the light strategy (see trace()).
                p_light = light_pdf_toward(
                    ltable, lkinds,
                    origin[..., 0], origin[..., 1], origin[..., 2],
                    direction[..., 0], direction[..., 1],
                    direction[..., 2], rec.t, time,
                ).astype(dtype)
                w_emit = jnp.where(
                    prev_pdf > 0.0,
                    prev_pdf / jnp.maximum(prev_pdf + p_light, 1e-12),
                    1.0)
            radiance = radiance + jnp.where(
                lit[..., None],
                throughput * emitted(rec) * w_emit[..., None], 0.0,
            )
            can = can & ~is_emis
        is_diffuse = ((rec.mat_kind == LAMBERTIAN)
                      | (rec.mat_kind == CHECKER)
                      | (rec.mat_kind == NOISE)
                      | (rec.mat_kind == IMAGE))
        if nee:
            k_nee = jax.random.fold_in(k, 7919)
            pick, u1, u2 = jax.random.uniform(k_nee, (3, n_pix),
                                              dtype=dtype)
            spoint = (jnp.where(v_can[..., None], v_point, rec.point)
                      if vkinds else rec.point)
            ldx, ldy, ldz, t_l, (w0, w1, w2), l_pdf = sample_light_dirs(
                ltable, lkinds, pick, u1, u2,
                spoint[..., 0], spoint[..., 1], spoint[..., 2],
                time,
            )
            ldir = jnp.stack([ldx, ldy, ldz], axis=-1)
            srec = nearest_hit(scene, spoint, ldir, time,
                               cull_backfaces=cull_backfaces)
            open_ = (~srec.hit) | (srec.t >= t_l * (1.0 - 1e-3))
            cos_t = jnp.maximum(jnp.sum(rec.normal * ldir, axis=-1), 0.0)
            phase = cos_t / jnp.pi
            factor = cos_t
            calbedo = rec.albedo
            if vkinds:
                inv4pi = jnp.asarray(1.0 / (4.0 * np.pi), dtype)
                phase = jnp.where(v_can, inv4pi, phase)
                factor = jnp.where(v_can, 0.25, factor)
                calbedo = jnp.where(v_can[..., None], v_alb, calbedo)
            w_l = l_pdf / jnp.maximum(l_pdf + phase, 1e-12)
            if vkinds:
                from .volumes import volume_transmittance

                factor = factor * volume_transmittance(
                    vtable, vkinds,
                    spoint[..., 0], spoint[..., 1], spoint[..., 2],
                    ldx, ldy, ldz, t_l).astype(dtype)
            direct = (calbedo * jnp.stack([w0, w1, w2], axis=-1)
                      * (factor * w_l)[..., None])
            add = ((can & is_diffuse) | v_can) & open_
            radiance = radiance + jnp.where(
                add[..., None], throughput * direct, 0.0)
        sc = scatter(k_trace, direction, rec)
        cd = can[..., None]
        n_origin = jnp.where(cd, rec.point, origin)
        n_dir = jnp.where(cd, sc.direction, direction)
        n_tp = jnp.where(cd, throughput * sc.attenuation, throughput)
        n_alive = can
        n_pdf = (jnp.where(
            can & is_diffuse,
            jnp.maximum(jnp.sum(rec.normal * sc.direction, axis=-1),
                        0.0) / (jnp.pi * jnp.sqrt(jnp.maximum(
                            jnp.sum(sc.direction * sc.direction,
                                    axis=-1), 1e-24))),
            0.0) if nee else prev_pdf)
        if vkinds:
            vc = v_can[..., None]
            n_origin = jnp.where(vc, v_point, n_origin)
            n_dir = jnp.where(vc, v_dir, n_dir)
            n_tp = jnp.where(vc, throughput * v_alb, n_tp)
            n_alive = n_alive | v_can
            if nee:
                n_pdf = jnp.where(
                    v_can, jnp.asarray(1.0 / (4.0 * np.pi), dtype),
                    n_pdf)
        if russian_roulette:
            n_tp, n_alive = _roulette(
                jax.random.fold_in(k, 52361), n_tp, n_alive, bounce, dtype)
        return _St(
            origin=n_origin,
            direction=n_dir,
            time=time,
            throughput=n_tp,
            radiance=radiance,
            alive=n_alive,
            bounce=bounce + (can | v_can).astype(jnp.int32),
            started=started,
            it=st.it + 1,
            prev_pdf=n_pdf,
        )

    final = jax.lax.while_loop(cond, body, init)
    return final.radiance
