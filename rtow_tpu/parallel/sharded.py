"""Mesh-sharded rendering: ``shard_map`` over (tile, spp) + ``psum``.

The replacement for the reference's ``std::async`` fan-out
(reference src/render.cpp:172-180):

* the scene/BVH/camera are replicated (a few KB — same as the reference's
  shared read-only scene),
* devices along the ``tile`` axis own disjoint contiguous pixel blocks,
* devices along the ``spp`` axis trace disjoint sample shards of their
  pixel block and ``psum`` their radiance accumulator — the
  collective analogue of the reference's per-thread image sum,
* spp accounting is exact: remainder samples are masked, never dropped
  (the reference silently floor-divides spp across threads,
  src/render.cpp:174,185 — fixed per SURVEY.md quirks ledger).

Every lane derives its RNG key from (chunk, device) counters, so the
image is deterministic for a fixed mesh shape and seed regardless of
schedule — unlike the reference's racy shared mt19937.
"""
from __future__ import annotations

import functools
import sys
import time as _time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import Config
from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.dtypes import REAL
from .mesh import SPP_AXIS, TILE_AXIS, make_mesh


def _device_render_block(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    *,
    ppt: int,
    spp_local: int,
    spp: int,
    n_pixels: int,
    ppc: int,
    width: int,
    height: int,
    max_depth: int,
    nearest_hit: Optional[Callable],
    cull_backfaces: bool,
) -> jax.Array:
    """Render this device's (pixel-block × sample-shard) -> (ppt, 3) sum.

    Runs inside ``shard_map``: uses axis indices to locate the block,
    psums the result over the spp axis so every spp-peer holds the full
    sample sum for its pixel block.
    """
    ti = jax.lax.axis_index(TILE_AXIS)
    si = jax.lax.axis_index(SPP_AXIS)
    dev_key = jax.random.fold_in(jax.random.fold_in(key, ti), si)

    n_chunks = -(-ppt // ppc)
    # Exact spp: this shard owns samples [si*spp_local, ...) clipped to spp —
    # remainder shards trace fewer samples instead of dropping them
    # (reference floor-division quirk fixed, src/render.cpp:174,185).
    my_spp = jnp.clip(spp - si * spp_local, 0, spp_local)

    from ..render import chunk_radiance

    def chunk_body(c, fb):
        pix0 = c * ppc
        pix_local = pix0 + jnp.arange(ppc, dtype=jnp.int32)
        pix_global = ti * ppt + pix_local
        spp_limit = jnp.where(
            (pix_local < ppt) & (pix_global < n_pixels), my_spp, 0
        )
        pix_safe = jnp.minimum(pix_global, n_pixels - 1).astype(jnp.int32)
        sums = chunk_radiance(
            scene, camera, jax.random.fold_in(dev_key, c), pix_safe, spp_limit,
            spp_cap=spp_local, width=width, height=height, max_depth=max_depth,
            nearest_hit=nearest_hit, cull_backfaces=cull_backfaces,
        )
        return jax.lax.dynamic_update_slice(fb, sums, (pix0, 0))

    fb0 = jnp.zeros((ppc * n_chunks, 3), dtype=REAL)
    fb = jax.lax.fori_loop(0, n_chunks, chunk_body, fb0)[:ppt]
    # Collective sum over sample shards — the reference's image sum
    # (src/render.cpp:176-180) as one psum.
    return jax.lax.psum(fb, SPP_AXIS)


def build_sharded_step(
    mesh: Mesh,
    cfg: Config,
    nearest_hit: Optional[Callable] = None,
    cull_backfaces: bool = True,
):
    """Jitted sharded render step: (scene, camera, key) -> (pixels_pad, 3) sums.

    Returns (step_fn, meta) where meta carries the padded sizes needed to
    reassemble the image on host.
    """
    width, height = cfg.image_width, cfg.image_height
    spp = cfg.samples_per_pixel
    n_pixels = width * height
    tile_shards = mesh.shape[TILE_AXIS]
    spp_shards = mesh.shape[SPP_AXIS]
    ppt = -(-n_pixels // tile_shards)  # pixels per tile shard (padded)
    spp_local = -(-spp // spp_shards)  # samples per spp shard (masked)
    # Pixels per chunk, bounding peak lanes by rays_per_batch: the
    # progressive path runs one persistent lane per pixel; the flat BVH
    # path expands each pixel into spp_local lanes, so its pixel budget
    # shrinks by spp_local (mirrors render.py:163-166).
    if nearest_hit is None:
        ppc = min(cfg.rays_per_batch, ppt)
    else:
        ppc = min(max(cfg.rays_per_batch // spp_local, 1), ppt)

    block = functools.partial(
        _device_render_block,
        ppt=ppt,
        spp_local=spp_local,
        spp=spp,
        n_pixels=n_pixels,
        ppc=ppc,
        width=width,
        height=height,
        max_depth=cfg.max_child_rays,
        nearest_hit=nearest_hit,
        cull_backfaces=cull_backfaces,
    )

    sharded = shard_map(
        block,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # scene/camera/key replicated
        out_specs=P(TILE_AXIS, None),  # framebuffer sharded by pixel block
        check_vma=False,
    )
    step = jax.jit(sharded)
    meta = dict(ppt=ppt, spp_local=spp_local, tile_shards=tile_shards,
                spp_shards=spp_shards, n_pixels=n_pixels)
    return step, meta


def render_sharded(
    scene: Scene,
    camera: Camera,
    cfg: Config,
    key: Optional[jax.Array] = None,
    nearest_hit: Optional[Callable] = None,
    cull_backfaces: bool = True,
    progress: bool = False,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """Render the mean-radiance image (H, W, 3) on a device mesh."""
    if mesh is None:
        mesh = make_mesh(cfg.n_devices, cfg.samples_per_pixel)
    if key is None:
        key = jax.random.key(cfg.seed)

    step, meta = build_sharded_step(mesh, cfg, nearest_hit, cull_backfaces)
    t0 = _time.perf_counter()
    fb = step(scene, camera, key)
    fb.block_until_ready()
    elapsed = _time.perf_counter() - t0
    if progress:
        from ..utils.profiling import RenderStats

        stats = RenderStats(
            elapsed, meta["n_pixels"], cfg.samples_per_pixel,
            cfg.max_child_rays,
            n_devices=meta["tile_shards"] * meta["spp_shards"],
        )
        print(stats.summary(), file=sys.stderr)

    width, height = cfg.image_width, cfg.image_height
    fb_np = np.asarray(fb, dtype=np.float64)[: meta["n_pixels"]]
    return fb_np.reshape(height, width, 3) / cfg.samples_per_pixel
