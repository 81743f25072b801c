"""Top-level renderer — the analogue of ``rt::render``
(reference src/render.cpp:135-191).

The reference fans the sample budget out over ``std::async`` threads,
each re-rendering the whole frame, and sums the per-thread images.  Here
the (pixel × sample) lane space is flattened pixel-major, cut into
chunks that bound peak device memory, and traced chunk-by-chunk by one
jitted chunk function.  Because lanes are pixel-major and the chunk size
is a multiple of spp, each chunk's radiance reduces to a contiguous pixel
block, and the frame is their concatenation.

Device parallelism lives in ``rtow_tpu.parallel`` (mesh-sharded lanes +
psum), not here.  Unlike the reference, spp accounting is exact — no
silent ``spp / nthreads`` floor division (src/render.cpp:174,185 quirk,
fixed per SURVEY.md quirks ledger).
"""
from __future__ import annotations

import functools
import sys
import time as _time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .models.camera import Camera, camera_rays, pixel_coords
from .models.scene import Scene
from .ops import integrator


def chunk_radiance(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    pixel_ids: jax.Array,
    spp_limit,
    *,
    spp_cap: int,
    width: int,
    height: int,
    max_depth: int,
    nearest_hit: Optional[Callable],
    cull_backfaces: bool,
    russian_roulette: bool = False,
) -> jax.Array:
    """Trace spp samples for each pixel id -> per-pixel radiance sums (P, 3).

    ``spp_limit`` is a scalar or per-pixel (P,) sample budget — 0 disables a
    lane (padding pixels, spp-remainder shards).

    BVH scenes take the scan-based flat-wavefront path: the stackless
    traversal is itself a ``while_loop``, and it runs inside a
    fixed-depth ``scan`` rather than inside the progressive integrator's
    ``while_loop``."""
    if nearest_hit is not None:
        return _chunk_radiance_flat(
            scene, camera, key, pixel_ids, spp_limit, spp_cap,
            width=width, height=height, max_depth=max_depth,
            nearest_hit=nearest_hit, cull_backfaces=cull_backfaces,
            russian_roulette=russian_roulette,
        )
    return integrator.trace_progressive(
        scene, camera, key, pixel_ids,
        spp=spp_limit, max_depth=max_depth, width=width, height=height,
        nearest_hit=nearest_hit, cull_backfaces=cull_backfaces,
        russian_roulette=russian_roulette,
    )


def _chunk_radiance_flat(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    pixel_ids: jax.Array,
    spp_limit,
    spp_max: int,
    *,
    width: int,
    height: int,
    max_depth: int,
    nearest_hit: Callable,
    cull_backfaces: bool,
    russian_roulette: bool = False,
) -> jax.Array:
    """Flat (pixel x sample) wavefront with the scan integrator -> (P, 3).

    ``spp_max`` is the static per-pixel sample budget; ``spp_limit``
    (scalar or per-pixel array <= spp_max) masks the tail."""
    lane_pix = jnp.repeat(pixel_ids, spp_max)
    s_idx = jnp.tile(jnp.arange(spp_max, dtype=jnp.int32), pixel_ids.shape[0])
    valid = s_idx < (
        jnp.repeat(jnp.broadcast_to(jnp.asarray(spp_limit), pixel_ids.shape),
                   spp_max)
    )
    k_pix, k_cam, k_trace = jax.random.split(key, 3)
    s, t = pixel_coords(width, height, k_pix, lane_pix,
                        dtype=camera.origin.dtype)
    rays = camera_rays(camera, k_cam, s, t)
    radiance = integrator.trace(
        scene, rays, k_trace, max_depth,
        nearest_hit=nearest_hit, cull_backfaces=cull_backfaces,
        russian_roulette=russian_roulette,
    )
    radiance = jnp.where(valid[..., None], radiance, 0.0)
    return radiance.reshape(pixel_ids.shape[0], spp_max, 3).sum(axis=1)


def _scanline_tick(c, *, ppc, width, height):
    """Carriage-return progress ticker — the reference prints
    "Scanlines remaining: N" per row (src/render.cpp:154); we print per
    chunk (the scheduler's unit of work) as each one finishes."""
    done_rows = min((c + 1) * ppc // width, height)
    print(f"\rScanlines remaining: {height - done_rows}   ",
          end="" if done_rows < height else "\n", file=sys.stderr, flush=True)


def _chunk(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    c: jax.Array,
    *,
    n_pixels: int,
    ppc: int,
    spp: int,
    width: int,
    height: int,
    max_depth: int,
    nearest_hit: Optional[Callable],
    cull_backfaces: bool,
    russian_roulette: bool = False,
) -> jax.Array:
    """Radiance sums of pixel chunk ``c`` -> (ppc, 3); padding pixels past
    ``n_pixels`` trace no samples."""
    pixel_ids = c * ppc + jnp.arange(ppc, dtype=jnp.int32)
    spp_limit = jnp.where(pixel_ids < n_pixels, spp, 0)
    pix_safe = jnp.minimum(pixel_ids, n_pixels - 1)
    return chunk_radiance(
        scene, camera, jax.random.fold_in(key, c), pix_safe, spp_limit,
        spp_cap=spp, width=width, height=height, max_depth=max_depth,
        nearest_hit=nearest_hit, cull_backfaces=cull_backfaces,
        russian_roulette=russian_roulette,
    )


def render(
    scene: Scene,
    camera: Camera,
    cfg: Config,
    key: Optional[jax.Array] = None,
    nearest_hit: Optional[Callable] = None,
    cull_backfaces: bool = True,
    progress: bool = False,
) -> np.ndarray:
    """Render the mean-radiance image (H, W, 3) float, row 0 = top.

    Single-device path; ``rtow_tpu.parallel.render_sharded`` is the
    multi-chip version.  Chunks are dispatched from the host, one jitted
    call each (one compile serves them all); with ``progress`` the host
    waits for each and prints the ticker between them, so no callback
    runs inside the compiled computation.
    """
    width, height = cfg.image_width, cfg.image_height
    spp = cfg.samples_per_pixel
    n_pixels = width * height
    # Pixels per chunk: the progressive path uses one persistent lane per
    # pixel; the flat BVH path expands to (pixel x sample) lanes, so its
    # pixel budget shrinks by spp.
    if nearest_hit is None:
        ppc = min(cfg.rays_per_batch, n_pixels)
    else:
        ppc = min(max(cfg.rays_per_batch // spp, 1), n_pixels)
    n_chunks = -(-n_pixels // ppc)

    if key is None:
        key = jax.random.key(cfg.seed)

    chunk = jax.jit(
        functools.partial(
            _chunk,
            n_pixels=n_pixels,
            ppc=ppc,
            spp=spp,
            width=width,
            height=height,
            max_depth=cfg.max_child_rays,
            nearest_hit=nearest_hit,
            cull_backfaces=cull_backfaces,
            russian_roulette=cfg.russian_roulette,
        )
    )

    t_start = _time.perf_counter()
    parts = []
    for c in range(n_chunks):
        parts.append(chunk(scene, camera, key, jnp.int32(c)))
        if progress and n_chunks > 1:
            parts[-1].block_until_ready()
            _scanline_tick(c, ppc=ppc, width=width, height=height)
    fb = jnp.concatenate(parts)
    fb.block_until_ready()
    elapsed = _time.perf_counter() - t_start
    if progress:
        from .utils.profiling import RenderStats

        stats = RenderStats(elapsed, n_pixels, spp, cfg.max_child_rays)
        print(stats.summary(), file=sys.stderr)

    mean = np.asarray(fb, dtype=np.float64)[:n_pixels].reshape(height, width, 3) / spp
    return mean
