"""Device-mesh construction for sharded rendering.

The reference's only parallelism is a ``std::async`` fan-out over
samples-per-pixel shards (reference src/render.cpp:172-175).  Here the
layout is a 2-D ``jax.sharding.Mesh``:

* axis ``"tile"`` — pixel-domain decomposition: each device owns a
  contiguous block of pixels (the scene is tiny and replicated, so this
  axis scales the framebuffer),
* axis ``"spp"``  — sample decomposition: devices along this axis trace
  disjoint sample shards of the *same* pixels and ``psum`` their
  radiance (the direct analogue of the reference's per-thread
  image sum, src/render.cpp:176-180, minus the integer-division spp loss).

Multi-host: `jax.distributed.initialize()` before mesh construction makes
`jax.devices()` span hosts; the same mesh code then lays tiles×spp over
every device (XLA inserts the collectives).  The cards of one host are
joined all to all, so the mesh follows the algorithm alone.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tile"
SPP_AXIS = "spp"


def choose_split(n_devices: int, spp: int) -> Tuple[int, int]:
    """Pick (tile_shards, spp_shards) with tile_shards * spp_shards == n.

    Prefer sample sharding (communication = one small psum of the local
    framebuffer) while each spp shard keeps >= 4 samples; put the rest
    on the pixel axis.
    """
    best = (n_devices, 1)
    for spp_shards in range(n_devices, 0, -1):
        if n_devices % spp_shards:
            continue
        if spp % spp_shards:
            continue
        if spp // spp_shards >= 4 or spp_shards == 1:
            best = (n_devices // spp_shards, spp_shards)
            break
    return best


def make_mesh(
    n_devices: Optional[int] = None,
    spp: int = 16,
    devices: Optional[Sequence[jax.Device]] = None,
    tile_shards: Optional[int] = None,
    spp_shards: Optional[int] = None,
) -> Mesh:
    """Build the (tile, spp) render mesh over ``n_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = list(devices)[:n_devices]
    if tile_shards is None or spp_shards is None:
        tile_shards, spp_shards = choose_split(n_devices, spp)
    if tile_shards * spp_shards != n_devices:
        raise ValueError(
            f"tile_shards({tile_shards}) * spp_shards({spp_shards}) != {n_devices}"
        )
    dev_grid = np.asarray(devices).reshape(tile_shards, spp_shards)
    return Mesh(dev_grid, (TILE_AXIS, SPP_AXIS))
