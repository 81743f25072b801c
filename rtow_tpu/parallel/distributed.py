"""Multi-host bring-up: ``jax.distributed`` initialisation + global mesh.

The reference is strictly single-process (its only fan-out is
``std::async`` threads, reference src/render.cpp:172-175).  This
framework scales across hosts with JAX's built-in distributed runtime:
every host calls :func:`initialize` (coordinator address via env or
args), after which ``jax.devices()`` spans every host's devices and the
same (tile, spp) mesh code from ``parallel.mesh`` lays the render over
them — XLA inserts the collectives.

Host-local framebuffer assembly: ``render_sharded`` returns the full
(pixel, 3) sums on every host (the psum/all-gather semantics of
``out_specs``), so rank 0 simply writes the image.
"""
from __future__ import annotations

import os
import sys
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime (idempotent, single-host no-op).

    With no arguments, JAX reads the cluster from its environment
    (JAX_COORDINATOR_ADDRESS etc.); explicit args override for manual
    launches: ``initialize("host0:1234", 2, rank)``.
    """
    if num_processes is None and coordinator_address is None \
            and "JAX_COORDINATOR_ADDRESS" not in os.environ \
            and os.environ.get("JAX_NUM_PROCESSES", "1") in ("", "1"):
        return  # single host — nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    print(
        f"jax.distributed up: process {jax.process_index()}/"
        f"{jax.process_count()}, {jax.device_count()} global devices",
        file=sys.stderr,
    )


def is_primary() -> bool:
    """True on the host that should write output (rank 0)."""
    return jax.process_index() == 0
