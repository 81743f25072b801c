"""Observability: timing, throughput accounting, and profiler traces.

The reference's observability is a wall-clock print and a scanline ticker
on stderr (reference src/render.cpp:139-141, :154, :188-190) plus ad-hoc
Linux ``perf`` (perf.data in .gitignore:6).  Equivalents here:

* ``RenderStats`` — wall time + primary-ray and estimated total-ray
  throughput (the Mrays/s the north star tracks),
* ``trace_profile`` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable trace directory,
* ``bvh_quality`` — the analogue of the reference's ``stupid_volume``
  BVH diagnostic (render.cpp:37-50): overlap volume between sibling
  subtrees summed over inner nodes, printed per render when verbose.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class RenderStats:
    """Wall time + throughput for one render — printed by every
    progress-enabled render path (the reference prints "Done in Nms",
    src/render.cpp:188-190; we add the north-star Mrays/s)."""

    wall_s: float
    n_pixels: int
    spp: int
    max_depth: int
    n_devices: int = 1

    @property
    def primary_rays(self) -> int:
        return self.n_pixels * self.spp

    @property
    def primary_mrays_per_s(self) -> float:
        return self.primary_rays / self.wall_s / 1e6

    def summary(self) -> str:
        import jax

        n = f"{self.n_devices} x " if self.n_devices > 1 else ""
        return (
            f"Done in {int(self.wall_s * 1000)}ms "
            f"({self.primary_mrays_per_s:.2f} Mprimary-rays/s, "
            f"{self.n_pixels}px x {self.spp}spp, depth {self.max_depth}, "
            f"{n}{jax.devices()[0].device_kind})"
        )


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"profile trace written to {log_dir}", file=sys.stderr)


def bvh_quality(bvh) -> float:
    """Sum over inner nodes of (parent volume − child volumes) — the
    reference's ``stupid_volume`` tree-quality smell (render.cpp:37-50).
    Lower is tighter; 0 means children perfectly partition each parent."""
    bmin = np.asarray(bvh.bbox_min, np.float64)
    bmax = np.asarray(bvh.bbox_max, np.float64)
    count = np.asarray(bvh.count)
    skip = np.asarray(bvh.skip)
    n = count.shape[0]
    vol = np.prod(np.maximum(bmax - bmin, 0.0), axis=1)
    total = 0.0
    for node in range(n):
        if count[node] == 0:  # inner: children are node+1 and skip[node+1]
            left = node + 1
            right = skip[left]
            total += abs(vol[node] - vol[left] - vol[right])
    return float(total)
