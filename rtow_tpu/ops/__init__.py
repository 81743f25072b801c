"""Compute ops: vector math, intersection, BVH, lights, media and the
wavefront integrator.

Submodules are imported directly (``from rtow_tpu.ops import integrator``)
rather than re-exported here: ``models`` depends on ``ops.vec`` while
``ops.integrator`` depends on ``models``, so eager re-exports would cycle.
"""
from . import vec
