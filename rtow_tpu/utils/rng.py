"""Counter-based random sampling for the tracer.

The reference funnels every random draw through one global, unseeded,
*unsynchronised* ``std::mt19937`` (reference src/random-utils.cpp:6-9) —
a data race under threads and a hidden sequencing dependency between scene
generation and rendering.  The replacement here is stateless,
counter-based sampling: every consumer derives its own key as
``fold_in(base, pixel/sample/bounce/purpose)`` so the stream is
race-free and bit-reproducible regardless of device count or schedule.

Sampling routines are *analytic* (no rejection loops): rejection sampling
is control-flow divergence across lanes.  Note the reference's
``random_unit_vector`` (src/random-utils.cpp:23-33) is biased — it samples
the positive octant of [0,1]^3 and never normalises.  We implement the
book-correct distributions instead (documented divergence, SURVEY.md §7
quirks ledger).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .dtypes import REAL


def uniform(key, shape=(), lo=0.0, hi=1.0, dtype=REAL) -> jax.Array:
    """U[lo, hi) — the analogue of ``random_double(a, b)``.

    Draws are always made at float32 resolution: under ``jax_enable_x64``
    a float64 request upcasts an f32 draw instead of consuming a 64-bit
    stream.  This keeps the random-number stream *bit-identical* across
    precisions, so the f64 oracle (tests/test_f64_oracle.py) compares
    f32-vs-f64 arithmetic under common random numbers — the only
    difference between the two renders is rounding, which is exactly
    what the oracle bounds (reference precision: src/vec3.h:6-8).
    """
    if jnp.dtype(dtype) == jnp.float64:
        u = jax.random.uniform(key, shape, dtype=jnp.float32,
                               minval=lo, maxval=hi)
        return u.astype(jnp.float64)
    return jax.random.uniform(key, shape, dtype=dtype, minval=lo, maxval=hi)


def unit_vectors(key, batch_shape=(), dtype=REAL) -> jax.Array:
    """Uniform points on the unit sphere, shape ``batch_shape + (3,)``.

    Gaussian-normalise instead of rejection-sampling: identical
    distribution to the book's ``random_unit_vector``, zero divergence.
    """
    draw = jnp.float32 if jnp.dtype(dtype) == jnp.float64 else dtype
    g = jax.random.normal(key, (*batch_shape, 3), dtype=draw).astype(dtype)
    norm = jnp.linalg.norm(g, axis=-1, keepdims=True)
    return g / jnp.maximum(norm, jnp.asarray(1e-12, dtype))


def in_unit_disk(key, batch_shape=(), dtype=REAL) -> jax.Array:
    """Uniform points in the unit disk (z = 0), shape ``batch_shape + (3,)``.

    Analytic polar sampling replaces the rejection loop of the reference
    (src/random-utils.cpp:34-41).
    """
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(uniform(k1, batch_shape, dtype=dtype))
    theta = uniform(k2, batch_shape, 0.0, 2.0 * jnp.pi, dtype=dtype)
    zeros = jnp.zeros_like(r)
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), zeros], axis=-1)
