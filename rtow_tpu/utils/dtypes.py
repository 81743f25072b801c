"""Floating-point policy for the renderer.

The reference traces in float64 (``rt::vec3 = glm::dvec3``, reference
src/vec3.h:6-8).  Accelerators run float32 far faster than float64, so
the policy is:

* device compute defaults to **float32** (matmuls at HIGHEST precision,
  never a reduced-precision tensor-core mode),
* host-side scene generation stays in numpy float64 and is cast on upload,
* tests may flip to float64 on CPU (``jax_enable_x64``) to validate the
  math against high-precision oracles.
"""
from __future__ import annotations

import jax.numpy as jnp

#: Default real dtype for device-side tracing.
REAL = jnp.float32

#: Index dtype for primitive/material ids.
INDEX = jnp.int32
