"""Batched 3-vector math on ``(..., 3)`` arrays.

The reference delegates to glm on scalar dvec3 (reference src/vec3.h:6-8);
here every op is batched so XLA maps it elementwise across whole ray
wavefronts.  Conventions: vectors are trailing-axis-3 arrays; ``dot``
keeps the reduced axis so results broadcast back cleanly.
"""
from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product, shape ``(...)`` (reduced trailing axis)."""
    return jnp.sum(a * b, axis=-1)


def vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product keeping the trailing axis: shape ``(..., 1)``."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def length2(a: jnp.ndarray) -> jnp.ndarray:
    return dot(a, a)


def length(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length2(a))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt(x) for x > 0, exactly 0 otherwise — with a well-defined (zero)
    gradient on the clamped branch.

    The naive ``sqrt(maximum(x, 0))`` has derivative ``inf`` at 0, which
    turns into NaN through the ``where`` mask downstream (the classic
    where-trap); this guards the *input* so no inf ever enters autodiff.
    """
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def normalize(a: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    import jax

    l2 = length2(a)[..., None]
    pos = l2 > eps
    inv = jnp.where(pos, jax.lax.rsqrt(jnp.where(pos, l2, 1.0)), 0.0)
    return a * inv


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def reflect(incident: jnp.ndarray, normal: jnp.ndarray) -> jnp.ndarray:
    """Mirror ``incident`` about unit ``normal`` (glm::reflect semantics).

    Like the reference's Metal (src/common-model.cpp:24-31) the incident
    vector need not be normalised.
    """
    return incident - 2.0 * vdot(incident, normal) * normal


def refract(unit_incident: jnp.ndarray, normal: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of a *unit* incident vector (glm::refract semantics).

    ``eta`` is the ratio n_incident / n_transmitted, shaped to broadcast
    against ``(..., 1)`` (scalar or ``(..., 1)``).  Where total internal
    reflection occurs the result is meaningless (k < 0 is clamped);
    callers mask those lanes — matching the reference which tests
    ``cannot_refract`` first (src/common-model.cpp:52-57).
    """
    eta = jnp.asarray(eta)
    cos_theta = -vdot(unit_incident, normal)
    k = 1.0 - eta * eta * (1.0 - cos_theta * cos_theta)
    return eta * unit_incident + (eta * cos_theta - safe_sqrt(k)) * normal


def lerp(a: jnp.ndarray, b: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return a + t * (b - a)
