"""Differentiable rendering: losses, gradients, and the sharded train step.

The reference is a forward-only renderer; differentiability is this
build's main extension: reverse-mode gradients of a
pixel loss w.r.t. scene geometry (sphere centers/radii, triangle verts)
and materials (albedo/fuzz/ir), validated against finite differences.

Gradients flow through hit positions, normals and attenuations; the
discrete hit/miss and material selections are piecewise-constant (their
true derivative contains visibility delta terms we do not estimate —
standard inverse-rendering practice for interior pixels).  Finite-
difference comparisons therefore use **common random numbers** (the same
key across evaluations) and interior-stable configurations.

The sharded train step is the framework's "training step" in ML terms:
forward render (dp over samples, sp over pixel tiles) → scalar loss →
reverse-mode grads → gradient ``psum`` over every mesh axis (the
all-reduce of data-parallel training) → SGD update on the replicated
scene parameters.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .models.camera import Camera, camera_rays, pixel_coords
from .models.scene import Scene
from .ops import integrator
from .parallel.mesh import SPP_AXIS, TILE_AXIS


def psum_in_bwd(tree, axis_names: Tuple[str, ...]):
    """Identity on the forward pass; ``psum`` the cotangent on the backward.

    The building block of overlapped gradient all-reduce (SURVEY.md §2:
    "parameter gradients all-reduced overlapped with backward bounce
    unroll").  Applying this to the scene *inside* each bounce of the
    integrator's scan makes the backward pass emit one partial-gradient
    ``psum`` per bounce — DDP-style bucketing by bounce — instead of one
    monolithic all-reduce after the full backward.  XLA's latency-hiding
    scheduler can then overlap each bounce's collective with the next
    bounce's backward compute; the single post-hoc psum has nothing left
    to hide behind.  Correct by linearity: sum-of-psums == psum-of-sum.

    Float0 cotangents (int leaves under ``allow_int=True``) pass through
    untouched.
    """

    @jax.custom_vjp
    def _ident(t):
        return t

    def _fwd(t):
        return t, None

    def _bwd(_, ct):
        def red(g):
            if getattr(g, "dtype", None) == jax.dtypes.float0 or not hasattr(
                g, "dtype"
            ):
                return g
            out = g
            for ax in axis_names:
                out = jax.lax.psum(out, ax)
            return out

        return (jax.tree_util.tree_map(red, ct),)

    _ident.defvjp(_fwd, _bwd)
    return _ident(tree)


def render_pixels(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    pixel_ids: jax.Array,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    nearest_hit: Optional[Callable] = None,
    jitter: bool = True,
    grad_reduce_axes: Tuple[str, ...] = (),
    nee: bool = False,
) -> jax.Array:
    """Differentiable mean radiance of the given pixels -> (Npix, 3).

    Lane layout is (pixel, sample) flattened; fully jittable and
    reverse-mode differentiable w.r.t. ``scene`` (and ``camera``).
    ``jitter=False`` pins rays to pixel centers — used by FD tests to
    kill sampling noise at the discretisation boundary.

    ``nee=True`` runs the next-event estimator (ops/lights.py) in the
    differentiable path — the same expectation at far lower variance on
    emissive scenes, so inverse rendering converges with ~8x fewer
    samples.  Gradients w.r.t. materials (albedo, emitted radiance) are
    exact under common random numbers (the light-sampling distribution
    does not depend on them — FD-gated in tests/test_nee_grad.py);
    gradients w.r.t. the LIGHT's geometry carry the full reparameterized
    interior derivative (FD-gated: light position/size are recoverable
    by inverse rendering), dropping only visibility BOUNDARY terms (a
    moving occluder silhouette), the same class of omission as the
    visibility deltas the plain estimator already drops.  Default off:
    matches the reference estimator exactly.
    """
    n_pix = pixel_ids.shape[0]
    lane_pix = jnp.repeat(pixel_ids, spp)  # (Npix*spp,)
    k_pix, k_cam, k_trace = jax.random.split(key, 3)
    s, t = pixel_coords(width, height, k_pix, lane_pix, dtype=camera.origin.dtype)
    if not jitter:
        row = lane_pix // width
        col = lane_pix % width
        s = (col.astype(s.dtype) + 0.5) / (width - 1)
        t = ((height - 1 - row).astype(t.dtype) + 0.5) / (height - 1)
    rays = camera_rays(camera, k_cam, s, t)
    radiance = integrator.trace(scene, rays, k_trace, max_depth,
                                nearest_hit=nearest_hit,
                                grad_reduce_axes=grad_reduce_axes,
                                nee=nee)
    return radiance.reshape(n_pix, spp, 3).mean(axis=1)


def image_mse(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    target: jax.Array,
    pixel_ids: jax.Array,
    **render_kw,
) -> jax.Array:
    """Scalar MSE between rendered pixels and target rows -> ()."""
    img = render_pixels(scene, camera, key, pixel_ids, **render_kw)
    return jnp.mean((img - target) ** 2)


def loss_and_grad(
    scene: Scene,
    camera: Camera,
    key: jax.Array,
    target: jax.Array,
    pixel_ids: jax.Array,
    **render_kw,
) -> Tuple[jax.Array, Scene]:
    """(loss, dloss/dscene) — single-device reverse mode.

    Integer leaves (material ids/kinds) get ``float0`` gradients, which
    ``sgd_update`` ignores.
    """
    return jax.value_and_grad(image_mse, allow_int=True)(
        scene, camera, key, target, pixel_ids, **render_kw
    )


def sgd_update(scene: Scene, grads: Scene, lr: float) -> Scene:
    """One SGD step on every real-valued leaf (int leaves pass through)."""
    def upd(p, g):
        if jnp.issubdtype(p.dtype, jnp.floating) and g.dtype != jax.dtypes.float0:
            return p - lr * g
        return p
    return jax.tree_util.tree_map(upd, scene, grads)


def mask_grads(grads: Scene, keep: Callable[[str], bool]) -> Scene:
    """Zero every gradient leaf whose dotted path fails ``keep``.

    Joint geometry+material descent is ill-posed at silhouettes (visibility
    delta terms are not estimated); callers typically optimise a parameter
    subset, e.g. ``keep=lambda p: p.endswith('albedo')``.
    """
    flat, treedef = jax.tree_util.tree_flatten_with_path(grads)
    out = []
    for path, leaf in flat:
        name = ".".join(str(getattr(k, "name", k)) for k in path)
        if (not keep(name)) and hasattr(leaf, "dtype") \
                and leaf.dtype != jax.dtypes.float0:
            leaf = jnp.zeros_like(leaf)
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


class TrainState(NamedTuple):
    scene: Scene
    loss: jax.Array


def build_train_step(
    mesh: Mesh,
    camera: Camera,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    lr: float = 1e-2,
    renderer: Callable = None,
    overlap_grad_allreduce: bool = False,
):
    """The full sharded training step, jitted over the (tile, spp) mesh.

    Pixel rows are sharded over ``tile`` (spatial parallelism), samples
    over ``spp`` (data parallelism); the scene is replicated and its
    gradient is all-reduced over *both* axes before the update — the
    renderer's exact analogue of data-parallel gradient all-reduce.

    ``renderer`` defaults to :func:`render_pixels`, the one gradient
    path (a ``lax.scan`` over bounces, checkpointed per bounce).

    ``overlap_grad_allreduce``: emit one partial scene-gradient ``psum``
    per bounce inside the backward scan (via :func:`psum_in_bwd`)
    instead of one monolithic all-reduce after the whole backward, so
    XLA's latency-hiding scheduler can overlap collectives with backward
    compute.  Numerically identical by psum linearity (tested).  A
    custom renderer must accept ``grad_reduce_axes`` or the partial
    application fails loudly — never a silent no-op.
    """
    overlap = overlap_grad_allreduce
    if renderer is None:
        renderer = render_pixels
    if overlap:
        import functools

        renderer = functools.partial(
            renderer, grad_reduce_axes=(SPP_AXIS, TILE_AXIS)
        )
    n_pixels = width * height
    tile_shards = mesh.shape[TILE_AXIS]
    spp_shards = mesh.shape[SPP_AXIS]
    if n_pixels % tile_shards:
        raise ValueError("n_pixels must divide evenly for the train step")
    if spp % spp_shards:
        raise ValueError("spp must divide evenly over the spp axis")
    ppt = n_pixels // tile_shards
    spp_local = spp // spp_shards

    def device_loss(scene, key, target_block):
        """Mean-over-my-lanes MSE on this device's (pixel-block, spp-shard)."""
        ti = jax.lax.axis_index(TILE_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        dev_key = jax.random.fold_in(jax.random.fold_in(key, ti), si)
        pixel_ids = ti * ppt + jnp.arange(ppt, dtype=jnp.int32)
        img = renderer(
            scene, camera, dev_key, pixel_ids,
            width=width, height=height, spp=spp_local, max_depth=max_depth,
        )
        # Local MSE; global loss = mean over devices (all blocks equal size).
        local = jnp.mean((img - target_block) ** 2)
        return jax.lax.pmean(jax.lax.pmean(local, SPP_AXIS), TILE_AXIS)

    def device_step(scene, key, target_block):
        loss, grads = jax.value_and_grad(device_loss, allow_int=True)(
            scene, key, target_block
        )
        # Gradient all-reduce over the whole mesh (dp+sp axes). device_loss
        # already pmeans the loss, so grads of the *global* loss only need
        # summing across devices. float0 (int-leaf) grads pass through.
        # In overlap mode the backward scan already psum'd each bounce's
        # partial (psum_in_bwd), so the grads arrive globally reduced.
        if not overlap:
            grads = jax.tree_util.tree_map(
                lambda g: jax.lax.psum(jax.lax.psum(g, SPP_AXIS), TILE_AXIS)
                if g.dtype != jax.dtypes.float0 else g,
                grads,
            )
        new_scene = sgd_update(scene, grads, lr)
        return new_scene, loss

    step = shard_map(
        device_step,
        mesh=mesh,
        in_specs=(P(), P(), P(TILE_AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(step)
