"""Differentiability tests: reverse-mode gradients vs finite differences.

The north-star gradient gate (BASELINE.json): d(pixel loss)/d(sphere
centers/radii/albedos) from jax.grad must match central finite
differences.  Common random numbers (same key, no pixel jitter, no
defocus, no motion blur) make the loss a smooth function of the scene
parameters away from silhouette edges, so FD is well-posed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.diff import image_mse, loss_and_grad, render_pixels, sgd_update
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder

W = H = 12
SPP = 8
DEPTH = 3
KEY = jax.random.key(7)


@pytest.fixture(scope="module")
def setup():
    cam = make_camera(
        lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), fov_degrees=60.0,
        aspect_ratio=1.0, aperture=0.0, focus_dist=1.0, t0=0.0, t1=0.0,
    )
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    metal = b.add_metal((0.8, 0.8, 0.8), 0.1)
    b.add_sphere((0.0, 0.0, -1.0), 0.5, red)
    b.add_sphere((0.9, 0.0, -1.2), 0.4, metal)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    scene = b.build()
    # Central pixels — squarely on the red sphere, away from silhouettes.
    rows, cols = np.meshgrid(range(4, 8), range(4, 8), indexing="ij")
    pix = jnp.asarray((rows * W + cols).ravel(), dtype=jnp.int32)
    target = jnp.zeros((pix.shape[0], 3))
    return scene, cam, pix, target


def _loss_fn(scene, cam, pix, target):
    return image_mse(
        scene, cam, KEY, target, pix,
        width=W, height=H, spp=SPP, max_depth=DEPTH, jitter=False,
    )


def _replace_sphere(scene, **kw):
    return dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, **kw))


def _replace_mat(scene, **kw):
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **kw))


def _fd(f, x0, eps):
    return (f(x0 + eps) - f(x0 - eps)) / (2 * eps)


@pytest.mark.parametrize(
    "name,eps,tol",
    [("center_x", 1e-2, 0.08), ("radius", 1e-2, 0.08), ("albedo_r", 1e-2, 0.05)],
)
def test_grad_matches_fd(setup, name, eps, tol):
    scene, cam, pix, target = setup
    loss, grads = jax.jit(
        lambda s: jax.value_and_grad(_loss_fn, allow_int=True)(s, cam, pix, target)
    )(scene)
    assert np.isfinite(float(loss))

    if name == "center_x":
        ad = float(grads.spheres.center0[0, 0])

        def f(v):
            c = scene.spheres.center0.at[0, 0].add(v)
            return float(_loss_fn(_replace_sphere(scene, center0=c), cam, pix, target))
    elif name == "radius":
        ad = float(grads.spheres.radius[0])

        def f(v):
            r = scene.spheres.radius.at[0].add(v)
            return float(_loss_fn(_replace_sphere(scene, radius=r), cam, pix, target))
    else:
        ad = float(grads.materials.albedo[0, 0])

        def f(v):
            a = scene.materials.albedo.at[0, 0].add(v)
            return float(_loss_fn(_replace_mat(scene, albedo=a), cam, pix, target))

    fd = _fd(lambda v: f(v), 0.0, eps)
    assert fd != 0.0 or ad == pytest.approx(0.0, abs=1e-4)
    denom = max(abs(fd), abs(ad), 1e-6)
    assert abs(ad - fd) / denom < tol, f"{name}: AD {ad} vs FD {fd}"


def test_grads_finite_everywhere(setup):
    scene, cam, pix, target = setup
    _, grads = loss_and_grad(
        scene, cam, KEY, target, pix,
        width=W, height=H, spp=SPP, max_depth=DEPTH,
    )
    for leaf in jax.tree_util.tree_leaves(grads):
        if hasattr(leaf, "dtype") and leaf.dtype != jax.dtypes.float0:
            assert np.isfinite(np.asarray(leaf)).all()


def test_bvh_grads_match_bruteforce():
    """Gradients through the BVH nearest-hit must equal brute force
    (the BVH only selects the winner; t is recomputed differentiably)."""
    from rtow_tpu.ops import bvh

    cam = make_camera(
        lookfrom=(0.0, 0.3, 1.2), lookat=(0.0, 0.0, 0.0), fov_degrees=55.0,
        aspect_ratio=1.0, aperture=0.0, focus_dist=1.0,
    )
    b = SceneBuilder()
    gray = b.add_lambertian((0.6, 0.5, 0.4))
    # A small triangle fan + a sphere.
    for k in range(6):
        a0 = (np.cos(k * 1.0) * 0.4, -0.2, np.sin(k * 1.0) * 0.4 - 0.2)
        a1 = (np.cos(k * 1.0 + 0.5) * 0.4, -0.2, np.sin(k * 1.0 + 0.5) * 0.4 - 0.2)
        b.add_triangle((0.0, 0.1, -0.2), a0, a1, gray)
    b.add_sphere((0.0, -100.5, 0.0), 100.0, gray)
    scene = b.build()

    pix = jnp.arange(0, W * H, 7, dtype=jnp.int32)
    target = jnp.zeros((pix.shape[0], 3))

    def loss_with(nh):
        return image_mse(
            scene, cam, KEY, target, pix,
            width=W, height=H, spp=4, max_depth=2, jitter=False,
            nearest_hit=nh,
        )

    g_bf = jax.grad(lambda s: image_mse(
        s, cam, KEY, target, pix, width=W, height=H, spp=4, max_depth=2,
        jitter=False), allow_int=True)(scene)
    nh = bvh.make_nearest_hit(scene, leaf_size=2)
    g_bvh = jax.grad(lambda s: image_mse(
        s, cam, KEY, target, pix, width=W, height=H, spp=4, max_depth=2,
        jitter=False, nearest_hit=nh), allow_int=True)(scene)

    np.testing.assert_allclose(
        np.asarray(g_bvh.triangles.verts), np.asarray(g_bf.triangles.verts),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(g_bvh.spheres.center0), np.asarray(g_bf.spheres.center0),
        rtol=1e-4, atol=1e-6,
    )


def test_sgd_converges_albedo():
    """End-to-end inverse rendering: recover an albedo by gradient descent
    (albedo-only updates — joint geometry descent is ill-posed at
    silhouettes, see diff.mask_grads)."""
    from rtow_tpu.diff import mask_grads

    cam = make_camera(
        lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0), fov_degrees=60.0,
        aspect_ratio=1.0, aperture=0.0, focus_dist=1.0,
    )

    def build(albedo):
        b = SceneBuilder()
        m = b.add_lambertian(albedo)
        g = b.add_lambertian((0.5, 0.5, 0.5))
        b.add_sphere((0.0, 0.0, -1.0), 0.5, m)
        b.add_sphere((0.0, -100.5, -1.0), 100.0, g)
        return b.build()

    true_scene = build((0.8, 0.2, 0.6))
    pix = jnp.arange(W * H, dtype=jnp.int32)
    target = render_pixels(true_scene, cam, KEY, pix, width=W, height=H,
                           spp=16, max_depth=3)

    scene = build((0.5, 0.5, 0.5))
    step = jax.jit(lambda s, k: jax.value_and_grad(
        lambda sc: image_mse(sc, cam, k, target, pix, width=W, height=H,
                             spp=16, max_depth=3),
        allow_int=True)(s))
    key = jax.random.key(3)
    loss0 = None
    for i in range(80):
        key, sub = jax.random.split(key)
        loss, grads = step(scene, sub)
        if loss0 is None:
            loss0 = float(loss)
        grads = mask_grads(grads, lambda p: p.endswith("albedo"))
        scene = sgd_update(scene, grads, lr=1.5)
    got = np.asarray(scene.materials.albedo[0])
    np.testing.assert_allclose(got, [0.8, 0.2, 0.6], atol=0.08)
    assert float(loss) < loss0


def test_triangle_grad_matches_fd():
    """FD gate for triangle vertex gradients (north-star geometry grads)."""
    cam = make_camera(
        lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -1.0), fov_degrees=60.0,
        aspect_ratio=1.0, aperture=0.0, focus_dist=1.0,
    )
    b = SceneBuilder()
    red = b.add_lambertian((0.7, 0.3, 0.3))
    gray = b.add_lambertian((0.5, 0.5, 0.5))
    # One large TILTED triangle covering the pixel window — a vertex
    # perturbation rotates the normal, so interior-pixel shading has a
    # strong smooth dependence on it and no silhouette crosses the window.
    b.add_triangle((-4.0, -4.0, -0.6), (4.0, -1.0, -1.8), (0.0, 5.0, -1.4), red)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, gray)
    scene = b.build()
    rows, cols = np.meshgrid(range(5, 8), range(5, 8), indexing="ij")
    pix = jnp.asarray((rows * W + cols).ravel(), dtype=jnp.int32)
    target = jnp.zeros((pix.shape[0], 3))

    def loss_v(v):
        tv = scene.triangles.verts.at[0, 0, 2].add(v)
        s2 = dataclasses.replace(
            scene, triangles=dataclasses.replace(scene.triangles, verts=tv)
        )
        return float(_loss_fn(s2, cam, pix, target))

    _, grads = jax.value_and_grad(_loss_fn, allow_int=True)(
        scene, cam, pix, target
    )
    ad = float(grads.triangles.verts[0, 0, 2])
    eps = 1e-2
    fd = (loss_v(eps) - loss_v(-eps)) / (2 * eps)
    denom = max(abs(fd), abs(ad), 1e-6)
    assert abs(ad - fd) / denom < 0.1, f"AD {ad} vs FD {fd}"
