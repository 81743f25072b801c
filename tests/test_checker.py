"""Checker texture (book 2's first texture; the reference stops at
book 1).  A CHECKER material is a Lambertian whose albedo alternates by
the sign of prod(sin(scale * p)) at the hit point; the odd color lives
in Materials.albedo2 (sphere table cols 13-15), the scale rides the
otherwise dielectric-only ir column.  Sphere-only (build() rejects
checker on triangles)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder
from rtow_tpu.render import render

EVEN = (0.1, 0.2, 0.3)
ODD = (0.9, 0.8, 0.7)


def _scene(scale=4.0):
    cam = make_camera(lookfrom=(0.0, 1.5, 3.0), lookat=(0.0, 0.3, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0)
    b = SceneBuilder()
    check = b.add_checker(EVEN, ODD, scale=scale)
    red = b.add_lambertian((0.7, 0.2, 0.2))
    b.add_sphere((0.0, -100.0, 0.0), 100.0, check)
    b.add_sphere((0.0, 0.4, 0.0), 0.4, red)
    return b.build(), cam


def test_builder_flags_and_validation():
    scene, _ = _scene()
    assert scene.has_checker
    np.testing.assert_allclose(np.asarray(scene.materials.albedo[0]), EVEN)
    np.testing.assert_allclose(np.asarray(scene.materials.albedo2[0]), ODD)
    assert float(scene.materials.ir[0]) == 4.0  # scale rides ir
    b = SceneBuilder()
    c = b.add_checker(EVEN, ODD)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), c)
    with pytest.raises(ValueError):
        b.build()


def test_checker_cells_exact():
    """Direct single-bounce color of a checker plane is exactly even or
    odd by cell parity — verified via the jnp hit record on pinned
    rays (the first-hit albedo is deterministic)."""
    from rtow_tpu.ops.intersect import nearest_hit_bruteforce

    scene, _ = _scene(scale=1.0)
    # Rays straight down onto the big ground sphere (top at y=0).
    # At the top of the sphere p ~ (x, ~0, z): parity flips with
    # sin(x)*sin(y~eps)*sin(z) — probe two x cells on z ~ 1.6 (sin>0).
    pts = np.array([[0.5, 5.0, 1.6], [np.pi + 0.5, 5.0, 1.6]])
    o = jnp.asarray(pts, jnp.float32)
    d = jnp.asarray([[0.0, -1.0, 0.0]] * 2, jnp.float32)
    rec = nearest_hit_bruteforce(scene, o, d, jnp.zeros((2,), jnp.float32))
    a = np.asarray(rec.albedo)
    # Hit points sit just BELOW y=0 (the ground sphere's top curves
    # down away from x=0): sin(y) < 0 flips the parity, so
    # x=0.5 (sin>0) -> product < 0 -> odd; x=pi+0.5 (sin<0) -> even.
    np.testing.assert_allclose(a[0], ODD, atol=1e-6)
    np.testing.assert_allclose(a[1], EVEN, atol=1e-6)


def test_checker_pattern_alternates():
    scene, cam = _scene()
    cfg = Config(image_width=24, aspect_ratio=1.0, samples_per_pixel=32,
                 max_child_rays=4, seed=5)
    img = np.asarray(render(scene, cam, cfg))
    assert np.isfinite(img).all()
    # The pattern must actually alternate (both cells visible).
    assert img[-6:, :, 0].max() - img[-6:, :, 0].min() > 0.2


def test_marble_veins_show():
    """NOISE (hash-based marble): the veins must actually show — the
    red channel varies over the ground."""
    cam = make_camera(lookfrom=(0.0, 1.5, 3.0), lookat=(0.0, 0.3, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0)
    b = SceneBuilder()
    marble = b.add_noise((0.9, 0.9, 0.9), (0.25, 0.1, 0.05), scale=3.0)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, marble)
    b.add_sphere((0.0, 0.5, 0.0), 0.5, marble)
    scene = b.build()
    assert scene.has_checker  # the textured flag covers NOISE too
    cfg = Config(image_width=24, aspect_ratio=1.0, samples_per_pixel=32,
                 max_child_rays=3, seed=7)
    img = np.asarray(render(scene, cam, cfg))
    assert np.isfinite(img).all()
    assert img[-8:, :, 0].std() > 0.03


def test_checker_grads_flow_to_both_colors():
    """Gradients reach albedo AND albedo2 (the odd color rides the
    winner's parameter row through the fetch and its backward
    scatter-add)."""
    from rtow_tpu.diff import loss_and_grad

    scene, cam = _scene()
    w = h = 8
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.zeros((w * h, 3))
    loss, grads = jax.jit(lambda s: loss_and_grad(
        s, cam, jax.random.key(3), target, pix, width=w, height=h, spp=8,
        max_depth=2))(scene)
    assert np.isfinite(float(loss))
    g1 = np.abs(np.asarray(grads.materials.albedo[0])).max()
    g2 = np.abs(np.asarray(grads.materials.albedo2[0])).max()
    assert g1 > 0.0 and g2 > 0.0, (g1, g2)


def test_checker_grad_matches_fd():
    """FD gate for the odd color: d(MSE)/d(odd red) is linear in
    single-bounce terms, so central FD agrees tightly (common random
    numbers via the counter RNG)."""
    from rtow_tpu.diff import loss_and_grad

    scene, cam = _scene()
    w = h = 8
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.zeros((w * h, 3))
    kw = dict(width=w, height=h, spp=8, max_depth=2, jitter=False)
    key = jax.random.key(3)

    def with_odd(r):
        mats = dataclasses.replace(
            scene.materials,
            albedo2=scene.materials.albedo2.at[0, 0].set(r),
        )
        return dataclasses.replace(scene, materials=mats)

    lg = jax.jit(lambda s: loss_and_grad(s, cam, key, target, pix, **kw))
    _, grads = lg(scene)

    def loss_at(r):
        return float(lg(with_odd(r))[0])

    eps = 0.02
    fd = (loss_at(ODD[0] + eps) - loss_at(ODD[0] - eps)) / (2 * eps)
    ad = float(grads.materials.albedo2[0, 0])
    assert ad == pytest.approx(fd, rel=5e-2, abs=1e-5)
