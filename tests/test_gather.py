"""The winner's parameters are fetched by gather (``intersect.fetch_rows``).

A one-hot matmul at HIGHEST precision returns the same table entries
exactly, so every render must be bit-identical whichever fetch runs, and
gradients (a scatter-add in place of a transposed matmul) must agree to
float32 round-off.  The one-hot reference lives in ``chip_smoke.py``,
which runs the same comparison on the card at full width.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.builders import (
    cover_scene, textures_scene, three_sphere_scene,
)
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder
from rtow_tpu.ops import intersect
from rtow_tpu.pipeline import render_auto

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
from golden_compare import knot_scene  # noqa: E402


def _mixed():
    """Knot mesh over a ground sphere: spheres and triangles together."""
    from make_mesh import make_knot

    verts, faces = make_knot(16, 12)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    b.add_sphere((0.0, -101.0, 0.0), 100.0, b.add_metal((0.7, 0.7, 0.7), 0.2))
    b.add_sphere((0.8, 0.0, -0.5), 0.3, b.add_dielectric(1.5))
    cam = make_camera(lookfrom=(0.0, 0.5, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0)
    return b.build(), cam


def _image():
    b = SceneBuilder()
    tex = np.random.default_rng(0).uniform(size=(8, 16, 3))
    b.add_sphere((0.0, 0.0, -2.0), 1.0, b.add_image(tex))
    b.add_sphere((0.0, -101.0, -2.0), 100.0, b.add_lambertian((0.5,) * 3))
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, -2.0),
                      fov_degrees=50.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0)
    return b.build(), cam


SCENES = {
    "spheres": lambda: three_sphere_scene(aspect_ratio=1.0),
    "moving_spheres": lambda: cover_scene(
        Config(image_width=16, number_of_balls_sqrt=3, moving_spheres=True)),
    "triangles": lambda: knot_scene(16, 12)[:2],
    "mixed": _mixed,
    "checker": lambda: textures_scene(aspect_ratio=1.0),
    "image": _image,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_bit_identical_to_onehot(name):
    scene, cam = SCENES[name]()
    cfg = Config(image_width=16, aspect_ratio=1.0, samples_per_pixel=4,
                 max_child_rays=4, seed=2)
    img = render_auto(scene, cam, cfg)
    with chip_smoke.onehot_fetch():
        ref = render_auto(scene, cam, cfg)
    assert np.isfinite(img).all()
    np.testing.assert_array_equal(img, ref)


def test_hit_records_equal_on_random_rays():
    """Every HitRecord field, on rays from inside and outside the
    primitives of a mixed scene, through the brute-force sweep."""
    scene, _ = _mixed()
    k = jax.random.split(jax.random.key(4), 3)
    n = 4096
    o = jax.random.normal(k[0], (n, 3)) * 1.5
    d = jax.random.normal(k[1], (n, 3))
    tm = jax.random.uniform(k[2], (n,))
    rec = jax.jit(lambda *a: intersect.nearest_hit_bruteforce(*a))(
        scene, o, d, tm)
    with chip_smoke.onehot_fetch():
        ref = jax.jit(lambda *a: intersect.nearest_hit_bruteforce(*a))(
            scene, o, d, tm)
    assert 0.05 < float(np.asarray(rec.hit).mean()) < 0.95
    assert chip_smoke._records_equal(rec, ref) == []


def test_onehot_rows_chunking():
    """The reference's chunked one-hot equals plain indexing for lane
    counts that do and do not divide the chunk."""
    table = jnp.asarray(np.random.default_rng(1).normal(size=(37, 5)),
                        jnp.float32)
    for n in (1, 64, 100):
        idx = jnp.asarray(np.random.default_rng(n).integers(0, 37, n))
        np.testing.assert_array_equal(
            chip_smoke.onehot_rows(table, idx, chunk=64), table[idx])


@pytest.mark.parametrize("name", ["spheres", "mixed", "image"])
def test_gradients_match_onehot(name):
    from rtow_tpu.diff import loss_and_grad

    scene, cam = SCENES[name]()
    w = h = 6
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.full((w * h, 3), 0.3)

    def grads():
        fn = jax.jit(lambda s: loss_and_grad(
            s, cam, jax.random.key(7), target, pix, width=w, height=h,
            spp=4, max_depth=3))
        return fn(scene)

    loss, g = grads()
    with chip_smoke.onehot_fetch():
        loss_ref, g_ref = grads()
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-6)
    leaves = [(p, a, b) for (p, a), b in zip(
        jax.tree_util.tree_flatten_with_path(g)[0],
        jax.tree_util.tree_leaves(g_ref))
        if getattr(a, "dtype", None) != jax.dtypes.float0]
    assert leaves
    for path, a, b in leaves:
        a, b = np.asarray(a), np.asarray(b)
        scale = np.nanmax(np.abs(b), initial=1.0)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=str(path))


def test_fetch_rows_is_a_gather():
    table = jnp.arange(12.0).reshape(4, 3)
    idx = jnp.asarray([[0, 3], [2, 2]])
    np.testing.assert_array_equal(intersect.fetch_rows(table, idx),
                                  np.asarray(table)[np.asarray(idx)])
