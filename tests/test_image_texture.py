"""Image textures (book 2 ch. 4.3) — jnp path only (texel lookups are
per-lane gathers, fenced off the kernels by pipeline dispatch), but the
texels are a traced Scene leaf: gradients flow INTO the image.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder
from rtow_tpu.render import render

KEY = jax.random.key(3)


def _globe(texture):
    cam = make_camera(lookfrom=(0.0, 0.0, 4.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=40.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=4.0)
    b = SceneBuilder()
    mat = b.add_image(texture)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, mat)
    b.add_sphere((0.0, -101.5, 0.0), 100.0, b.add_lambertian((0.5,) * 3))
    return b.build(), cam


def test_constant_texture_equals_lambertian():
    """A constant image IS a Lambertian with that albedo: same scene,
    same seed, the two renders must agree exactly (the only code
    difference is where the albedo comes from)."""
    albedo = (0.7, 0.4, 0.2)
    tex = np.broadcast_to(np.asarray(albedo), (8, 16, 3)).copy()
    scene_img, cam = _globe(tex)

    b = SceneBuilder()
    mat = b.add_lambertian(albedo)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, mat)
    b.add_sphere((0.0, -101.5, 0.0), 100.0, b.add_lambertian((0.5,) * 3))
    scene_lam = b.build()

    cfg = Config(image_width=16, aspect_ratio=1.0, samples_per_pixel=8,
                 max_child_rays=4, seed=9)
    img_t = np.asarray(render(scene_img, cam, cfg))
    img_l = np.asarray(render(scene_lam, cam, cfg))
    np.testing.assert_allclose(img_t, img_l, atol=1e-6)


def test_uv_orientation():
    """Equirectangular mapping (theta = acos(-y), phi = atan2(-z, x) +
    pi): the top texture row lands on the NORTH pole and the bottom row
    on the south — a two-band texture renders the top half of the
    sphere in the first band's color."""
    tex = np.zeros((8, 16, 3))
    tex[:4] = (1.0, 0.0, 0.0)   # north half: red
    tex[4:] = (0.0, 0.0, 1.0)   # south half: blue
    scene, cam = _globe(tex)
    cfg = Config(image_width=24, aspect_ratio=1.0, samples_per_pixel=32,
                 max_child_rays=2, seed=1)
    img = np.asarray(render(scene, cam, cfg))
    # Rows 8-10 are the upper part of the sphere (sphere spans ~5-19).
    top = img[8:10, 10:14]
    bot = img[15:17, 10:14]
    assert top[..., 0].mean() > 2.0 * top[..., 2].mean()
    assert bot[..., 2].mean() > 2.0 * bot[..., 0].mean()


def test_image_scene_through_render_auto():
    """Image scenes take the normal dispatch like any other scene."""
    from rtow_tpu.pipeline import render_auto

    tex = np.zeros((4, 8, 3))
    tex[:2, :, 0] = 1.0  # red north
    tex[2:, :, 2] = 1.0  # blue south
    scene, cam = _globe(tex)
    cfg = Config(image_width=24, aspect_ratio=1.0, samples_per_pixel=32,
                 max_child_rays=2, seed=1)
    img = render_auto(scene, cam, cfg)
    assert np.isfinite(img).all()
    np.testing.assert_array_equal(img, render(scene, cam, cfg))


def test_gradients_flow_into_texels():
    """d(MSE)/d(texture): the bilinear lookup distributes cotangents
    over texels; visible texels get nonzero gradients and one texel's
    gradient matches central finite differences."""
    from rtow_tpu.diff import loss_and_grad

    tex = np.full((4, 8, 3), 0.5)
    scene, cam = _globe(tex)
    w = h = 6
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.zeros((w * h, 3))
    kw = dict(width=w, height=h, spp=4, max_depth=2)
    _, grads = loss_and_grad(scene, cam, KEY, target, pix, **kw)
    g = np.asarray(grads.texture)
    assert g.shape == tex.shape
    assert np.abs(g).sum() > 0.0
    # FD gate on the most-influential texel (linear enough at eps=0.02).
    idx = np.unravel_index(np.abs(g).argmax(), g.shape)

    def loss_at(val):
        t2 = tex.copy()
        t2[idx] = val
        s2 = dataclasses.replace(scene, texture=jnp.asarray(
            t2, scene.texture.dtype))
        from rtow_tpu.diff import loss_and_grad as lg

        return float(lg(s2, cam, KEY, target, pix, **kw)[0])

    eps = 0.02
    fd = (loss_at(0.5 + eps) - loss_at(0.5 - eps)) / (2 * eps)
    assert g[idx] == pytest.approx(fd, rel=2e-2)
