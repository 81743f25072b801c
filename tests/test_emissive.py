"""Emissive materials (area lights) — a capability extension past the
reference's sky-only lighting (its ray_color has no emitted term,
src/render.cpp:112-129).  Semantics: a hit on an EMISSIVE winner adds
``throughput * emitted`` and terminates the path (no scatter budget
consumed); ``SceneBuilder.build(background=...)`` selects the miss
radiance (the reference sky gradient, or a flat color — black for
light-driven scenes).

Covered paths: the progressive integrator (brute-force sweep), the flat
scan integrator behind the BVH, and the gradient path (d loss / d emitted
is exercised against finite differences — emission is linear in the
emitted color, so FD is exact up to float noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder
from rtow_tpu.ops import bvh
from rtow_tpu.render import render

KEY = jax.random.key(5)

#: The two forward paths: the progressive while-loop integrator with the
#: fused sweep, and the flat scan integrator with the BVH search.
PATHS = ["sweep", "bvh"]


def _render(scene, cam, cfg, path):
    nearest = bvh.make_nearest_hit(scene) if path == "bvh" else None
    return np.asarray(render(scene, cam, cfg, nearest_hit=nearest))


def _staring_at_light(emit=(2.0, 3.0, 4.0)):
    """Camera inside a giant emissive sphere: every primary ray hits the
    light first, so every pixel must equal ``emit`` exactly."""
    cam = make_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0)
    b = SceneBuilder()
    lamp = b.add_light(emit)
    b.add_sphere((0.0, 0.0, -4.0), 3.5, lamp)
    return b.build(background=(0.0, 0.0, 0.0)), cam


def test_builder_flags():
    scene, _ = _staring_at_light()
    assert scene.has_emissive
    assert scene.background == (0.0, 0.0, 0.0)
    sky, _ = _staring_at_light()
    b = SceneBuilder()
    b.add_sphere((0, 0, -1), 0.5, b.add_lambertian((0.5, 0.5, 0.5)))
    plain = b.build()
    assert not plain.has_emissive and plain.background == "sky"
    with pytest.raises(ValueError):
        b.build(background=(1.0, 2.0))


@pytest.mark.parametrize("path", PATHS)
def test_direct_hit_is_exact_jnp(path):
    emit = (2.0, 3.0, 4.0)
    scene, cam = _staring_at_light(emit)
    cfg = Config(image_width=8, aspect_ratio=1.0, samples_per_pixel=4,
                 max_child_rays=3, seed=1)
    img = _render(scene, cam, cfg, path)
    np.testing.assert_allclose(img, np.broadcast_to(emit, img.shape),
                               rtol=1e-5)


def test_black_without_lights():
    """Black background + no emissive -> the whole image is black, at
    any depth (nothing adds radiance)."""
    cam = make_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -2.0), 0.5, b.add_lambertian((0.7, 0.7, 0.7)))
    scene = b.build(background=(0.0, 0.0, 0.0))
    cfg = Config(image_width=8, aspect_ratio=1.0, samples_per_pixel=4,
                 max_child_rays=4, seed=2)
    img = np.asarray(render(scene, cam, cfg))
    np.testing.assert_allclose(img, 0.0, atol=1e-7)


@pytest.mark.parametrize("path", PATHS)
def test_emissive_triangle_direct_hit_exact(path):
    """Emissive TRIANGLES: a camera staring at an emissive quad gets the
    emitted color exactly, on both forward paths."""
    emit = (3.0, 2.0, 1.0)
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0)
    b = SceneBuilder()
    lamp = b.add_light(emit)
    # Huge quad at z=-1 facing the camera (+z normal).
    b.add_triangle((-9, -9, -1.0), (9, -9, -1.0), (9, 9, -1.0), lamp)
    b.add_triangle((-9, -9, -1.0), (9, 9, -1.0), (-9, 9, -1.0), lamp)
    # A sphere behind the quad: triangles and spheres in one scene.
    b.add_sphere((0.0, 0.0, 5.0), 0.5, b.add_lambertian((0.5, 0.5, 0.5)))
    scene = b.build(background=(0.0, 0.0, 0.0))
    cfg = Config(image_width=8, aspect_ratio=1.0, samples_per_pixel=4,
                 max_child_rays=3, seed=6)
    img = _render(scene, cam, cfg, path)
    np.testing.assert_allclose(img, np.broadcast_to(emit, img.shape),
                               rtol=1e-5)


def test_cornell_box_wall_bleed():
    """Cornell box (emissive triangle ceiling light, NEE on): physical
    sanity — red/green wall bleed on opposite halves."""
    from rtow_tpu.models.builders import cornell_scene

    scene, cam = cornell_scene(1.0)
    W = 16
    cfg = Config(image_width=W, aspect_ratio=1.0, samples_per_pixel=64,
                 max_child_rays=4, seed=8)
    img = np.asarray(render(scene, cam, cfg))
    left = img[:, : W // 3]
    right = img[:, -W // 3:]
    # Red wall on the image-left third, green on the right third.
    assert left[..., 0].mean() > left[..., 1].mean()
    assert right[..., 1].mean() > right[..., 0].mean()


def test_nee_matches_plain_estimator():
    """Next-event estimation is unbiased: on a LARGE-light scene where
    the plain estimator converges fast, NEE and plain means agree
    within MC noise (jnp integrator, both light kinds)."""
    from rtow_tpu.models.camera import camera_rays, pixel_coords
    from rtow_tpu.ops.integrator import trace

    cam = make_camera(lookfrom=(0.0, 1.0, 4.0), lookat=(0.0, 0.5, 0.0),
                      fov_degrees=50.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=4.0)
    b = SceneBuilder()
    ground = b.add_lambertian((0.6, 0.6, 0.6))
    red = b.add_lambertian((0.7, 0.2, 0.2))
    lamp = b.add_light((4.0, 4.0, 4.0))
    tlamp = b.add_light((2.0, 2.0, 2.0))
    b.add_sphere((0.0, -100.0, 0.0), 100.0, ground)
    b.add_sphere((-0.8, 0.5, 0.0), 0.5, red)
    b.add_sphere((1.5, 3.0, 1.0), 1.5, lamp)  # big sphere light
    # Big triangle light overhead, wound to face down.
    b.add_triangle((-4.0, 4.0, -4.0), (4.0, 4.0, -4.0), (4.0, 4.0, 4.0),
                   tlamp)
    scene = b.build(background=(0.0, 0.0, 0.0))
    W = H = 8
    spp, depth = 512, 4

    def render_px(key, nee):
        pix = jnp.arange(W * H, dtype=jnp.int32)
        lane_pix = jnp.repeat(pix, spp)
        k_pix, k_cam, k_tr = jax.random.split(key, 3)
        s, t = pixel_coords(W, H, k_pix, lane_pix, dtype=jnp.float32)
        rays = camera_rays(cam, k_cam, s, t)
        rad = trace(scene, rays, k_tr, depth, nee=nee)
        return np.asarray(rad.reshape(W * H, spp, 3))

    samp_p = render_px(jax.random.key(0), False)
    samp_n = render_px(jax.random.key(1), True)
    img_p, img_n = samp_p.mean(axis=1), samp_n.mean(axis=1)
    assert abs(img_p.mean() - img_n.mean()) < 0.02
    assert np.abs(img_p - img_n).mean() < 0.05
    # Variance reduction: NEE per-sample std must be lower.
    assert samp_n.std(axis=1).mean() < samp_p.std(axis=1).mean()


def test_nee_variance_reduction_cornell():
    """On the small-light Cornell box NEE must substantially cut the
    per-sample std (measured 1.8-3.1x depending on depth/crop; gate at
    1.5x to stay seed-robust) — the reason NEE exists."""
    from rtow_tpu.models.builders import cornell_scene
    from rtow_tpu.models.camera import camera_rays, pixel_coords
    from rtow_tpu.ops.integrator import trace

    scene, cam = cornell_scene(1.0)
    W = H = 8
    spp, depth = 64, 4

    def samples(nee):
        pix = jnp.arange(W * H, dtype=jnp.int32)
        lane_pix = jnp.repeat(pix, spp)
        key = jax.random.key(9)
        k_pix, k_cam, k_tr = jax.random.split(key, 3)
        s, t = pixel_coords(W, H, k_pix, lane_pix, dtype=jnp.float32)
        rays = camera_rays(cam, k_cam, s, t)
        rad = trace(scene, rays, k_tr, depth, nee=nee)
        return np.asarray(rad.reshape(W * H, spp, 3))

    std_p = samples(False).std(axis=1).mean()
    std_n = samples(True).std(axis=1).mean()
    assert std_n < std_p / 1.5, (std_p, std_n)


def test_emission_gradient_fd():
    """d(MSE)/d(emitted color) vs central finite differences.  The camera
    stares at the light, so the loss is exactly quadratic in emit and FD
    at any step is exact."""
    import dataclasses

    from rtow_tpu.diff import loss_and_grad

    emit = (2.0, 3.0, 4.0)
    scene, cam = _staring_at_light(emit)
    w = h = 4
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.full((w * h, 3), 1.0)
    kw = dict(width=w, height=h, spp=2, max_depth=2, jitter=False)

    def with_emit(r):
        mats = dataclasses.replace(
            scene.materials,
            albedo=scene.materials.albedo.at[0, 0].set(r),
        )
        return dataclasses.replace(scene, materials=mats)

    lg = jax.jit(lambda s: loss_and_grad(s, cam, KEY, target, pix, **kw))
    _, grads = lg(scene)

    def loss_at(r):
        return float(lg(with_emit(r))[0])

    eps = 0.05
    fd = (loss_at(emit[0] + eps) - loss_at(emit[0] - eps)) / (2 * eps)
    g = float(grads.materials.albedo[0, 0])
    assert g == pytest.approx(fd, rel=1e-3)


def test_jnp_gradients_flow_to_emission():
    """The jnp path (diff.loss_and_grad) also differentiates emission."""
    from rtow_tpu.diff import loss_and_grad

    scene, cam = _staring_at_light()
    w = h = 4
    pix = jnp.arange(w * h, dtype=jnp.int32)
    target = jnp.zeros((w * h, 3))
    _, grads = loss_and_grad(scene, cam, KEY, target, pix, width=w,
                             height=h, spp=2, max_depth=2)
    g = np.asarray(grads.materials.albedo[0])
    assert np.all(np.abs(g) > 0.0)


def test_mis_pdf_pairing():
    """MIS consistency linchpin: the pdf reported by sample_light_dirs
    for a generated light direction must equal light_pdf_toward's pdf
    for that same ray evaluated at the light hit distance — otherwise
    the balance weights at the two path endpoints don't sum to 1 and
    the combined estimator is biased."""
    from rtow_tpu.ops.lights import (
        build_light_table, light_pdf_toward, sample_light_dirs,
    )

    b = SceneBuilder()
    lamp = b.add_light((5.0, 5.0, 5.0))
    tlamp = b.add_light((2.0, 2.0, 2.0))
    b.add_sphere((2.0, 3.0, -1.0), 1.2, lamp)
    b.add_triangle((-3.0, 4.0, -2.0), (1.0, 4.0, -2.0), (-1.0, 4.0, 2.0),
                   tlamp)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, b.add_lambertian((0.5,) * 3))
    scene = b.build(background=(0.0, 0.0, 0.0))
    table = build_light_table(scene)
    kinds = tuple(k for k, _ in scene.light_ids)

    n = 256
    key = jax.random.key(11)
    pick, u1, u2 = jax.random.uniform(key, (3, n))
    # Shading points scattered on the ground plane.
    px = jnp.linspace(-2.0, 2.0, n)
    py = jnp.zeros((n,)) + 0.01
    pz = jnp.linspace(-1.5, 1.5, n)
    tm = jnp.zeros((n,))
    dx, dy, dz, t_l, _w, pdf = sample_light_dirs(
        table, kinds, pick, u1, u2, px, py, pz, tm)
    pdf_back = light_pdf_toward(table, kinds, px, py, pz, dx, dy, dz,
                                t_l, tm)
    pdf, pdf_back = np.asarray(pdf), np.asarray(pdf_back)
    ok = pdf > 0
    assert ok.mean() > 0.9  # nearly all samples are valid
    np.testing.assert_allclose(pdf_back[ok], pdf[ok], rtol=2e-3)


@pytest.mark.parametrize("path", PATHS)
def test_mis_exact_inside_dome_light(path):
    """One diffuse bounce inside an enclosing emissive dome: NEE's cone
    sample is degenerate (shading point inside the light -> pdf 0) and
    the BRDF-side balance weight must then be exactly 1, so the pixel
    is exactly albedo * emit.  Any double counting or lost weight shows
    up immediately.  Covers both forward paths."""
    emit = (2.0, 1.0, 0.5)
    albedo = (0.5, 0.6, 0.7)
    cam = make_camera(lookfrom=(0.0, 1.5, 2.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=40.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=2.5)
    b = SceneBuilder()
    lamp = b.add_light(emit)
    mat = b.add_lambertian(albedo)
    b.add_sphere((0.0, -100.0, 0.0), 100.0, mat)  # floor
    b.add_sphere((0.0, 0.0, 0.0), 300.0, lamp)    # enclosing dome
    scene = b.build(background=(0.0, 0.0, 0.0))
    want = np.array(albedo) * np.array(emit)
    cfg = Config(image_width=8, aspect_ratio=1.0, samples_per_pixel=8,
                 max_child_rays=4, seed=12)
    img = _render(scene, cam, cfg, path)
    np.testing.assert_allclose(img, np.broadcast_to(want, img.shape),
                               rtol=1e-4)
