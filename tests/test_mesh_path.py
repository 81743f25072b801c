"""Meshes through ``render_auto``: the BVH search inside the flat scan
integrator, on one device and sharded; plus the dispatch rules and exact
sample accounting of both forward paths."""
import os
import sys

import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.camera import make_camera
from rtow_tpu.models.scene import SceneBuilder
from rtow_tpu.ops import bvh
from rtow_tpu.pipeline import pick_nearest_hit, render_auto
from rtow_tpu.render import render

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from golden_compare import knot_scene  # noqa: E402


@pytest.fixture(scope="module")
def knot():
    scene, cam, _, _ = knot_scene(16, 12)  # 384 triangles
    return scene, cam


def _cfg(**kw):
    base = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=4,
                max_child_rays=3)
    base.update(kw)
    return Config(**base)


def test_knot_deterministic_and_seed_sensitive(knot):
    scene, cam = knot
    a = render_auto(scene, cam, _cfg(seed=1))
    b = render_auto(scene, cam, _cfg(seed=1))
    c = render_auto(scene, cam, _cfg(seed=2))
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 0.0
    assert np.isfinite(a).all() and a.mean() > 0.01


def test_knot_chunked_matches_unchunked(knot):
    """rays_per_batch smaller than the frame -> several chunks with a
    ragged last one; same image statistics."""
    scene, cam = knot
    base = dict(image_width=40, samples_per_pixel=8)
    img1 = render_auto(scene, cam, _cfg(**base))
    img2 = render_auto(scene, cam, _cfg(**base, rays_per_batch=1000))
    assert img1.shape == img2.shape
    assert abs(img1.mean() - img2.mean()) < 0.03
    assert np.abs(img1 - img2).mean() < 0.08


def test_knot_sharded_matches_single(knot):
    """8 virtual devices over (tile, spp) vs one device."""
    scene, cam = knot
    base = dict(image_width=24, samples_per_pixel=16)
    img1 = render_auto(scene, cam, _cfg(**base))
    img8 = render_auto(scene, cam, _cfg(**base, n_devices=8))
    assert img8.shape == img1.shape
    assert np.isfinite(img8).all()
    assert abs(img8.mean() - img1.mean()) < 0.03
    assert np.abs(img8 - img1).mean() < 0.08


def test_knot_bvh_matches_bruteforce(knot):
    """Same keys, same nearest hits: the BVH render equals the
    brute-force render of the flat path up to f32 round-off in t."""
    from rtow_tpu.ops import intersect

    scene, cam = knot
    cfg = _cfg(samples_per_pixel=4)
    a = render(scene, cam, cfg, nearest_hit=bvh.make_nearest_hit(scene))
    b = render(scene, cam, cfg, nearest_hit=intersect.nearest_hit_bruteforce)
    assert np.abs(a - b).mean() < 0.02


@pytest.mark.parametrize("n_tris, use_bvh, want_bvh", [
    (384, True, True),    # meshes take the BVH
    (384, False, False),  # --no-bvh forces the sweep
    (2, True, False),     # a few triangles: the sweep
    (0, True, False),     # spheres only: the sweep
])
def test_pick_nearest_hit(n_tris, use_bvh, want_bvh):
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, m)
    for i in range(n_tris):
        x = float(i)
        b.add_triangle((x, 0.0, -3.0), (x + 1, 0.0, -3.0), (x, 1.0, -3.0), m)
    scene = b.build()
    nearest = pick_nearest_hit(scene, Config(use_bvh=use_bvh))
    assert (nearest is not None) == want_bvh


@pytest.fixture(scope="module")
def white_sky():
    """Nothing ever hit + white background: each sample carries exactly
    1.0, so the mean image is exactly 1.0 iff every sample is counted
    exactly once."""
    cam = make_camera(lookfrom=(0.0, 0.0, 1.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=60.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=1.0)
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -99999.0), 1.0, b.add_lambertian((0.5,) * 3))
    return b.build(background=(1.0, 1.0, 1.0)), cam


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("spp, rays_per_batch", [
    (1, 1 << 18), (7, 100), (24, 1000),
])
def test_exact_sample_accounting(white_sky, flat, spp, rays_per_batch):
    scene, cam = white_sky
    nearest = bvh.make_nearest_hit(scene) if flat else None
    cfg = Config(image_width=24, aspect_ratio=1.0, samples_per_pixel=spp,
                 max_child_rays=2, rays_per_batch=rays_per_batch)
    img = render(scene, cam, cfg, nearest_hit=nearest)
    np.testing.assert_array_equal(img, 1.0)
