"""The Triton-route sphere sweep (``ops/sphere_sweep.py``) in interpret
mode against the plain sweep, ``intersect.sphere_ts`` + min/argmin."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.builders import cover_scene, three_sphere_scene
from rtow_tpu.ops import intersect, sphere_sweep


def _rays(n, seed, spread=3.0):
    k = jax.random.split(jax.random.key(seed), 3)
    o = jax.random.normal(k[0], (n, 3)) * spread + jnp.array([0.0, 1.0, 0.0])
    d = jax.random.normal(k[1], (n, 3))
    return o, d, jax.random.uniform(k[2], (n,))


def _plain(spheres, o, d, tm):
    ts = intersect.sphere_ts(spheres, o, d, tm)
    return np.asarray(ts.min(axis=-1)), np.asarray(ts.argmin(axis=-1))


@pytest.mark.parametrize("scene_fn, lanes", [
    (lambda: three_sphere_scene()[0], 256),     # one whole block
    (lambda: three_sphere_scene()[0], 300),     # ragged last block
    (lambda: cover_scene(Config(image_width=16, moving_spheres=True))[0],
     1000),                                     # moving spheres
])
def test_matches_plain_sweep(scene_fn, lanes):
    scene = scene_fn()
    o, d, tm = _rays(lanes, seed=lanes)
    t, k = sphere_sweep.nearest_sphere(scene.spheres, o, d, tm,
                                       interpret=True)
    t_ref, k_ref = _plain(scene.spheres, o, d, tm)
    t, k = np.asarray(t), np.asarray(k)
    assert t.shape == (lanes,) and k.dtype == np.int32
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t_ref))
    hit = np.isfinite(t_ref)
    assert 0.05 < hit.mean() < 0.95
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=2e-3)


def test_misses_are_inf_with_index_zero():
    scene, _ = three_sphere_scene()
    o = jnp.tile(jnp.array([[0.0, 50.0, 0.0]]), (8, 1))
    d = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (8, 1))  # straight up
    t, k = sphere_sweep.nearest_sphere(scene.spheres, o, d, jnp.zeros(8),
                                       interpret=True)
    assert np.isinf(np.asarray(t)).all()
    np.testing.assert_array_equal(np.asarray(k), 0)


def test_nearest_hit_drop_in(monkeypatch):
    """Through ``nearest_hit`` the hit record matches the brute-force one
    (same winner -> same fetched row)."""
    scene, _ = three_sphere_scene()
    o, d, tm = _rays(512, seed=3)
    monkeypatch.setattr(
        sphere_sweep, "nearest_sphere",
        functools.partial(sphere_sweep.nearest_sphere, interpret=True))
    rec = sphere_sweep.nearest_hit(scene, o, d, tm)
    ref = intersect.nearest_hit_bruteforce(scene, o, d, tm)
    np.testing.assert_array_equal(np.asarray(rec.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(rec.mat_kind),
                                  np.asarray(ref.mat_kind))
    np.testing.assert_allclose(np.asarray(rec.normal),
                               np.asarray(ref.normal), atol=1e-3)


def test_applies_only_to_sphere_scenes_on_gpu(monkeypatch):
    from rtow_tpu.models.scene import SceneBuilder

    spheres, _ = three_sphere_scene()
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, 0.0, -1.0), 0.5, m)
    b.add_triangle((0.0, 0.0, -3.0), (1.0, 0.0, -3.0), (0.0, 1.0, -3.0), m)
    mixed = b.build()
    assert not sphere_sweep.applies(spheres)  # this suite runs on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert sphere_sweep.applies(spheres)
    assert not sphere_sweep.applies(mixed)


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_sweep():
    """The kernel as compiled for the card (no interpret mode)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; the kernel compiles only there")
    scene, _ = cover_scene(Config(image_width=16, moving_spheres=True))
    o, d, tm = _rays(1 << 16, seed=9)
    t, k = sphere_sweep.nearest_sphere(scene.spheres, o, d, tm)
    t_ref, k_ref = _plain(scene.spheres, o, d, tm)
    assert (np.asarray(k) == k_ref).mean() > 0.999
    hit = np.isfinite(t_ref)
    np.testing.assert_allclose(np.asarray(t)[hit], t_ref[hit], rtol=2e-3)
