"""Russian-roulette termination (BASELINE north star).

The reference terminates paths by depth budget alone
(src/render.cpp:114-115); RR is an opt-in throughput lever here, so it
must be (a) OFF by default, (b) unbiased — E[boosted estimator] equals
the plain estimator — and (c) wired through both forward paths (the
progressive while-loop integrator and the flat scan integrator).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rtow_tpu.config import Config
from rtow_tpu.models.builders import one_sphere_scene, three_sphere_scene
from rtow_tpu.ops import integrator, intersect
from rtow_tpu.ops.integrator import RR_PMIN, RR_START, _roulette
from rtow_tpu.render import render


def _rays_into_sphere(n):
    """n camera rays all aimed at a unit sphere (deep scatter chains)."""
    from rtow_tpu.models.camera import Rays
    o = jnp.tile(jnp.array([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]]), (n, 1))
    return Rays(origin=o, direction=d, time=jnp.zeros((n,)))


def test_roulette_helper_boost_is_unbiased_pointwise():
    """E[I(u<p)/p] = 1 for the clamped survival probability."""
    n = 200_000
    key = jax.random.key(0)
    tp = jnp.full((n, 3), 0.3)  # p = 0.3 after clamp
    alive = jnp.ones((n,), bool)
    scatters = jnp.full((n,), RR_START, jnp.int32)
    tp2, alive2 = _roulette(key, tp, alive, scatters, jnp.float32)
    # Survivors are boosted 1/p; mean throughput over ALL lanes (dead
    # lanes contribute 0) must equal the original throughput.
    eff = jnp.where(alive2[:, None], tp2, 0.0)
    np.testing.assert_allclose(float(eff.mean()), 0.3, rtol=0.02)
    # Kill rate ~= 1 - p.
    np.testing.assert_allclose(float(alive2.mean()), 0.3, rtol=0.02)


def test_roulette_never_kills_short_paths():
    key = jax.random.key(1)
    tp = jnp.full((64, 3), 1e-4)  # would die with near-certainty
    alive = jnp.ones((64,), bool)
    scatters = jnp.full((64,), RR_START - 1, jnp.int32)
    tp2, alive2 = _roulette(key, tp, alive, scatters, jnp.float32)
    assert bool(alive2.all())
    np.testing.assert_array_equal(np.asarray(tp2), np.asarray(tp))


def test_roulette_pmin_clamp_bounds_boost():
    key = jax.random.key(2)
    tp = jnp.full((4096, 3), 1e-6)
    alive = jnp.ones((4096,), bool)
    scatters = jnp.full((4096,), RR_START, jnp.int32)
    tp2, alive2 = _roulette(key, tp, alive, scatters, jnp.float32)
    boost = np.asarray(tp2)[np.asarray(alive2)] / 1e-6
    assert boost.size  # some survive at p = PMIN
    assert np.all(boost <= 1.0 / RR_PMIN + 1e-3)


def test_trace_rr_unbiased_vs_plain():
    """Scan integrator: RR estimate within MC error of the plain one."""
    scene, _ = one_sphere_scene(aspect_ratio=1.0)
    rays = _rays_into_sphere(4096)
    depth = 16
    plain = integrator.trace(scene, rays, jax.random.key(3), depth)
    rr = integrator.trace(scene, rays, jax.random.key(4), depth,
                          russian_roulette=True)
    noise = integrator.trace(scene, rays, jax.random.key(5), depth)
    tol = 4 * float(jnp.abs(noise.mean(0) - plain.mean(0)).max()) + 0.01
    assert float(jnp.abs(rr.mean(0) - plain.mean(0)).max()) < tol


def test_render_rr_image_statistically_equal():
    """Whole-frame jnp render (progressive wavefront path) with RR on."""
    scene, cam = three_sphere_scene(aspect_ratio=1.0)
    W = H = 24
    base = Config(image_width=W, aspect_ratio=1.0, samples_per_pixel=48,
                  max_child_rays=12)
    img = render(scene, cam, base)
    img_rr = render(scene, cam, Config(
        image_width=W, aspect_ratio=1.0, samples_per_pixel=48,
        max_child_rays=12, russian_roulette=True, seed=11))
    img_b = render(scene, cam, Config(
        image_width=W, aspect_ratio=1.0, samples_per_pixel=48,
        max_child_rays=12, seed=99))
    noise = np.abs(np.asarray(img_b) - np.asarray(img)).mean()
    # RR adds variance (it's a variance/cost trade): give it headroom
    # above seed noise but require the same converged mean.
    assert np.abs(np.asarray(img_rr) - np.asarray(img)).mean() < \
        max(4 * noise, 0.04)
    assert abs(float(np.mean(img_rr)) - float(np.mean(img))) < \
        max(4 * noise, 0.02)


@pytest.mark.parametrize("flat", [False, True])
def test_rr_short_depth_identical(flat):
    """depth <= RR_START means RR can never fire: images identical, on
    the progressive path and on the flat scan path."""
    scene, cam = one_sphere_scene(aspect_ratio=1.0)
    nearest = intersect.nearest_hit_bruteforce if flat else None
    base = dict(image_width=16, aspect_ratio=1.0, samples_per_pixel=8,
                max_child_rays=RR_START, seed=3)
    a = render(scene, cam, Config(**base), nearest_hit=nearest)
    b = render(scene, cam, Config(**base, russian_roulette=True),
               nearest_hit=nearest)
    np.testing.assert_array_equal(a, b)


def test_cli_flag_roundtrip():
    from rtow_tpu.cli import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(["--russian-roulette"]))
    assert cfg.russian_roulette
    cfg = config_from_args(build_parser().parse_args([]))
    assert not cfg.russian_roulette  # reference-faithful default
