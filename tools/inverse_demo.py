"""Inverse rendering end-to-end on the gradient path.

Render a target image, then recover MATERIAL parameters the optimizer
never saw — the ground, diffuse sphere and metal albedos — by gradient
descent through ``diff.loss_and_grad`` (a ``lax.scan`` over bounces,
checkpointed per bounce).  Writes ``samples/inverse.png``
([target | initial | recovered]) and prints per-parameter errors.

Scope note: material/shading parameters have exact gradients; geometry
recovery beyond small offsets needs silhouette gradients, which the
framework deliberately treats as piecewise-constant (diff.py) — the
standard edge-sampling extension is out of scope, and a position
attempt here plateaus once the residual is silhouette-dominated
(measured: center error 0.17 -> 0.13, then flat).

Run: ``python tools/inverse_demo.py`` (``--cornell`` for the emissive
scene with next-event estimation).
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from rtow_tpu.diff import loss_and_grad, mask_grads, render_pixels, sgd_update
from rtow_tpu.models.builders import three_sphere_scene

W, H = 96, 64
SPP, DEPTH = 16, 5
STEPS = int(os.environ.get("INV_STEPS", "800"))
LR = 8.0


def main() -> int:
    scene_true, cam = three_sphere_scene(aspect_ratio=W / H)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH)

    render = jax.jit(lambda s, k: render_pixels(s, cam, k, pix, **kw))
    target = render(scene_true, jax.random.key(123))

    # Recolor three materials.  three_sphere_scene material layout:
    # 0 ground (0.8, 0.8, 0), 1 center Lambertian (0.1, 0.2, 0.5),
    # 2 dielectric, 3 metal (0.8, 0.6, 0.2).
    mats = scene_true.materials
    albedo = mats.albedo
    albedo = albedo.at[0].set(jnp.asarray([0.3, 0.3, 0.7]))
    albedo = albedo.at[1].set(jnp.asarray([0.6, 0.5, 0.1]))
    albedo = albedo.at[3].set(jnp.asarray([0.2, 0.8, 0.8]))
    scene = dataclasses.replace(
        scene_true, materials=dataclasses.replace(mats, albedo=albedo))
    init_scene = scene

    keep = lambda path: path.endswith("albedo")

    @jax.jit
    def step(scene, key):
        loss, grads = loss_and_grad(scene, cam, key, target, pix,
                                           **kw)
        grads = mask_grads(grads, keep)
        new = sgd_update(scene, grads, LR)
        # Keep parameters physical.
        new = dataclasses.replace(
            new, materials=dataclasses.replace(
                new.materials,
                albedo=jnp.clip(new.materials.albedo, 0.0, 1.0)))
        return new, loss

    t0 = time.perf_counter()
    key = jax.random.key(7)
    for i in range(STEPS):
        key, k = jax.random.split(key)
        scene, loss = step(scene, k)
        if i % 25 == 0 or i == STEPS - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}", file=sys.stderr)
    jax.block_until_ready(scene)
    dt = time.perf_counter() - t0
    print(f"{STEPS} steps in {dt:.1f}s ({dt / STEPS * 1e3:.0f} ms/step)",
          file=sys.stderr)

    def report(name, getter):
        e0 = float(jnp.abs(getter(init_scene) - getter(scene_true)).mean())
        e1 = float(jnp.abs(getter(scene) - getter(scene_true)).mean())
        print(f"{name} error {e0:.3f} -> {e1:.3f}", file=sys.stderr)
        return e1

    g_err = report("ground albedo ", lambda s: s.materials.albedo[0])
    a_err = report("diffuse albedo", lambda s: s.materials.albedo[1])
    m_err = report("metal tint    ", lambda s: s.materials.albedo[3])

    # [target | initial | recovered] strip at a clean 4x spp.
    def frame(s):
        img = np.asarray(jax.jit(
            lambda sc, k: render_pixels(sc, cam, k, pix, width=W,
                                               height=H, spp=64,
                                               max_depth=DEPTH)
        )(s, jax.random.key(5)))
        g = np.clip(np.sqrt(np.clip(img, 0, None)), 0, 0.999)
        return (g.reshape(H, W, 3) * 256).astype(np.uint8)

    strip = np.concatenate(
        [frame(scene_true), frame(init_scene), frame(scene)], axis=1)
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "samples", "inverse.png")
    try:
        from PIL import Image

        Image.fromarray(strip).save(out)
        print(f"wrote {out}", file=sys.stderr)
    except ImportError:
        print("Pillow unavailable; skipped PNG", file=sys.stderr)

    ok = g_err < 0.05 and a_err < 0.05 and m_err < 0.05
    print(f"recovered: {ok}", file=sys.stderr)
    return 0 if ok else 1


def cornell_main() -> int:
    """Emissive-scene inverse rendering (``--cornell``).

    Recovers the ceiling lamp's emitted radiance AND the red wall's
    albedo through the low-variance NEE/MIS estimator
    (``render_pixels(nee=True)``), and reports the fwd+bwd / fwd
    wall-clock ratio (north-star gate: <= 3x forward).
    """
    from rtow_tpu.models.builders import cornell_scene

    W2, H2 = 64, 64
    spp, depth = 16, 4
    steps = int(os.environ.get("INV_STEPS", "400"))
    scene_true, cam = cornell_scene(aspect_ratio=W2 / H2)
    pix = jnp.arange(W2 * H2, dtype=jnp.int32)
    kw = dict(width=W2, height=H2, spp=spp, max_depth=depth, nee=True)

    render = jax.jit(lambda s, k: render_pixels(s, cam, k, pix, **kw))
    target = render(scene_true, jax.random.key(123))

    # cornell_scene material layout: 0 white, 1 red, 2 green, 3 lamp
    # (15, 15, 15), 4 mirror.  Perturb the lamp's emission and the red
    # wall's albedo; the optimizer must pull both back.
    mats = scene_true.materials
    albedo = mats.albedo
    albedo = albedo.at[3].set(jnp.asarray([5.0, 5.0, 5.0]))
    albedo = albedo.at[1].set(jnp.asarray([0.4, 0.4, 0.4]))
    scene = dataclasses.replace(
        scene_true, materials=dataclasses.replace(mats, albedo=albedo))
    init_scene = scene

    keep = lambda path: path.endswith("albedo")
    #: Per-row learning rates: emission lives on a ~15x larger scale
    #: than reflectance, so its row takes a proportionally larger step
    #: (rates sized from the measured grad magnitudes: lamp ~0.028,
    #: walls ~0.001 at init on this config).
    row_lr = jnp.full((albedo.shape[0], 1), 30.0).at[3].set(60.0)

    @jax.jit
    def step(scene, key):
        loss, grads = loss_and_grad(scene, cam, key, target, pix,
                                           **kw)
        grads = mask_grads(grads, keep)
        g = grads.materials.albedo * row_lr
        new_albedo = scene.materials.albedo - g
        new_albedo = jnp.clip(new_albedo, 0.0,
                              jnp.asarray([[1.0]] * 3 + [[30.0]] + [[1.0]]))
        return dataclasses.replace(
            scene, materials=dataclasses.replace(
                scene.materials, albedo=new_albedo)), loss

    # fwd vs fwd+bwd timing (the <= 3x gate); medians of 5.
    lg = jax.jit(lambda s, k: loss_and_grad(s, cam, k, target, pix,
                                                   **kw))

    def _median_time(fn):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[2]

    t_fwd = _median_time(lambda: render(scene, jax.random.key(1)))
    t_fb = _median_time(lambda: lg(scene, jax.random.key(1)))
    ratio = t_fb / t_fwd
    print(f"cornell NEE: fwd {t_fwd * 1e3:.1f} ms, fwd+bwd "
          f"{t_fb * 1e3:.1f} ms (x{ratio:.2f})", file=sys.stderr)

    t0 = time.perf_counter()
    key = jax.random.key(7)
    for i in range(steps):
        key, k = jax.random.split(key)
        scene, loss = step(scene, k)
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}", file=sys.stderr)
    jax.block_until_ready(scene)
    dt = time.perf_counter() - t0
    print(f"{steps} steps in {dt:.1f}s ({dt / steps * 1e3:.0f} ms/step)",
          file=sys.stderr)

    def report(name, getter, scale=1.0):
        e0 = float(jnp.abs(getter(init_scene) - getter(scene_true)).mean())
        e1 = float(jnp.abs(getter(scene) - getter(scene_true)).mean())
        print(f"{name} error {e0:.3f} -> {e1:.3f}", file=sys.stderr)
        return e1 / scale

    l_err = report("lamp emission ", lambda s: s.materials.albedo[3],
                   scale=15.0)
    r_err = report("red wall      ", lambda s: s.materials.albedo[1])

    ok = l_err < 0.05 and r_err < 0.05 and ratio <= 3.0
    print(f"recovered: {ok} (ratio {ratio:.2f} <= 3.0: {ratio <= 3.0})",
          file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    if "--cornell" in sys.argv:
        raise SystemExit(cornell_main())
    raise SystemExit(main())
