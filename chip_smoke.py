#!/usr/bin/env python
"""Smoke test of the path tracer on an NVIDIA GPU, through the entry points
a user calls, at the sizes users render.

    python chip_smoke.py            # one card: phases 1-6 below
    python chip_smoke.py --cards 4  # four cards: the sharded paths only

One card:
  1. device: JAX's devices and the card's name and power limit; anything
     but a GPU exits non-zero (no CPU fallback);
  2. cover: the book-cover frame at 1200x675, depth 50, 32 spp through
     ``pipeline.render_auto``; first and second call times, peak memory;
  3. parity: the cover through ``render_auto`` against the C++ reference
     algorithm (``tools/cpu_floor.cpp``), block means within MC noise;
  4. mesh: the 65,536-triangle knot at 400x400, 64 spp, depth 20 through
     ``render_auto`` (BVH path), then mesh parity with the C++ render;
  5. gather: the hit-record fetch (a gather) against a one-hot matmul
     reference at 262,144 lanes, on the cover and on the 65k knot; every
     HitRecord field, and a small image of each scene, must be
     bit-identical;
  6. train: three steps of ``diff.build_train_step`` on a one-card mesh at
     the cover's training shapes (400x267, 16 spp, depth 8);
  7. sweep: the Triton-route sphere-sweep kernel (``ops/sphere_sweep.py``)
     as compiled for the card against XLA's fusion of the plain sweep at
     262,144 lanes on the cover's spheres: same winners, and both times.

Four cards: the cover at 1200x675, 32 spp sharded by ``render_sharded``
over a (tile, spp) mesh against the one-card render, and the sharded
training step with and without the overlapped gradient all-reduce.

Every check that fails raises, so the process exits non-zero; the last
line of standard output is one JSON object only when every phase passed.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Lanes per chunk of the renderer (Config.rays_per_batch): the width at
#: which phase 5 compares the two fetches.
LANES = 1 << 18


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def report(phase: str, **values) -> dict:
    print(f"phase {phase}: {json.dumps(values, default=str)}", flush=True)
    return values


def peak_bytes(device=None):
    """Peak device memory in use by this process so far (None where the
    backend keeps no statistics, as on the CPU)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------- phase 1
def phase_device(cards: int) -> dict:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    info = {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}
    report("device", **info, devices=[str(d) for d in devs])
    check(d0.platform == "gpu", f"no GPU: JAX runs on {d0.platform}")
    check(len(devs) >= cards, f"{cards} cards asked for, {len(devs)} present")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        print(f"card: {line}", flush=True)
    return info


# ---------------------------------------------------------------- phase 2
def phase_cover(width=1200, spp=32, depth=50) -> dict:
    import numpy as np

    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.pipeline import render_auto

    cfg = Config(image_width=width, aspect_ratio=16.0 / 9.0,
                 samples_per_pixel=spp, max_child_rays=depth)
    scene, cam = cover_scene(cfg)
    # As the CLI calls it: with the scanline ticker (a host callback).
    t0 = time.perf_counter()
    img = render_auto(scene, cam, cfg, progress=True)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render_auto(scene, cam, cfg, progress=True)
    second = time.perf_counter() - t0
    mean = float(img.mean())
    rays = width * cfg.image_height * spp
    out = report(
        "cover", size=f"{width}x{cfg.image_height}", spp=spp, depth=depth,
        first_call_s=first,
        # render() builds a fresh jax.jit per call: the second call
        # re-traces and at best hits the persistent compile cache.
        second_call_retrace_s=second,
        second_call_mrays_per_s=rays / second / 1e6,
        peak_bytes_in_use=peak_bytes(), mean_radiance=mean,
        spheres=scene.n_spheres)
    check(img.shape == (cfg.image_height, width, 3), f"shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite pixels in the cover")
    check(0.2 < mean < 1.0, f"cover mean radiance {mean} out of range")
    return out


# ---------------------------------------------------------------- phase 3
def phase_parity(width=300, spp=64, depth=50) -> dict:
    import golden_compare

    stats = golden_compare.cover_parity(width, spp, depth)
    report("parity", **stats)
    check(stats["ok"], "cover block means disagree with the C++ reference")
    return stats


# ---------------------------------------------------------------- phase 4
def phase_mesh(width=400, spp=64, depth=20, segments=256, rings=128,
               parity=(128, 16, 8)) -> dict:
    import numpy as np

    import golden_compare
    from rtow_tpu.config import Config
    from rtow_tpu.pipeline import render_auto

    scene, cam, _, _ = golden_compare.knot_scene(segments, rings)
    cfg = Config(image_width=width, aspect_ratio=1.0, samples_per_pixel=spp,
                 max_child_rays=depth)
    t0 = time.perf_counter()
    render_auto(scene, cam, cfg)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = render_auto(scene, cam, cfg)
    second = time.perf_counter() - t0
    mean = float(img.mean())
    out = report(
        "mesh", triangles=scene.n_triangles, size=f"{width}x{width}",
        spp=spp, depth=depth, first_call_s=first,
        second_call_retrace_s=second,
        second_call_mrays_per_s=width * width * spp / second / 1e6,
        peak_bytes_in_use=peak_bytes(), mean_radiance=mean)
    check(bool(np.isfinite(img).all()), "non-finite pixels in the mesh")
    check(mean > 0.01, f"mesh rendered black (mean {mean})")
    stats = golden_compare.mesh_parity(*parity, segments, rings)
    report("mesh_parity", **stats)
    check(stats["ok"], "mesh block means disagree with the C++ reference")
    return out


# ---------------------------------------------------------------- phase 5
def onehot_rows(table, idx, chunk: int = 1 << 14):
    """Reference for ``intersect.fetch_rows``: the winner's row as a
    one-hot matmul at HIGHEST precision (exact for a 0/1 operand), taken
    over ``chunk`` lanes at a time so the one-hot operand stays small."""
    import jax
    import jax.numpy as jnp

    flat = idx.reshape(-1)
    n = flat.shape[0]
    chunk = min(chunk, n)
    pad = -n % chunk
    parts = jnp.pad(flat, (0, pad)).reshape(-1, chunk)

    def rows(ids):
        oh = (ids[:, None] == jnp.arange(table.shape[0])).astype(table.dtype)
        return jnp.matmul(oh, table, precision=jax.lax.Precision.HIGHEST)

    out = jax.lax.map(rows, parts).reshape(-1, table.shape[1])[:n]
    return out.reshape(*idx.shape, table.shape[1])


@contextlib.contextmanager
def onehot_fetch():
    """Route ``hit_record_from`` through the one-hot reference."""
    from rtow_tpu.ops import intersect

    saved = intersect.fetch_rows
    intersect.fetch_rows = onehot_rows
    try:
        yield
    finally:
        intersect.fetch_rows = saved


def _probe_rays(nearest, scene, cam, width, height, lanes, seed):
    """Camera rays, then every other one re-aimed at random from its
    first hit (secondary rays: inside hits, back faces, misses)."""
    import jax
    import jax.numpy as jnp

    from rtow_tpu.models.camera import camera_rays, pixel_coords

    k = jax.random.split(jax.random.key(seed), 4)
    pix = jax.random.randint(k[0], (lanes,), 0, width * height)
    s, t = pixel_coords(width, height, k[1], pix)
    rays = camera_rays(cam, k[2], s, t)
    first = jax.jit(lambda *a: nearest(*a))(scene, rays.origin,
                                            rays.direction, rays.time)
    again = ((jnp.arange(lanes) % 2 == 1) & first.hit)[:, None]
    origin = jnp.where(again, first.point, rays.origin)
    direction = jnp.where(again, jax.random.normal(k[3], (lanes, 3)),
                          rays.direction)
    return origin, direction, rays.time


def _records_equal(a, b) -> list:
    import numpy as np

    bad = []
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
            bad.append(name)
    return bad


def phase_gather(lanes=LANES, cover_width=1200, segments=256, rings=128,
                 image_widths=(320, 64)) -> dict:
    """HitRecords at ``lanes`` lanes, then whole images at
    ``image_widths`` (cover, knot; 4 spp, depth 8), through both fetches."""
    import jax
    import numpy as np

    import golden_compare
    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.ops import bvh, intersect
    from rtow_tpu.pipeline import render_auto

    cfg = Config(image_width=cover_width, aspect_ratio=16.0 / 9.0)
    cover, ccam = cover_scene(cfg)
    knot, kcam, _, _ = golden_compare.knot_scene(segments, rings)
    cases = [
        ("cover", cover, ccam, cover_width, cfg.image_height,
         intersect.nearest_hit_bruteforce, 16.0 / 9.0),
        ("knot", knot, kcam, 400, 400, bvh.make_nearest_hit(knot), 1.0),
    ]
    out = {}
    for (name, scene, cam, w, h, nearest, aspect), image_width in zip(
            cases, image_widths):
        o, d, tm = _probe_rays(nearest, scene, cam, w, h, lanes, seed=17)

        # A fresh function per jit: the one-hot run must trace anew.
        rec = jax.jit(lambda *a: nearest(*a))(scene, o, d, tm)
        with onehot_fetch():
            ref = jax.jit(lambda *a: nearest(*a))(scene, o, d, tm)
        bad = _records_equal(rec, ref)
        out[name] = {"lanes": lanes, "primitives": scene.n_primitives,
                     "hit_share": float(np.asarray(rec.hit).mean()),
                     "fields_differing": bad}
        check(not bad, f"{name}: gather and one-hot differ in {bad}")
        check(0.05 < out[name]["hit_share"] < 0.95,
              f"{name}: probe rays should both hit and miss")
        icfg = Config(image_width=image_width, aspect_ratio=aspect,
                      samples_per_pixel=4, max_child_rays=8)
        img = render_auto(scene, cam, icfg)
        with onehot_fetch():
            ref = render_auto(scene, cam, icfg)
        out[name]["image"] = f"{image_width}x{icfg.image_height}x4spp"
        out[name]["image_identical"] = bool(np.array_equal(img, ref))
        check(out[name]["image_identical"],
              f"{name}: images differ between the two fetches")
    report("gather", **out)
    return out


# ---------------------------------------------------------------- phase 6
def _train_setup(width, height, spp, depth, cards, overlap):
    import jax
    import jax.numpy as jnp

    from rtow_tpu.config import Config
    from rtow_tpu.diff import build_train_step
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.parallel.mesh import make_mesh

    cfg = Config(image_width=width, aspect_ratio=width / height)
    scene, cam = cover_scene(cfg)
    mesh = make_mesh(cards, spp, devices=jax.devices()[:cards])
    step = build_train_step(mesh, cam, width=width, height=height, spp=spp,
                            max_depth=depth, lr=1e-2,
                            overlap_grad_allreduce=overlap)
    target = jnp.full((width * height, 3), 0.25, jnp.float32)
    return scene, step, target


def phase_train(width=400, height=267, spp=16, depth=8, steps=3) -> dict:
    import jax
    import numpy as np

    scene, step, target = _train_setup(width, height, spp, depth, 1, False)
    key = jax.random.key(0)
    t0 = time.perf_counter()
    compiled = step.lower(scene, key, target).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    print(f"train memory_analysis: {mem}", flush=True)
    losses, times = [], []
    s = scene
    for i in range(steps):
        t0 = time.perf_counter()
        s, loss = compiled(s, jax.random.fold_in(key, i), target)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    moved = float(np.abs(np.asarray(s.materials.albedo)
                         - np.asarray(scene.materials.albedo)).max())
    out = report(
        "train", size=f"{width}x{height}", spp=spp, depth=depth,
        compile_s=compile_s, step_s=times, losses=losses,
        albedo_max_change=moved, peak_bytes_in_use=peak_bytes(),
        temp_bytes=getattr(mem, "temp_size_in_bytes", None))
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(moved > 0.0, "the train step did not move the albedos")
    return out


# ---------------------------------------------------------------- phase 7
def phase_sweep(lanes=LANES, cover_width=1200, repeats=10,
                interpret=False) -> dict:
    """The Triton-route sphere sweep against XLA's fusion of the plain
    ``sphere_ts`` + min/argmin on the cover's spheres."""
    import statistics

    import jax
    import jax.numpy as jnp
    import numpy as np

    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.ops import intersect, sphere_sweep

    cfg = Config(image_width=cover_width, aspect_ratio=16.0 / 9.0)
    scene, cam = cover_scene(cfg)
    o, d, tm = _probe_rays(intersect.nearest_hit_bruteforce, scene, cam,
                           cover_width, cfg.image_height, lanes, seed=23)

    def plain(sph, o, d, tm):
        ts = intersect.sphere_ts(sph, o, d, tm)
        return ts.min(axis=-1), ts.argmin(axis=-1).astype(jnp.int32)

    fns = {"xla": jax.jit(plain),
           "kernel": jax.jit(lambda *a: sphere_sweep.nearest_sphere(
               *a, interpret=interpret))}
    (t_ref, i_ref), (t_k, i_k) = (
        [np.asarray(x) for x in jax.block_until_ready(fns[n](
            scene.spheres, o, d, tm))] for n in ("xla", "kernel"))
    times = {n: [] for n in fns}
    for _ in range(repeats):
        for n in ("xla", "kernel", "kernel", "xla"):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[n](scene.spheres, o, d, tm))
            times[n].append(time.perf_counter() - t0)
    hit = np.isfinite(t_ref)
    rel = np.abs(t_k[hit] - t_ref[hit]) / np.maximum(np.abs(t_ref[hit]), 1e-6)
    out = report(
        "sweep", lanes=lanes, spheres=scene.n_spheres,
        median_s={n: statistics.median(v) for n, v in times.items()},
        index_agreement=float((i_k == i_ref).mean()),
        hit_agreement=float((np.isfinite(t_k) == hit).mean()),
        max_rel_t_diff=float(rel.max(initial=0.0)),
        share_rel_t_diff_over_1e3=float((rel > 1e-3).mean()))
    # Same f32 arithmetic in another order: rays leaving a surface near
    # T_MIN, and grazing hits, may flip root or winner; the bulk agrees.
    check(out["index_agreement"] > 0.999, "kernel picks other spheres")
    check(out["hit_agreement"] > 0.999, "kernel hit mask differs")
    check(out["share_rel_t_diff_over_1e3"] < 0.005,
          "kernel t differs from sphere_ts")
    return out


# ------------------------------------------------------------ four cards
def phase_sharded_cover(cards=4, width=1200, spp=32, depth=50) -> dict:
    import jax
    import numpy as np

    import golden_compare
    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.parallel.mesh import make_mesh
    from rtow_tpu.parallel.sharded import render_sharded
    from rtow_tpu.render import render

    cfg = Config(image_width=width, aspect_ratio=16.0 / 9.0,
                 samples_per_pixel=spp, max_child_rays=depth,
                 n_devices=cards)
    scene, cam = cover_scene(cfg)
    mesh = make_mesh(cards, spp, devices=jax.devices()[:cards])
    rays = width * cfg.image_height * spp
    timings = {}
    imgs = {}
    for name, fn in (
        ("sharded", lambda: render_sharded(scene, cam, cfg, mesh=mesh)),
        ("one_card", lambda: render(scene, cam, cfg)),
    ):
        fn()  # compile
        if name == "sharded":
            # Every card must have held a share of the frame.
            peaks = [peak_bytes(d) for d in jax.devices()[:cards]]
        t0 = time.perf_counter()
        imgs[name] = fn()
        timings[name] = rays / (time.perf_counter() - t0) / 1e6
    diff = golden_compare.block_parity(imgs["one_card"], imgs["sharded"],
                                       spp, 24, {"width": width, "spp": spp})
    out = report(
        "sharded_cover", cards=cards, mesh=dict(mesh.shape),
        mrays_per_s_second_call=timings, per_card_peak_bytes=peaks,
        block_mean_abs_diff=diff["block_mean_abs_diff"],
        block_max_abs_diff=diff["block_max_abs_diff"],
        block_mc_sigma=diff["block_mc_sigma"])
    check(all(np.isfinite(im).all() for im in imgs.values()),
          "non-finite pixels")
    check(diff["ok"], "sharded cover disagrees with the one-card render")
    if peaks[0] is not None:
        check(min(peaks) > 0.25 * max(peaks),
              f"work not spread over the cards: peaks {peaks}")
    return out


def phase_sharded_train(cards=4, width=400, height=267, spp=16,
                        depth=8) -> dict:
    import jax
    import numpy as np

    results = {}
    for overlap in (False, True):
        scene, step, target = _train_setup(width, height, spp, depth, cards,
                                           overlap)
        new, loss = step(scene, jax.random.key(3), target)
        results[overlap] = (float(loss), np.asarray(new.materials.albedo),
                            np.asarray(new.spheres.center0))
    (l0, a0, c0), (l1, a1, c1) = results[False], results[True]
    out = report("sharded_train", cards=cards, size=f"{width}x{height}",
                 spp=spp, depth=depth, loss=l0, loss_overlap=l1,
                 albedo_max_abs_diff=float(np.abs(a0 - a1).max()),
                 center_max_abs_diff=float(np.abs(c0 - c1).max()))
    check(np.isfinite(l0) and np.isfinite(l1), "non-finite loss")
    check(bool(np.isfinite(a0).all() and np.isfinite(a1).all()),
          "non-finite parameters")
    check(abs(l0 - l1) <= 1e-6 * max(abs(l0), 1e-12), "losses differ")
    # Equal up to f32 round-off: psum linearity reorders the sums.
    check(bool(np.allclose(a0, a1, rtol=1e-4, atol=1e-6)),
          "albedo updates differ")
    check(bool(np.allclose(c0, c1, rtol=1e-4, atol=1e-6)),
          "center updates differ")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    importlib.import_module("rtow_tpu")  # fails fast outside a checkout

    device = phase_device(args.cards)
    if args.cards == 1:
        phase_cover()
        phase_parity()
        phase_mesh()
        phase_gather()
        phase_train()
        phase_sweep()
    else:
        phase_sharded_cover(args.cards)
        phase_sharded_train(args.cards)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
