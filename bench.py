#!/usr/bin/env python
"""Benchmark harness: cover-scene throughput on the current JAX backend.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Workload: the book-cover ball field (reference src/main.cpp:23-83) at the
north-star frame size 1200x675, depth 50 (BASELINE.json).  Throughput is
reported in primary Mrays/s (= pixel-samples per second; each primary ray
carries its full transport through the bounce loop, so this is directly
comparable across implementations on the same workload).

``value`` is the MEDIAN of ``RTOW_BENCH_REPEATS`` timed runs at the
default spp; ``min``/``max`` bound the spread.  The north-star config
(spp=500) is additionally reported as ``northstar_mrays`` unless
RTOW_BENCH_NORTHSTAR=0.  ``device`` names the platform, device kind and
count, and on a GPU the card's name and power limit from nvidia-smi.

``vs_baseline`` compares the median against the measured CPU floor of
the reference implementation stored in baseline_measured.json (written
by tools/measure_cpu_floor.py); 0.0 if no floor has been recorded yet.

Further legs, each through the normal entry points and each skippable:
the 65,536-triangle knot at 400x400 spp=64 depth=20 through
``render_auto`` (``mesh_mrays``, RTOW_BENCH_MESH=0 skips; the 360k knot
is not run on this path yet); Russian roulette on the cover
(``roulette_mrays`` + ``roulette_dradiance``, RTOW_BENCH_RR=0); the
n=1 ``render_sharded`` step against the direct render
(``sharded_vs_direct``, RTOW_BENCH_SHARDED=0); and the gradient at the
cover's training shapes, 400x267/16spp/depth8, through
``diff.loss_and_grad`` (``grad_fwd_mrays``/``grad_fwdbwd_ratio``,
RTOW_BENCH_GRAD=0).

Env overrides: RTOW_BENCH_SPP, RTOW_BENCH_WIDTH, RTOW_BENCH_DEPTH,
RTOW_BENCH_REPEATS, RTOW_BENCH_NORTHSTAR, RTOW_BENCH_MESH, RTOW_BENCH_GRAD,
RTOW_BENCH_RR, RTOW_BENCH_SHARDED.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax


def _render_once(scene, camera, cfg):
    """One timed whole-frame render through render_auto -> seconds."""
    from rtow_tpu.pipeline import render_auto

    t0 = time.perf_counter()
    img = render_auto(scene, camera, cfg)
    return time.perf_counter() - t0, img


def _device() -> dict:
    """The device the legs ran on, as JAX reports it, plus the card's
    name and power limit on a GPU."""
    import subprocess

    d = jax.devices()[0]
    out = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    return out


def main() -> int:
    if "--quick" in sys.argv:
        # Smoke mode (the verify recipe's sanity check): one small
        # render, every other leg off — finishes in seconds on any
        # backend and still prints the one JSON line.
        for k, v in (("RTOW_BENCH_WIDTH", "200"), ("RTOW_BENCH_SPP", "8"),
                     ("RTOW_BENCH_DEPTH", "8"), ("RTOW_BENCH_REPEATS", "1"),
                     ("RTOW_BENCH_NORTHSTAR", "0"), ("RTOW_BENCH_MESH", "0"),
                     ("RTOW_BENCH_RR", "0"), ("RTOW_BENCH_SHARDED", "0"),
                     ("RTOW_BENCH_GRAD", "0")):
            os.environ.setdefault(k, v)
    spp = int(os.environ.get("RTOW_BENCH_SPP", "128"))
    width = int(os.environ.get("RTOW_BENCH_WIDTH", "1200"))
    depth = int(os.environ.get("RTOW_BENCH_DEPTH", "50"))
    repeats = int(os.environ.get("RTOW_BENCH_REPEATS", "3"))
    northstar = os.environ.get("RTOW_BENCH_NORTHSTAR", "1") != "0"

    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene

    def cfg_for(n_spp, roulette=False):
        return Config(
            image_width=width, aspect_ratio=16.0 / 9.0, samples_per_pixel=n_spp,
            max_child_rays=depth, russian_roulette=roulette,
        )

    cfg = cfg_for(spp)
    scene, camera = cover_scene(cfg)
    print(
        f"bench: cover scene {cfg.image_width}x{cfg.image_height} spp={spp} "
        f"depth={depth} on {jax.devices()[0].platform}, "
        f"{repeats} repeats",
        file=sys.stderr,
    )

    _render_once(scene, camera, cfg)  # warm-up/compile
    lanes = cfg.image_width * cfg.image_height * spp
    samples = []
    img = None
    for i in range(repeats):
        elapsed, img = _render_once(scene, camera, cfg)
        samples.append(lanes / elapsed / 1e6)
        print(f"bench: run {i + 1}/{repeats}: {elapsed:.2f}s "
              f"= {samples[-1]:.2f} Mrays/s", file=sys.stderr)
    med = statistics.median(samples)
    print(f"bench: mean radiance {float(img.mean()):.4f}", file=sys.stderr)

    ns_mrays = None
    if northstar:
        ns_cfg = cfg_for(500)
        _render_once(scene, camera, ns_cfg)  # compile
        # Median of 3 (same methodology as every other leg).
        ns_samples = [_render_once(scene, camera, ns_cfg)[0]
                      for _ in range(3)]
        ns_elapsed = statistics.median(ns_samples)
        ns_lanes = cfg.image_width * cfg.image_height * 500
        ns_mrays = ns_lanes / ns_elapsed / 1e6
        print(f"bench: north-star 500spp: {ns_elapsed:.2f}s "
              f"= {ns_mrays:.2f} Mrays/s "
              f"(runs {', '.join(f'{t:.2f}' for t in ns_samples)})",
              file=sys.stderr)

    mesh_mrays = None
    if os.environ.get("RTOW_BENCH_MESH", "1") != "0":
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tools"))
        from golden_compare import knot_scene

        knot, kcam, _, _ = knot_scene(256, 128)  # 65,536 triangles
        kcfg = Config(image_width=400, aspect_ratio=1.0,
                      samples_per_pixel=64, max_child_rays=20)
        _render_once(knot, kcam, kcfg)  # warm-up/compile
        ksamples = []
        for i in range(repeats):
            kel = _render_once(knot, kcam, kcfg)[0]
            ksamples.append(400 * 400 * 64 / kel / 1e6)
            print(f"bench: mesh65k run {i + 1}/{repeats}: {kel:.2f}s "
                  f"= {ksamples[-1]:.2f} Mrays/s", file=sys.stderr)
        mesh_mrays = statistics.median(ksamples)

    rr_mrays = rr_drad = None
    if os.environ.get("RTOW_BENCH_RR", "1") != "0":
        # Russian-roulette throughput lever at the reference's depth-50
        # budget (north star names RR; off by default for fidelity —
        # the estimator is unbiased, so the radiance delta is MC noise).
        rr_cfg = cfg_for(spp, roulette=True)
        _render_once(scene, camera, rr_cfg)  # compile
        rr_elapsed, rr_img = _render_once(scene, camera, rr_cfg)
        rr_mrays = lanes / rr_elapsed / 1e6
        rr_drad = float(rr_img.mean()) - float(img.mean())
        print(f"bench: russian roulette spp{spp}: {rr_elapsed:.2f}s "
              f"= {rr_mrays:.2f} Mrays/s (plain {med:.2f}), "
              f"mean-radiance delta {rr_drad:+.5f}", file=sys.stderr)

    sharded_ratio = None
    if os.environ.get("RTOW_BENCH_SHARDED", "1") != "0":
        # The measurable leg of the >=90% scaling gate: the n=1
        # shard_map step vs the direct render above.
        from rtow_tpu.parallel.mesh import make_mesh
        from rtow_tpu.parallel.sharded import render_sharded

        smesh = make_mesh(1, spp)
        render_sharded(scene, camera, cfg, mesh=smesh)  # compile
        s_samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            render_sharded(scene, camera, cfg, mesh=smesh)
            s_samples.append(time.perf_counter() - t0)
        s_elapsed = statistics.median(s_samples)
        s_mrays = lanes / s_elapsed / 1e6
        sharded_ratio = s_mrays / med
        print(f"bench: sharded n=1: {s_elapsed:.2f}s = {s_mrays:.2f} "
              f"Mrays/s ({sharded_ratio:.1%} of direct)", file=sys.stderr)

    grad_mrays = grad_ratio = None
    if os.environ.get("RTOW_BENCH_GRAD", "1") != "0":
        # Gradient metric (north star: verified gradients, fwd+bwd <= 3x
        # fwd) at the cover's training shapes.
        import jax.numpy as jnp

        from rtow_tpu.diff import loss_and_grad, render_pixels

        gcfg = Config(image_width=400, aspect_ratio=1.5,
                      samples_per_pixel=16, max_child_rays=8)
        gscene, gcam = cover_scene(gcfg)
        gw, gh = 400, 267
        gpix = jnp.arange(gw * gh, dtype=jnp.int32)
        gtarget = jnp.zeros((gw * gh, 3), jnp.float32)
        gkey = jax.random.key(0)
        kw = dict(width=gw, height=gh, spp=16, max_depth=8)
        fwd = jax.jit(lambda s: render_pixels(s, gcam, gkey, gpix, **kw))
        lg = jax.jit(lambda s: loss_and_grad(s, gcam, gkey, gtarget, gpix,
                                             **kw))
        jax.block_until_ready(fwd(gscene))  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(fwd(gscene))
        gf = time.perf_counter() - t0
        jax.block_until_ready(lg(gscene))  # compile
        t0 = time.perf_counter()
        jax.block_until_ready(lg(gscene))
        gfb = time.perf_counter() - t0
        grad_mrays = gw * gh * 16 / gf / 1e6
        grad_ratio = gfb / gf
        print(f"bench: grad fwd {gf:.3f}s ({grad_mrays:.2f} Mrays/s), "
              f"fwd+bwd {gfb:.3f}s (x{grad_ratio:.2f})", file=sys.stderr)

    floor = 0.0
    floor_path = os.path.join(os.path.dirname(__file__), "baseline_measured.json")
    if os.path.exists(floor_path):
        with open(floor_path) as f:
            floor = float(json.load(f).get("cpu_floor_mrays_per_s", 0.0))

    out = {
        "metric": "cover_scene_primary_rays",
        "value": round(med, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(med / floor, 3) if floor > 0 else 0.0,
        "repeats": repeats,
        "min": round(min(samples), 3),
        "max": round(max(samples), 3),
        "spp": spp,
        "device": _device(),
    }
    if ns_mrays is not None:
        out["northstar_mrays"] = round(ns_mrays, 3)
        out["northstar_vs_baseline"] = (
            round(ns_mrays / floor, 3) if floor > 0 else 0.0
        )
    if mesh_mrays is not None:
        mesh_floor = 0.0
        if os.path.exists(floor_path):
            with open(floor_path) as f:
                mesh_floor = float(
                    json.load(f).get("mesh65k_floor_mrays_per_s", 0.0))
        out["mesh_mrays"] = round(mesh_mrays, 3)
        out["mesh_vs_baseline"] = (
            round(mesh_mrays / mesh_floor, 3) if mesh_floor > 0 else 0.0
        )
    if rr_mrays is not None:
        out["roulette_mrays"] = round(rr_mrays, 3)
        out["roulette_dradiance"] = round(rr_drad, 5)
    if sharded_ratio is not None:
        out["sharded_vs_direct"] = round(sharded_ratio, 3)
    if grad_mrays is not None:
        out["grad_fwd_mrays"] = round(grad_mrays, 3)
        out["grad_fwdbwd_ratio"] = round(grad_ratio, 3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
