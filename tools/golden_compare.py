#!/usr/bin/env python
"""Golden-image parity: this renderer vs the C++ reference algorithm.

The upstream golden (samples/cover.ppm) is not vendored, so the golden
is regenerated by tools/cpu_floor (the independent C++ implementation of
the reference algorithm) on the SAME scene our generator builds: the
scene is dumped to a text file, the C++ binary loads it, and both render
the same camera/geometry.  RNG streams differ, so parity is judged on
downsampled block means of the linearised images — the converged-mean
comparison SURVEY.md §7 calls for.

Usage: python tools/golden_compare.py [--mesh] [width spp depth [segments rings]]
                                      [--record PATH]
Cover defaults: 1200x675, 256 spp, depth 50.  Mesh (``--mesh``) defaults:
the 65,536-triangle knot at 400x400, 64 spp, depth 20.  Prints per-block
statistics and exits nonzero if the images disagree beyond MC noise;
``--record PATH`` merges the statistics into the JSON file at PATH.
A small-config run is part of the pytest suite (tests/test_golden.py).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)


def dump_scene(scene, path: str) -> None:

    sp = scene.spheres
    mats = scene.materials
    c0 = np.asarray(sp.center0, np.float64)
    dc = np.asarray(sp.dcenter, np.float64)
    r = np.asarray(sp.radius, np.float64)
    mid = np.asarray(sp.material)
    kind = np.asarray(mats.kind)[mid]
    al = np.asarray(mats.albedo, np.float64)[mid]
    fz = np.asarray(mats.fuzz, np.float64)[mid]
    ir = np.asarray(mats.ir, np.float64)[mid]
    with open(path, "w") as f:
        for i in range(r.shape[0]):
            f.write(
                f"{c0[i,0]} {c0[i,1]} {c0[i,2]} {dc[i,0]} {dc[i,1]} {dc[i,2]} "
                f"{r[i]} {int(kind[i])} {al[i,0]} {al[i,1]} {al[i,2]} "
                f"{fz[i]} {ir[i]}\n"
            )


def block_means(img: np.ndarray, bs: int = 24) -> np.ndarray:
    h, w, _ = img.shape
    hb, wb = h // bs, w // bs
    return img[: hb * bs, : wb * bs].reshape(hb, bs, wb, bs, 3).mean(axis=(1, 3))


def _ensure_cpu_floor() -> str:
    cpu_bin = os.path.join(HERE, "cpu_floor")
    if not os.path.exists(cpu_bin):
        tmp = f"{cpu_bin}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        os.path.join(HERE, "cpu_floor.cpp"), "-o", tmp],
                       check=True)
        os.replace(tmp, cpu_bin)  # atomic under concurrent builds
    return cpu_bin


def _cpp_render(width, spp, depth, scene_path, workdir) -> np.ndarray:
    out = os.path.join(workdir, "golden_cpp.ppm")
    subprocess.run(
        [_ensure_cpu_floor(), str(width), str(spp), str(depth),
         str(os.cpu_count()), scene_path, out],
        check=True, timeout=3600,
    )
    from rtow_tpu.utils.ppm import decode_ppm, read_ppm

    with open(out) as f:
        return decode_ppm(read_ppm(f))


def block_parity(golden, img, spp, bs, config) -> dict:
    """Block-mean agreement of two images within MC noise -> stats."""
    diff = np.abs(block_means(golden, bs) - block_means(img, bs))
    noise = 1.0 / np.sqrt(spp * bs * bs)  # block-mean MC sigma scale
    ok = bool(diff.mean() < 6 * noise and diff.max() < 0.06)
    return {"config": config,
            "block_mean_abs_diff": float(diff.mean()),
            "block_max_abs_diff": float(diff.max()),
            "block_mc_sigma": float(noise), "ok": ok}


def cover_parity(width=1200, spp=256, depth=50) -> dict:
    """Cover scene through ``render_auto`` vs the C++ render -> stats."""
    from rtow_tpu.config import Config
    from rtow_tpu.models.builders import cover_scene
    from rtow_tpu.pipeline import render_auto

    cfg = Config(image_width=width, aspect_ratio=16.0 / 9.0,
                 samples_per_pixel=spp, max_child_rays=depth)
    scene, cam = cover_scene(cfg)
    with tempfile.TemporaryDirectory() as workdir:
        scene_txt = os.path.join(workdir, "golden_scene.txt")
        dump_scene(scene, scene_txt)
        print(f"C++ golden render {width}px spp={spp}...", file=sys.stderr)
        golden = _cpp_render(width, spp, depth, scene_txt, workdir)
    img = render_auto(scene, cam, cfg)
    return block_parity(golden, img, spp, 24,
                    {"width": width, "spp": spp, "depth": depth})


def knot_scene(segments: int, rings: int):
    """The trefoil-knot mesh scene and camera of the mesh benchmark."""
    from make_mesh import make_knot

    from rtow_tpu.models.camera import make_camera
    from rtow_tpu.models.scene import SceneBuilder

    verts, faces = make_knot(segments, rings)
    b = SceneBuilder()
    b.add_mesh(verts[faces], b.add_lambertian((0.6, 0.5, 0.4)))
    cam = make_camera(lookfrom=(0.0, 0.0, 3.0), lookat=(0.0, 0.0, 0.0),
                      fov_degrees=45.0, aspect_ratio=1.0, aperture=0.0,
                      focus_dist=3.0)
    return b.build(), cam, verts, faces


def mesh_parity(width=400, spp=64, depth=20, segments=256, rings=128) -> dict:
    """Knot through ``render_auto`` (BVH path) vs the C++ BVH render of
    the SAME OBJ (same camera, material and tone map) -> stats."""
    from rtow_tpu.config import Config
    from rtow_tpu.pipeline import render_auto

    scene, cam, verts, faces = knot_scene(segments, rings)
    with tempfile.TemporaryDirectory() as workdir:
        obj_path = os.path.join(workdir, "golden_knot.obj")
        with open(obj_path, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
            for a, b, c in faces + 1:
                f.write(f"f {a} {b} {c}\n")
        print(f"C++ mesh golden render {width}px spp={spp} "
              f"({faces.shape[0]} tris)...", file=sys.stderr)
        golden = _cpp_render(width, spp, depth, obj_path, workdir)
    cfg = Config(image_width=width, aspect_ratio=1.0, samples_per_pixel=spp,
                 max_child_rays=depth)
    img = render_auto(scene, cam, cfg)
    return block_parity(golden, img, spp, max(8, width // 16),
                    {"width": width, "spp": spp, "depth": depth,
                     "tris": int(faces.shape[0])})


def _record(path: str, key: str, entry: dict) -> None:
    """Merge one parity record into the JSON file at ``path``."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data[key] = entry
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    record = None
    if "--record" in argv:
        i = argv.index("--record")
        record = argv[i + 1]
        del argv[i:i + 2]
    mesh = argv[:1] == ["--mesh"]
    nums = [int(a) for a in argv[int(mesh):]]
    stats = (mesh_parity if mesh else cover_parity)(*nums)
    print(f"block-mean abs diff: mean {stats['block_mean_abs_diff']:.4f} "
          f"max {stats['block_max_abs_diff']:.4f} "
          f"(block MC sigma ~{stats['block_mc_sigma']:.4f})")
    print("PARITY OK" if stats["ok"] else "PARITY FAIL")
    if record:
        _record(record, "mesh" if mesh else "cover", stats)
    return 0 if stats["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
