#!/usr/bin/env python
"""Measure the CPU reference floor and record it.

Compiles tools/cpu_floor.cpp (the independent re-implementation of the
reference's algorithm — recursive double-precision tracer, BVH,
std::async sample sharding) and times the cover-scene workload on this
machine's CPU.  Writes baseline_measured.json at the repo root, which
bench.py reads to compute vs_baseline.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(HERE, "cpu_floor.cpp")
BIN = os.path.join(HERE, "cpu_floor")
OUT = os.path.join(ROOT, "baseline_measured.json")


def _run(args):
    res = subprocess.run(
        [BIN] + [str(a) for a in args],
        capture_output=True, text=True, check=True, timeout=1800,
    )
    print(res.stderr, file=sys.stderr, end="")
    return float(res.stdout.split()[1])


def main() -> int:
    width = int(os.environ.get("FLOOR_WIDTH", "1200"))
    spp = int(os.environ.get("FLOOR_SPP", "4"))
    depth = int(os.environ.get("FLOOR_DEPTH", "50"))

    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", SRC, "-o", BIN],
        check=True,
    )
    mrays = _run([width, spp, depth])
    ncpu = os.cpu_count()

    # Mesh floors: the procedural knots at the bench.py mesh camera
    # (400x400 spp32 depth20, 4 threads — the reference's default
    # thread count), so mesh_vs_baseline compares the SAME workload.
    sys.path.insert(0, HERE)
    from make_mesh import make_knot

    mesh_floors = {}
    for tag, (seg, rings) in {"mesh65k": (256, 128),
                              "mesh360k": (600, 300)}.items():
        obj = os.path.join("/tmp", f"floor_{tag}.obj")
        if not os.path.exists(obj):
            verts, faces = make_knot(seg, rings)
            with open(obj, "w") as f:
                for v in verts:
                    f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
                for a, b, c in faces + 1:
                    f.write(f"f {a} {b} {c}\n")
        mesh_floors[f"{tag}_floor_mrays_per_s"] = max(
            _run([400, 32, 20, 4, obj]) for _ in range(3)
        )

    payload = {
        "cpu_floor_mrays_per_s": mrays,
        "workload": f"cover scene {width}x{int(width/(16/9))} spp={spp} depth={depth}",
        "machine": f"{ncpu}-thread CPU",
        "note": "independent re-implementation of the reference algorithm "
                "(tools/cpu_floor.cpp); reference publishes no numbers and "
                "its conan deps are unavailable",
        **mesh_floors,
        "mesh_workload": "trefoil knot 400x400 spp=32 depth=20, 4 threads, "
                         "camera (0,0,3)->origin fov45 (bench.py mesh config)",
    }
    with open(OUT, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
