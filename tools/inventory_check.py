#!/usr/bin/env python
"""SURVEY.md §2 component-inventory coverage check.

Every reference component row maps to a module + symbols of this build;
exits nonzero if anything is missing. Run: python tools/inventory_check.py
"""
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROWS = [
    ("Vector math (vec3.h)", "rtow_tpu.ops.vec",
     ["dot", "cross", "normalize", "reflect", "refract", "length2", "lerp"]),
    ("RNG (random-utils.{h,cpp})", "rtow_tpu.utils.rng",
     ["uniform", "unit_vectors", "in_unit_disk"]),
    ("Ray (common-model.h:17-31)", "rtow_tpu.models.camera", ["Rays"]),
    ("Hit record (common-model.h:40-57)", "rtow_tpu.models.materials", ["HitRecord"]),
    ("ScatterRecord (common-model.h:33-36)", "rtow_tpu.models.materials", ["ScatterResult"]),
    ("Aabb (common-model.h:59-88)", "rtow_tpu.ops.bvh", ["primitive_aabbs"]),
    ("Camera (common-model.cpp:136-167)", "rtow_tpu.models.camera",
     ["make_camera", "camera_rays", "pixel_coords"]),
    ("Materials + Schlick (common-model.cpp:13-62)", "rtow_tpu.models.materials",
     ["scatter", "schlick", "sky_color"]),
    ("Sphere/MovingSphere (common-model.cpp:64-101)", "rtow_tpu.ops.intersect", ["sphere_ts"]),
    ("Triangle (common-model.cpp:104-125)", "rtow_tpu.ops.intersect", ["triangle_ts"]),
    ("OOStore/VariantStore (common-model.h:153-167)", "rtow_tpu.models.scene",
     ["SceneBuilder", "Scene", "Spheres", "Triangles", "Materials"]),
    ("Dispatch shims (oo/variant-primitives.h)", "rtow_tpu.ops.intersect",
     ["nearest_hit_bruteforce", "hit_record_from"]),
    ("Config (render.h:11-20)", "rtow_tpu.config", ["Config"]),
    ("BVH (render.cpp:22-110)", "rtow_tpu.ops.bvh",
     ["build_bvh", "traverse", "make_nearest_hit", "FlatBVH"]),
    ("stupid_volume (render.cpp:37-50)", "rtow_tpu.utils.profiling", ["bvh_quality"]),
    ("Integrator ray_color (render.cpp:112-129)", "rtow_tpu.ops.integrator",
     ["trace", "trace_progressive"]),
    ("Renderer/scheduler (render.cpp:135-191)", "rtow_tpu.render",
     ["render", "chunk_radiance"]),
    ("write_color/PPM (render.cpp:11-20)", "rtow_tpu.utils.ppm",
     ["tonemap", "write_ppm", "read_ppm", "decode_ppm"]),
    ("lots_of_balls (main.cpp:23-83)", "rtow_tpu.models.builders", ["cover_scene"]),
    ("foo OBJ scene (main.cpp:85-136)", "rtow_tpu.models.builders", ["mesh_scene"]),
    ("tinyobjloader (main.cpp:109-131)", "rtow_tpu.utils.obj", ["load_obj"]),
    ("CLI11 app (main.cpp:138-170)", "rtow_tpu.cli", ["main", "build_parser"]),
    ("std::async fan-out (render.cpp:172-180)", "rtow_tpu.parallel.sharded",
     ["render_sharded", "build_sharded_step"]),
    ("Device mesh layout", "rtow_tpu.parallel.mesh", ["make_mesh", "choose_split"]),
    ("Multi-host comms", "rtow_tpu.parallel.distributed", ["initialize", "is_primary"]),
    ("Differentiability (north-star)", "rtow_tpu.diff",
     ["render_pixels", "image_mse", "loss_and_grad", "build_train_step",
      "sgd_update", "mask_grads"]),
    ("Native C++ runtime", "rtow_tpu.native",
     ["load_obj", "ppm_string", "build_bvh_arrays", "available"]),
    ("Profiling/observability", "rtow_tpu.utils.profiling",
     ["RenderStats", "trace_profile", "bvh_quality"]),
    ("Backend dispatch", "rtow_tpu.pipeline",
     ["render_auto", "pick_nearest_hit"]),
]


def main() -> int:
    missing = []
    for name, mod, syms in ROWS:
        try:
            m = importlib.import_module(mod)
            missed = [s for s in syms if not hasattr(m, s)]
        except Exception as e:  # noqa: BLE001
            missed = [f"import failed: {e}"]
        status = "OK" if not missed else f"MISSING {missed}"
        if missed:
            missing.append(name)
        print(f"{name:48s} {status}")
    print()
    print("GAPS:", missing if missing else "none")
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
