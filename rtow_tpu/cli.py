"""Command-line interface mirroring the reference CLI11 app
(reference src/main.cpp:138-170): same flags, same semantics, PPM P3 on
stdout, logging on stderr.  ``--threads`` becomes ``--devices`` (the
reference's std::async fan-out maps to device sharding); the dead
``-q/--quick`` flag is dropped (SURVEY.md quirks ledger).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rtweekend-tpu",
        description="Raytracing one weekend/week/restoflife — JAX path tracer",
    )
    d = Config()
    p.add_argument("-t", "--devices", type=int, default=d.n_devices,
                   help="Number of devices to shard over (ref: --threads)")
    p.add_argument("-w", "--image-width", type=int, default=d.image_width)
    p.add_argument("-s", "--samples-per-pixel", type=int, default=d.samples_per_pixel)
    p.add_argument("-c", "--max-child-rays", type=int, default=d.max_child_rays)
    p.add_argument("-a", "--aspect-ratio", type=float, default=d.aspect_ratio)
    p.add_argument("-n", "--balls_sqrt", type=int, default=d.number_of_balls_sqrt)
    p.add_argument("-m", "--moving-spheres", action="store_true",
                   default=d.moving_spheres)
    p.add_argument("--static-spheres", dest="moving_spheres", action="store_false")
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("-l", "--load", type=str, default=None, help="OBJ model to load")
    p.add_argument("--lights", action="store_true",
                   help="Emissive-material demo scene (area lights, "
                        "black background; no reference counterpart)")
    p.add_argument("--cornell", action="store_true",
                   help="Cornell box demo (emissive triangle ceiling "
                        "light; no reference counterpart)")
    p.add_argument("--checker", action="store_true", dest="checker_ground",
                   help="Checkered ground on the cover scene (book 2's "
                        "first texture; no reference counterpart)")
    p.add_argument("--textures", action="store_true", dest="textures_demo",
                   help="Procedural-texture demo scene: checker ground + "
                        "marble sphere (book 2; no reference counterpart)")
    p.add_argument("--smoke", action="store_true", dest="smoke_demo",
                   help="Cornell-smoke demo: constant-density media "
                        "(book 2 ch. 9; no reference counterpart)")
    p.add_argument("--globe", action="store_true", dest="globe_demo",
                   help="Earth-globe image-texture demo (book 2 ch. 4.3; "
                        "procedural texture, jnp path)")
    p.add_argument("--russian-roulette", action="store_true",
                   dest="russian_roulette",
                   help="Probabilistic path termination after 3 scatters "
                        "(unbiased; off by default for reference fidelity)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--no-bvh", dest="use_bvh", action="store_false", default=d.use_bvh)
    p.add_argument("-o", "--output", type=str, default="-",
                   help="Output PPM path ('-' = stdout, like the reference)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="Print diagnostics (BVH quality, device info)")
    p.add_argument("--profile-dir", type=str, default="",
                   help="Write a jax.profiler trace here (TensorBoard)")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    return Config(
        number_of_balls_sqrt=args.balls_sqrt,
        aspect_ratio=args.aspect_ratio,
        image_width=args.image_width,
        samples_per_pixel=args.samples_per_pixel,
        moving_spheres=args.moving_spheres,
        max_child_rays=args.max_child_rays,
        model=args.load,
        lights_demo=args.lights,
        cornell_demo=args.cornell,
        checker_ground=args.checker_ground,
        textures_demo=args.textures_demo,
        smoke_demo=args.smoke_demo,
        globe_demo=args.globe_demo,
        n_devices=args.devices,
        seed=args.seed,
        use_bvh=args.use_bvh,
        russian_roulette=args.russian_roulette,
        verbose=args.verbose,
        profile_dir=args.profile_dir,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    if args.dry_run:
        sys.stdout.write(str(cfg))
        return 0

    # Import lazily so --dry-run/--help never pay JAX startup.
    from .models.builders import scene_for_config
    from .pipeline import render_auto
    from .utils.ppm import write_ppm

    scene, camera = scene_for_config(cfg)
    if cfg.model:
        print(f"Scene has {scene.n_triangles} triangles", file=sys.stderr)
    image = render_auto(scene, camera, cfg, progress=True)

    if args.output == "-":
        write_ppm(sys.stdout, image)
    elif args.output.lower().endswith(".png"):
        # PNG out — the reference declared stb for this but never used it
        # (conanfile.txt:3, SURVEY.md quirks ledger).
        from .utils.ppm import tonemap

        try:
            from PIL import Image
        except ImportError as e:  # pragma: no cover
            raise SystemExit("PNG output needs Pillow; use .ppm") from e
        Image.fromarray(tonemap(image).astype("uint8")).save(args.output)
    else:
        with open(args.output, "w") as f:
            write_ppm(f, image)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
