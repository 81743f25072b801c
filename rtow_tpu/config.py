"""Render configuration — the analogue of the reference's ``rt::Config``.

Mirrors every knob of the reference Config (reference src/render.h:11-20)
plus this build's own (device count replaces ``nthreads``, a seed
replaces the implicit mt19937 default seed, ray-batch sizing controls
device memory).  Printable like the reference's ``operator<<``
(src/render.cpp:193-203), used by ``--dry-run``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    # -- knobs shared with the reference (same defaults) ------------------
    number_of_balls_sqrt: int = 11
    aspect_ratio: float = 3.0 / 2.0
    image_width: int = 200
    samples_per_pixel: int = 20
    moving_spheres: bool = True
    max_child_rays: int = 20
    model: Optional[str] = None  # OBJ path; selects the mesh scene
    #: emissive-material demo scene (area lights, black background) — a
    #: capability the reference lacks (its only light is the sky).
    lights_demo: bool = False
    #: Cornell box demo (emissive triangle ceiling light, colored walls).
    cornell_demo: bool = False
    #: checkered ground sphere on the cover scene (book 2's first texture).
    checker_ground: bool = False
    #: procedural-texture demo scene (checker ground + marble sphere).
    textures_demo: bool = False
    #: Cornell-smoke demo scene (book 2 ch. 9 constant-density media).
    smoke_demo: bool = False
    #: earth-globe image-texture demo scene (book 2 ch. 4.3; jnp path).
    globe_demo: bool = False

    # -- knobs of this build ----------------------------------------------
    #: devices used for rendering; the analogue of the reference's
    #: ``nthreads`` std::async fan-out (src/render.cpp:172-175).
    n_devices: int = 1
    #: mesh split: devices = tile_shards * spp_shards (set by the runner).
    spp_shards: int = 1
    #: base PRNG seed (the reference's mt19937 is default-seeded; we make
    #: the seed explicit and reproducible).
    seed: int = 0
    #: rays traced per device step; bounds peak device memory for the
    #: wavefront.
    rays_per_batch: int = 1 << 18
    #: use the flattened stackless BVH (vs brute-force intersection).
    use_bvh: bool = True
    #: Russian-roulette path termination (BASELINE north star): kill
    #: low-throughput lanes after 3 scatters with unbiased 1/p boosts.
    #: OFF by default — the reference terminates by depth budget only
    #: (src/render.cpp:114-115), so default output stays reference-
    #: faithful; enable for deep-depth throughput.
    russian_roulette: bool = False
    #: print diagnostics (BVH quality metric, timings) to stderr — the
    #: reference prints its stupid_volume every run (render.cpp:148).
    verbose: bool = False
    #: jax.profiler trace output directory (TensorBoard-loadable); empty
    #: disables profiling.
    profile_dir: str = ""

    @property
    def image_height(self) -> int:
        # Same truncation as the reference (src/render.cpp:136).
        return int(self.image_width / self.aspect_ratio)

    def __str__(self) -> str:  # --dry-run output, reference render.cpp:193
        return (
            "Config {\n"
            f"aspect_ratio: {self.aspect_ratio}\n"
            f"number_of_balls_sqrt: {self.number_of_balls_sqrt}\n"
            f"moving_spheres: {int(self.moving_spheres)}\n"
            f"image_width: {self.image_width}\n"
            f"samples_per_pixel: {self.samples_per_pixel}\n"
            f"max_child_rays: {self.max_child_rays}\n"
            f"n_devices: {self.n_devices}\n"
            f"seed: {self.seed}\n"
            "}\n"
        )
