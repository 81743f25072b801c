"""SoA scene representation — the replacement for both of the
reference's primitive dispatch models.

The reference dispatches ray-primitive hits either through virtual calls
(``OOStore<Primitive>``, reference src/oo-primitives.h:90-102) or through
``std::variant``/``std::visit`` (src/variant-primitives.h:84-113).  Both
are per-object control flow — poison for a vector machine.  Here the whole
scene is a pytree of dense typed arrays (struct-of-arrays): one array set
per primitive *kind*, one flat material parameter table (the reference's
"boutique", src/common-model.h:153-167).  "Dispatch" becomes masked
arithmetic over whole wavefronts, and ``jax.grad`` flows into the
geometry/material leaves natively (the differentiability north star).

Static spheres and MovingSpheres (src/oo-primitives.h:47-72) unify into
one array family: ``center(t) = center0 + t * dcenter`` with
``dcenter = 0`` for static spheres — exactly the reference's lerp over the
shutter interval [0, 1] (src/oo-primitives.h:63-66) and a no-op for
static ones, so there is no branch at trace time.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from ..utils.dtypes import REAL

# Material kinds (the reference's concrete Material subclasses,
# src/common-model.h:123-150).  EMISSIVE extends past the reference's
# book-1 scope (its only light is the sky): a diffuse area light whose
# ``albedo`` columns hold the EMITTED radiance (may exceed 1) — hits
# add ``throughput * emitted`` and terminate the path, the "rest of
# your life" diffuse_light semantics restated for a wavefront.
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
EMISSIVE = 3
#: Checker texture (book 2's first texture, also beyond the reference):
#: a Lambertian whose albedo alternates between ``albedo`` and
#: ``albedo2`` by the sign of prod(sin(scale * p)) at the hit point;
#: the scale rides the (otherwise dielectric-only) ``ir`` column.
CHECKER = 4
#: Marble/noise texture (book 2's Perlin chapter, gather-free): a
#: Lambertian whose albedo lerps albedo<->albedo2 by a sine stripe
#: displaced by hash-based value-noise turbulence (pure arithmetic, no
#: permutation tables).  Same columns as CHECKER.
NOISE = 5
#: Image texture (book 2 ch. 4.3): a Lambertian whose albedo is a
#: bilinear lookup of Scene.texture at the sphere's (u, v).  The texels
#: are a traced leaf: gradients flow INTO the image (inverse texture
#: painting).
IMAGE = 6


def _pytree_dataclass(cls, meta=()):
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls) if f.name not in meta]
    return jax.tree_util.register_dataclass(
        cls, data_fields=fields, meta_fields=list(meta)
    )


@_pytree_dataclass
class Materials:
    """Flat material table: ``kind`` selects which params are live.

    Replaces the reference's material "boutique" of heap-allocated
    subclasses (src/common-model.h:153-167) with one dense table.
    """

    kind: jax.Array  # (K,)  int32 in {LAMBERTIAN..CHECKER}
    albedo: jax.Array  # (K, 3) lambertian/metal albedo; checker even color
    fuzz: jax.Array  # (K,)  metal & dielectric fuzz (clamped [0,1] at build)
    ir: jax.Array  # (K,)  dielectric refraction index / checker scale
    albedo2: jax.Array  # (K, 3) checker odd color (= albedo elsewhere)


@_pytree_dataclass
class Spheres:
    center0: jax.Array  # (N, 3) center at shutter-open
    dcenter: jax.Array  # (N, 3) center1 - center0 (zero for static spheres)
    radius: jax.Array  # (N,)   may be negative (hollow-glass trick,
    #                            reference src/common-model.cpp:88)
    material: jax.Array  # (N,) int32 index into Materials


@_pytree_dataclass
class Triangles:
    verts: jax.Array  # (M, 3 corners, 3 coords)
    material: jax.Array  # (M,) int32 index into Materials


@_pytree_dataclass
class Volumes:
    """Constant-density participating media (book 2 ch. 9 smoke/fog),
    restated for a wavefront: each volume is an ANALYTIC boundary
    (sphere or axis-aligned box — entry/exit in closed form, no table
    sweep) with an exponential free-flight distance and an isotropic
    phase function.  The book wraps a boundary primitive and fakes the
    medium inside ``hit()``; here media are a separate static table so
    the surface sweep stays untouched and volume-free scenes compile
    identical code.  Kinds are carried statically (Scene.volume_kinds)
    like the light table's."""

    p0: jax.Array  # (V, 3) sphere center / box min corner (local)
    p1: jax.Array  # (V, 3) (radius, 0, 0) / box max corner (local)
    density: jax.Array  # (V,) sigma (1/length); scatter pdf sigma*e^-sigma*s
    albedo: jax.Array  # (V, 3) scatter albedo (0 -> pure absorption)
    rotate_y: jax.Array  # (V,) radians; rays are inverse-rotated (kind "r")
    translate: jax.Array  # (V, 3) world offset of the rotated local box


@functools.partial(
    _pytree_dataclass,
    meta=("background", "has_emissive", "light_ids", "has_checker",
          "volume_kinds", "has_image"),
)
class Scene:
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    #: Constant-density media; ``volume_kinds`` (static "s"/"b" tuple)
    #: gates the bounce-loop volume code exactly like light_ids does
    #: for NEE — scenes without media compile the unchanged bounce loop.
    volumes: Volumes = None
    #: "sky" (the reference's gradient) or an (r, g, b) tuple — static
    #: metadata, not a traced leaf: background choice changes compiled
    #: control flow in the bounce loop, never carries gradients.
    background: object = "sky"
    #: Static flag so lightless scenes compile the exact same bounce
    #: code as before EMISSIVE existed (no extra selects in the hot
    #: loop).
    has_emissive: bool = False
    #: Static tuple of ("s"|"t", prim_index) for each emissive
    #: primitive — drives next-event estimation's light table
    #: (ops/lights.py) via static indexing into the traced leaves.
    light_ids: tuple = ()
    #: Static flag: any textured material (CHECKER/NOISE) present —
    #: gates the second color column of the winner fetch + the texture
    #: selects.
    has_checker: bool = False
    #: Static tuple of "s" (sphere) / "b" (box) per volume row — the
    #: volume analogue of ``light_ids``.
    volume_kinds: tuple = ()
    #: (H, W, 3) texels for IMAGE materials (None when absent); a traced
    #: leaf — differentiable.  One image per scene (the book's earth
    #: globe); the static ``has_image`` flag gates the texel lookup.
    texture: object = None
    #: Static flag: any IMAGE material present.
    has_image: bool = False

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.material.shape[0]

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_triangles


def _instance_transform(verts: np.ndarray, rotate_y: float,
                        translate) -> np.ndarray:
    """Rotate (P, 3) points about the world y-axis by ``rotate_y``
    degrees, then translate — the book's instance transforms (RTW book 2
    ch. 8) baked into geometry instead of inverse-transforming rays."""
    if rotate_y != 0.0:
        th = np.radians(float(rotate_y))
        c, s = np.cos(th), np.sin(th)
        # Book convention: +angle takes +z toward +x.
        verts = verts @ np.array(
            [[c, 0.0, -s], [0.0, 1.0, 0.0], [s, 0.0, c]], np.float64
        )
    return verts + np.asarray(tuple(float(t) for t in translate),
                              np.float64)


class SceneBuilder:
    """Host-side append API mirroring ``Scene::primitives().add<T>(...)``
    (reference src/render.h:22-33), frozen into dense device arrays.

    Building happens in numpy float64 (the reference's precision) and is
    cast to the device dtype once, at freeze time.
    """

    def __init__(self) -> None:
        self._mat_kind: list[int] = []
        self._mat_albedo: list[tuple] = []
        self._mat_fuzz: list[float] = []
        self._mat_ir: list[float] = []
        self._mat_albedo2: list[tuple] = []
        self._sph: list[tuple] = []  # (c0, c1, radius, mat)
        self._tri: list[tuple] = []  # (a, b, c, mat)
        self._tri_blocks: list[tuple] = []  # ((M, 3, 3) array, mat)
        self._vol: list[tuple] = []  # (kind, p0, p1, density, albedo)
        self._texture = None  # (H, W, 3) float64 for IMAGE materials

    # -- materials (the "boutique") ---------------------------------------
    def add_lambertian(self, albedo) -> int:
        return self._add_mat(LAMBERTIAN, albedo, 0.0, 1.0)

    def add_metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add_mat(METAL, albedo, fuzz, 1.0)

    def add_dielectric(self, ir: float, fuzz: float = 0.0) -> int:
        return self._add_mat(DIELECTRIC, (0.0, 0.0, 0.0), fuzz, ir)

    def add_light(self, emit) -> int:
        """Diffuse area light: ``emit`` is the emitted radiance (r, g, b)
        — intensities above 1 are the usual way to light a scene.  Hits
        add ``throughput * emit`` and terminate (no scatter)."""
        return self._add_mat(EMISSIVE, emit, 0.0, 1.0)

    def add_checker(self, even, odd, scale: float = 10.0) -> int:
        """Checkerboard Lambertian (book 2's first texture): albedo is
        ``even`` or ``odd`` by the sign of prod(sin(scale * p)) at the
        hit point.  ``scale`` is cells per unit length (stored in the
        ``ir`` column, unused by diffuse materials)."""
        return self._add_mat(CHECKER, even, 0.0, float(scale), albedo2=odd)

    def add_image(self, image) -> int:
        """Image-textured Lambertian (book 2 ch. 4.3): ``image`` is an
        (H, W, 3) array in [0, 1]; sphere (u, v) maps equirectangularly
        (u from atan2, v from acos — the book's convention).  One image
        per scene."""
        img = np.asarray(image, np.float64)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
        if self._texture is not None:
            raise ValueError("one image texture per scene")
        self._texture = img
        return self._add_mat(IMAGE, (1.0, 1.0, 1.0), 0.0, 1.0)

    def add_noise(self, base, vein, scale: float = 4.0) -> int:
        """Marble Lambertian (book 2's Perlin texture, hash-based): the
        albedo lerps ``base`` <-> ``vein`` by a sine stripe displaced
        with value-noise turbulence at ``scale`` (models/materials.py
        marble_t)."""
        return self._add_mat(NOISE, base, 0.0, float(scale), albedo2=vein)

    def _add_mat(self, kind, albedo, fuzz, ir, albedo2=None) -> int:
        self._mat_kind.append(kind)
        self._mat_albedo.append(tuple(float(x) for x in albedo))
        # Reference clamps fuzz into [0, 1] at construction
        # (src/common-model.h:133, :145).
        self._mat_fuzz.append(min(max(float(fuzz), 0.0), 1.0))
        self._mat_ir.append(float(ir))
        self._mat_albedo2.append(
            tuple(float(x) for x in albedo2) if albedo2 is not None
            else self._mat_albedo[-1]
        )
        return len(self._mat_kind) - 1

    # -- primitives --------------------------------------------------------
    def add_sphere(self, center, radius: float, material: int) -> None:
        c = tuple(float(x) for x in center)
        self._sph.append((c, c, float(radius), material))

    def add_moving_sphere(self, center0, center1, radius: float, material: int) -> None:
        self._sph.append(
            (
                tuple(float(x) for x in center0),
                tuple(float(x) for x in center1),
                float(radius),
                material,
            )
        )

    def add_triangle(self, a, b, c, material: int) -> None:
        self._tri.append(
            (
                tuple(float(x) for x in a),
                tuple(float(x) for x in b),
                tuple(float(x) for x in c),
                material,
            )
        )

    def add_quad(self, p00, p10, p11, p01, material: int) -> None:
        """Quadrilateral = two triangles (book 2's quad primitive; no
        separate kind needed — the tables stay uniform).  Corners in CCW
        order as seen from the normal side: ``cross(p10-p00, p11-p00)``
        faces the viewer, and the renderer keeps the reference's backface
        cull (src/common-model.cpp:116)."""
        self.add_triangle(p00, p10, p11, material)
        self.add_triangle(p00, p11, p01, material)

    def add_box(self, p_min, p_max, material: int, *,
                rotate_y: float = 0.0, translate=(0.0, 0.0, 0.0)) -> None:
        """Axis-aligned box baked to 12 outward-wound triangles, with
        book 2's instance transforms (rotate_y degrees about the world
        y-axis, then translate) applied to the VERTICES at build time.

        The book wraps primitives in ``translate``/``rotate_y`` nodes
        that inverse-transform every ray (RTW book 2 ch. 8); per-ray
        indirection is control flow in the hot loop, while a static
        pre-transformed vertex table is free — instancing is a
        build-time bake here."""
        x0, y0, z0 = (float(v) for v in p_min)
        x1, y1, z1 = (float(v) for v in p_max)
        quads = [
            # +z, -z, +x, -x, +y, -y faces, CCW from outside.
            ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
            ((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)),
            ((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
            ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
            ((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)),
            ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
        ]
        verts = np.array(quads, dtype=np.float64).reshape(-1, 3)
        verts = _instance_transform(verts, rotate_y, translate)
        for q in verts.reshape(6, 4, 3):
            self.add_quad(q[0], q[1], q[2], q[3], material)

    def add_mesh(self, tri_verts: np.ndarray, material: int, *,
                 scale=1.0, rotate_y: float = 0.0,
                 translate=(0.0, 0.0, 0.0)) -> None:
        """Bulk-append (M, 3, 3) triangle vertices (OBJ ingestion path),
        optionally instanced by scale -> rotate_y -> translate (baked
        into the vertex table; see ``add_box``).

        Stored as one array block — a python loop over a 360k-triangle
        dragon-class mesh would take seconds."""
        block = np.ascontiguousarray(tri_verts, dtype=np.float64)
        if block.ndim != 3 or block.shape[1:] != (3, 3):
            raise ValueError(f"expected (M, 3, 3) vertices, got {block.shape}")
        if (np.any(np.asarray(scale) != 1.0) or rotate_y != 0.0
                or any(float(t) != 0.0 for t in translate)):
            flat = block.reshape(-1, 3) * np.asarray(scale, np.float64)
            block = _instance_transform(flat, rotate_y,
                                        translate).reshape(-1, 3, 3)
        self._tri_blocks.append((block, int(material)))

    # -- constant-density media (book 2 ch. 9) -----------------------------
    def add_fog_sphere(self, center, radius: float, density: float,
                       albedo=(1.0, 1.0, 1.0)) -> None:
        """Constant-density medium inside a sphere boundary: rays
        free-flight an Exp(density) distance through it and scatter
        isotropically with ``albedo`` (0 = pure absorption — black
        smoke).  The boundary itself is invisible (no surface)."""
        self._vol.append(
            ("s", tuple(float(x) for x in center),
             (float(radius), 0.0, 0.0), float(density),
             tuple(float(x) for x in albedo)))

    def add_fog_box(self, p_min, p_max, density: float,
                    albedo=(1.0, 1.0, 1.0), *, rotate_y: float = 0.0,
                    translate=(0.0, 0.0, 0.0)) -> None:
        """Constant-density medium inside a box (the book's
        Cornell-smoke boxes).  ``rotate_y`` (degrees) + ``translate``
        are the book's instance transforms: unlike solid boxes (whose
        vertices bake), a medium boundary must stay analytic, so rays
        are inverse-rotated into the box frame at trace time — a few
        scalar mults per volume, <= 8 volumes."""
        p_min = tuple(float(x) for x in p_min)
        p_max = tuple(float(x) for x in p_max)
        translate = tuple(float(x) for x in translate)
        if rotate_y == 0.0:
            # Pure translation bakes into the corners; compiled code is
            # the plain slab test.
            p_min = tuple(a + b for a, b in zip(p_min, translate))
            p_max = tuple(a + b for a, b in zip(p_max, translate))
            self._vol.append(("b", p_min, p_max, float(density),
                              tuple(float(x) for x in albedo)))
        else:
            self._vol.append(
                ("r", p_min, p_max, float(density),
                 tuple(float(x) for x in albedo),
                 float(np.radians(rotate_y)), translate))

    # -- freeze --------------------------------------------------------------
    def build(self, dtype=REAL, background="sky") -> Scene:
        """``background``: "sky" (reference gradient) or an (r, g, b)
        tuple — light-driven scenes typically pass (0, 0, 0)."""
        if not self._mat_kind:
            raise ValueError("scene has no materials")
        if not self._sph and not self._tri and not self._tri_blocks:
            raise ValueError("scene has no primitives")
        if background != "sky":
            background = tuple(float(x) for x in background)
            if len(background) != 3:
                raise ValueError("background must be 'sky' or (r, g, b)")

        np_real = np.float64  # assemble at full precision, cast once
        if self._sph:
            c0 = np.array([s[0] for s in self._sph], dtype=np_real)
            c1 = np.array([s[1] for s in self._sph], dtype=np_real)
            rad = np.array([s[2] for s in self._sph], dtype=np_real)
            smat = np.array([s[3] for s in self._sph], dtype=np.int32)
        else:
            c0 = np.zeros((0, 3), np_real)
            c1 = np.zeros((0, 3), np_real)
            rad = np.zeros((0,), np_real)
            smat = np.zeros((0,), np.int32)
        tvs = []
        tmats = []
        if self._tri:
            tvs.append(np.array([t[:3] for t in self._tri], dtype=np_real))
            tmats.append(np.array([t[3] for t in self._tri], dtype=np.int32))
        for block, mat in self._tri_blocks:
            tvs.append(block)
            tmats.append(np.full((block.shape[0],), mat, np.int32))
        if tvs:
            tv = np.concatenate(tvs)
            tmat = np.concatenate(tmats)
        else:
            tv = np.zeros((0, 3, 3), np_real)
            tmat = np.zeros((0,), np.int32)

        if any(self._mat_kind[m] in (CHECKER, NOISE, IMAGE) for m in tmat):
            raise ValueError(
                "textured materials are sphere-only"
            )
        n_lights = sum(
            1 for s in self._sph if self._mat_kind[s[3]] == EMISSIVE
        ) + sum(1 for m in tmat if self._mat_kind[m] == EMISSIVE)
        if n_lights > 16:
            raise ValueError(
                f"at most 16 emissive primitives supported (got {n_lights})"
                " — NEE unrolls the light loop at trace time"
            )

        import jax.numpy as jnp

        as_real = lambda x: jnp.asarray(x, dtype=dtype)
        if self._vol:
            if len(self._vol) > 8:
                raise ValueError(
                    f"at most 8 volumes supported (got {len(self._vol)})"
                    " — the bounce loops unroll the volume table")
            volumes = Volumes(
                p0=as_real(np.array([v[1] for v in self._vol], np_real)),
                p1=as_real(np.array([v[2] for v in self._vol], np_real)),
                density=as_real(np.array([v[3] for v in self._vol],
                                         np_real)),
                albedo=as_real(np.array([v[4] for v in self._vol],
                                        np_real)),
                rotate_y=as_real(np.array(
                    [v[5] if len(v) > 5 else 0.0 for v in self._vol],
                    np_real)),
                translate=as_real(np.array(
                    [v[6] if len(v) > 6 else (0.0, 0.0, 0.0)
                     for v in self._vol], np_real)),
            )
        else:
            volumes = None
        return Scene(
            volumes=volumes,
            volume_kinds=tuple(v[0] for v in self._vol),
            spheres=Spheres(
                center0=as_real(c0),
                dcenter=as_real(c1 - c0),
                radius=as_real(rad),
                material=jnp.asarray(smat),
            ),
            triangles=Triangles(verts=as_real(tv), material=jnp.asarray(tmat)),
            materials=Materials(
                kind=jnp.asarray(np.array(self._mat_kind, np.int32)),
                albedo=as_real(np.array(self._mat_albedo, np_real)),
                fuzz=as_real(np.array(self._mat_fuzz, np_real)),
                ir=as_real(np.array(self._mat_ir, np_real)),
                albedo2=as_real(np.array(self._mat_albedo2, np_real)),
            ),
            background=background,
            has_emissive=any(k == EMISSIVE for k in self._mat_kind),
            light_ids=tuple(
                [("s", i) for i, s in enumerate(self._sph)
                 if self._mat_kind[s[3]] == EMISSIVE]
                + [("t", i) for i, m in enumerate(tmat)
                   if self._mat_kind[m] == EMISSIVE]
            ),
            has_checker=any(k in (CHECKER, NOISE)
                            for k in self._mat_kind),
            texture=(as_real(self._texture)
                     if self._texture is not None else None),
            has_image=any(k == IMAGE for k in self._mat_kind),
        )
