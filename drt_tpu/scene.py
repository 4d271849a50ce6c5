"""Scene-of-arrays (SoA) representation and builder.

The reference models a scene as `std::vector<Shape<T>*>` of virtual-dispatch
objects holding `shared_ptr` BxDFs/Emitters (reference: include/drt/
pathtracer.hpp:12-13, shape.hpp:11-35, bxdf.hpp:12-25, emitter.hpp:7-13).
Here virtual dispatch becomes data: flat arrays of shape/material codes
that the wavefront tracer gathers from and selects over with masks. The
scene is tiny and replicated per device; only `Params` is differentiable.

Sentinel conventions (so gathers never need branches):
  - a shape with no BxDF points at material row M (type NULL -> f = 0,
    sample dir = 0, pdf = 1), mirroring the reference's null-BxDF fallbacks
    (reference: pathtracer.hpp:17-35);
  - a shape with no emitter points at emission row L of the zero-padded
    emission table (reference: pathtracer.hpp:41-49);
  - materials without a color parameter (mirror) point at albedo row K of
    the ones-padded albedo table.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# Shape type codes
PLANE = 0
SPHERE = 1
TRIANGLE = 2

# Material type codes
DIFFUSE = 0
SPECULAR = 1
MIRROR = 2
NULL_BXDF = 3

GEO_WIDTH = 12  # plane: n(3)+offset; sphere: c(3)+r; triangle: v0,v1,v2


class Params(NamedTuple):
    """Differentiable shading parameters (the leaves the adjoint pass
    scatter-adds gradients into; reference analogue: the `VariableNode`
    leaves red/green/white/emission at src/render.cpp:26-29)."""

    albedo: jnp.ndarray  # f[K, 3]
    emission: jnp.ndarray  # f[L, 3]


class Scene(NamedTuple):
    """Static (non-differentiable) scene arrays, replicated per chip."""

    shape_type: jnp.ndarray  # i32[S]
    shape_geo: jnp.ndarray  # f[S, GEO_WIDTH]
    shape_mat: jnp.ndarray  # i32[S] in [0, M]; M = null sentinel
    shape_emit: jnp.ndarray  # i32[S] in [0, L]; L = zero sentinel
    mat_type: jnp.ndarray  # i32[M+1] (sentinel NULL row appended)
    mat_albedo: jnp.ndarray  # i32[M+1] index into padded albedo table
    mat_exponent: jnp.ndarray  # f[M+1]

    @property
    def num_shapes(self) -> int:
        return self.shape_type.shape[0]


def albedo_table(scene: Scene, params: Params) -> jnp.ndarray:
    """Padded albedo table: K param rows + a ones row (mirror / colorless)."""
    ones = jnp.ones((1, 3), dtype=params.albedo.dtype)
    return jnp.concatenate([params.albedo, ones], axis=0)


def emission_table(scene: Scene, params: Params) -> jnp.ndarray:
    """Padded emission table: L param rows + a zeros row (no emitter)."""
    zeros = jnp.zeros((1, 3), dtype=params.emission.dtype)
    return jnp.concatenate([params.emission, zeros], axis=0)


class SceneBuilder:
    """Imperative builder mirroring the reference's scene-construction
    ergonomics (src/render.cpp:26-59) while producing SoA arrays."""

    def __init__(self) -> None:
        self._albedo: list[list[float]] = []
        self._emission: list[list[float]] = []
        self._mat_type: list[int] = []
        self._mat_albedo: list[int] = []
        self._mat_exponent: list[float] = []
        self._shape_type: list[int] = []
        self._shape_geo: list[np.ndarray] = []
        self._shape_mat: list[int] = []
        self._shape_emit: list[int] = []

    # -- differentiable parameters ------------------------------------
    def albedo_param(self, rgb) -> int:
        self._albedo.append([float(v) for v in rgb])
        return len(self._albedo) - 1

    def emission_param(self, rgb) -> int:
        self._emission.append([float(v) for v in rgb])
        return len(self._emission) - 1

    # -- materials -----------------------------------------------------
    def diffuse(self, albedo_id: int) -> int:
        """Lambertian BRDF `albedo/pi` (reference: bxdf.hpp:56-83)."""
        return self._add_material(DIFFUSE, albedo_id, 0.0)

    def specular(self, albedo_id: int, exponent: float) -> int:
        """Blinn-Phong-like glossy BRDF (reference: bxdf.hpp:85-124)."""
        return self._add_material(SPECULAR, albedo_id, float(exponent))

    def mirror(self) -> int:
        """Delta reflection (reference: bxdf.hpp:126-144). Colorless: the
        albedo gather resolves to the padded ones row."""
        return self._add_material(MIRROR, -1, 0.0)

    def _add_material(self, mtype: int, albedo_id: int, exponent: float) -> int:
        self._mat_type.append(mtype)
        self._mat_albedo.append(albedo_id)
        self._mat_exponent.append(exponent)
        return len(self._mat_type) - 1

    # -- shapes ----------------------------------------------------------
    def plane(self, normal, offset: float, bxdf: int | None = None,
              emitter: int | None = None) -> int:
        """Half-space `dot(p, n) = offset` (reference: shape.hpp:37-64).
        The normal is stored *as given* — the reference never normalizes it
        and the sample scene contains an unnormalized one
        (src/render.cpp:42 `right_plane` n=(1,0,0.1))."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(normal, dtype=np.float64)
        geo[3] = float(offset)
        return self._add_shape(PLANE, geo, bxdf, emitter)

    def sphere(self, center, radius: float, bxdf: int | None = None,
               emitter: int | None = None) -> int:
        """Sphere (reference: shape.hpp:66-111)."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(center, dtype=np.float64)
        geo[3] = float(radius)
        return self._add_shape(SPHERE, geo, bxdf, emitter)

    def triangle(self, v0, v1, v2, bxdf: int | None = None,
                 emitter: int | None = None) -> int:
        """Triangle (Moller-Trumbore). No reference analogue — an extension
        required by the framework's north star (BASELINE.json)."""
        geo = np.zeros(GEO_WIDTH)
        geo[0:3] = np.asarray(v0, dtype=np.float64)
        geo[3:6] = np.asarray(v1, dtype=np.float64)
        geo[6:9] = np.asarray(v2, dtype=np.float64)
        return self._add_shape(TRIANGLE, geo, bxdf, emitter)

    def _add_shape(self, stype: int, geo: np.ndarray, bxdf: int | None,
                   emitter: int | None) -> int:
        self._shape_type.append(stype)
        self._shape_geo.append(geo)
        self._shape_mat.append(-1 if bxdf is None else bxdf)
        self._shape_emit.append(-1 if emitter is None else emitter)
        return len(self._shape_type) - 1

    # -- finalize --------------------------------------------------------
    def build(self, dtype=jnp.float32) -> tuple[Scene, Params]:
        n_mat = len(self._mat_type)
        n_alb = len(self._albedo)
        n_emit = len(self._emission)
        # Sentinel null material row (type NULL, albedo -> ones row).
        mat_type = np.asarray(self._mat_type + [NULL_BXDF], dtype=np.int32)
        mat_albedo = np.asarray(
            [a if a >= 0 else n_alb for a in self._mat_albedo] + [n_alb],
            dtype=np.int32,
        )
        mat_exponent = np.asarray(self._mat_exponent + [0.0])
        shape_mat = np.asarray(
            [m if m >= 0 else n_mat for m in self._shape_mat], dtype=np.int32
        )
        shape_emit = np.asarray(
            [e if e >= 0 else n_emit for e in self._shape_emit], dtype=np.int32
        )
        scene = Scene(
            shape_type=jnp.asarray(self._shape_type, dtype=jnp.int32),
            shape_geo=jnp.asarray(np.stack(self._shape_geo), dtype=dtype),
            shape_mat=jnp.asarray(shape_mat),
            shape_emit=jnp.asarray(shape_emit),
            mat_type=jnp.asarray(mat_type),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_exponent=jnp.asarray(mat_exponent, dtype=dtype),
        )
        params = Params(
            albedo=jnp.asarray(
                np.asarray(self._albedo).reshape(n_alb, 3), dtype=dtype
            ),
            emission=jnp.asarray(
                np.asarray(self._emission).reshape(n_emit, 3), dtype=dtype
            ),
        )
        return scene, params


def make_scene(shapes_spec, dtype=jnp.float32) -> tuple[Scene, Params]:
    """Convenience wrapper: build a scene from a declarative list of dicts.

    Each entry: {"kind": "plane"|"sphere"|"triangle", geometry kwargs,
    optional "diffuse"/"specular"/"mirror" material spec, optional
    "emission" rgb}.
    """
    b = SceneBuilder()
    for spec in shapes_spec:
        mat = None
        if "diffuse" in spec:
            mat = b.diffuse(b.albedo_param(spec["diffuse"]))
        elif "specular" in spec:
            rgb, exp = spec["specular"]
            mat = b.specular(b.albedo_param(rgb), exp)
        elif spec.get("mirror"):
            mat = b.mirror()
        emit = None
        if "emission" in spec:
            emit = b.emission_param(spec["emission"])
        kind = spec["kind"]
        if kind == "plane":
            b.plane(spec["normal"], spec["offset"], mat, emit)
        elif kind == "sphere":
            b.sphere(spec["center"], spec["radius"], mat, emit)
        elif kind == "triangle":
            b.triangle(spec["v0"], spec["v1"], spec["v2"], mat, emit)
        else:
            raise ValueError(f"unknown shape kind: {kind}")
    return b.build(dtype)
