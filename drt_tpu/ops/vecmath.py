"""Vector math over `[..., 3]` arrays.

Pure-function equivalents of the reference's fixed-size vector helpers
(reference: include/drt/vector.hpp:573-606). All functions broadcast over
leading batch dimensions; the trailing axis is the 3-component axis (SoA
batches of rays live as `f32[N, 3]`).
"""

from __future__ import annotations

import jax.numpy as jnp


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product -> `[...]` (reference: vector.hpp:573-578)."""
    return jnp.sum(a * b, axis=-1)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm -> `[...]` (reference: vector.hpp:580-584)."""
    return jnp.sqrt(dot(a, a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Unit vector (reference: vector.hpp:586-590). No epsilon: the
    reference divides by the exact norm; a zero vector yields inf/nan,
    matching C++ IEEE semantics."""
    return a / norm(a)[..., None]


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over the trailing axis (reference: vector.hpp:592-600)."""
    return jnp.cross(a, b)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflection `-v + 2*dot(n, v)*n` (reference: vector.hpp:602-606).

    Note the reference convention: `v` points *away* from the surface and
    the result points away on the other side.
    """
    return -v + 2.0 * dot(n, v)[..., None] * n


# ---------------------------------------------------------------------------
# Scalarized SoA vec3: a pytree of three f[N] arrays — the wavefront's hot
# representation. Rank-1 [N] component arrays keep the huge ray axis
# minor everywhere (scan carries, stacked residuals, gathers), so no
# layout pads a size-3 axis.
# ---------------------------------------------------------------------------

from typing import NamedTuple


class V3(NamedTuple):
    """SoA 3-vector: three same-shaped arrays (usually f[N])."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (componentwise; scalars broadcast) --------------------
    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    # -- conversion -------------------------------------------------------
    @staticmethod
    def from_array(a: jnp.ndarray) -> "V3":
        """f[..., 3] -> V3 of f[...]."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jnp.ndarray:
        """V3 of f[...] -> f[..., 3]."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @staticmethod
    def fill(value, shape, dtype) -> "V3":
        return V3(*(jnp.full(shape, v, dtype) for v in value))

    @staticmethod
    def zeros(shape, dtype) -> "V3":
        z = jnp.zeros(shape, dtype)
        return V3(z, z, z)


def dotv(a: V3, b: V3) -> jnp.ndarray:
    """reference: vector.hpp:573-578."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def normv(a: V3) -> jnp.ndarray:
    return jnp.sqrt(dotv(a, a))


def normalizev(a: V3) -> V3:
    return a * (1.0 / normv(a))


def crossv(a: V3, b: V3) -> V3:
    """reference: vector.hpp:592-600."""
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def reflectv(v: V3, n: V3) -> V3:
    """reference: vector.hpp:602-606."""
    return -v + 2.0 * dotv(n, v) * n


def wherev(mask: jnp.ndarray, a: V3, b) -> V3:
    if isinstance(b, V3):
        return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
                  jnp.where(mask, a.z, b.z))
    return V3(jnp.where(mask, a.x, b), jnp.where(mask, a.y, b),
              jnp.where(mask, a.z, b))


def gatherv(table: jnp.ndarray, idx: jnp.ndarray) -> V3:
    """Gather rows of a small f[R, 3] table into a V3 of f[N] — three
    per-channel [N] gathers, no [N, 3] intermediate."""
    return V3(table[:, 0][idx], table[:, 1][idx], table[:, 2][idx])
