"""Device-mesh sharding for the renderer.

The reference is one OS thread walking pixels in a nested loop
(reference: src/render.cpp:72-86) with no parallelism of any kind
(SURVEY.md §2 "Parallelism & communication inventory"). The scaling
axes map as:

  pixel tiles  -> mesh axis "tiles"  (data parallelism over rays)
  samples/px   -> mesh axis "spp"    (sample parallelism)
  scene+params -> replicated per device (they are tiny)
  grad reduce  -> psum inserted by the SPMD partitioner where the
                  adjoint's segment_sums cross the mesh
                  (the analogue of the reference's single-heap
                  `m_grad += grad`, vector.hpp:185-191)

The flat ray batch dimension N = H*W*spp_chunk is sharded over BOTH axes
(`P(("tiles", "spp"))`); XLA partitions every per-ray op in the wavefront
and all-reduces the parameter-gradient partial sums across devices.
"""

from __future__ import annotations

import numpy as np

import jax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: tuple[int, int] | None = None,
              axis_names: tuple[str, str] = ("tiles", "spp"),
              devices=None) -> Mesh:
    """Build a 2D (tiles, spp) mesh over the available devices.

    Default factorization: spp axis of 2 when the device count is even
    (>= 4 devices), else 1.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        spp_ax = 2 if (n >= 4 and n % 2 == 0) else 1
        shape = (n // spp_ax, spp_ax)
    assert shape[0] * shape[1] == n, (shape, n)
    dev_grid = np.asarray(devices).reshape(shape)
    return Mesh(dev_grid, axis_names)


def ray_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the leading (ray) axis over the whole mesh."""
    return P(mesh.axis_names)


def ray_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ray_spec(mesh))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def constrain_rays(x, mesh: Mesh):
    """Constrain a per-ray array to be sharded over the mesh. The ray axis
    is the LAST axis (component-first layout, e.g. f[3, N]) or the only
    axis of a rank-1 array (e.g. pdf f[N])."""
    spec = P(*([None] * (x.ndim - 1)), mesh.axis_names)
    return lax.with_sharding_constraint(x, NamedSharding(mesh, spec))


def pad_to_multiple(n: int, mesh: Mesh) -> int:
    """Ray counts must divide evenly over the mesh; pad up."""
    m = int(np.prod(mesh.devices.shape))
    return ((n + m - 1) // m) * m
