"""Pinhole camera (reference: include/drt/camera.hpp).

Pure-function ray generation vectorized over pixel ids; the reference's
per-pixel `Camera::sample` (camera.hpp:51-60) becomes one batched op.

Faithfully reproduced quirks:
  - the image t-axis uses `-up`, so y=0 is the TOP row (camera.hpp:57);
  - `look_at` builds right = normalize(cross(forward, up)) (camera.hpp:29-37),
    which for the sample app's look_at((0,0,0) -> (0,0,1)) yields
    right = (-1, 0, 0): the rendered image is x-mirrored (src/render.cpp:65);
  - the pdf returned per ray is identically 1 (camera.hpp:59).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from drt_tpu.ops.vecmath import cross, normalize


class Camera(NamedTuple):
    eye: jnp.ndarray  # f[3]
    forward: jnp.ndarray  # f[3]
    right: jnp.ndarray  # f[3]
    up: jnp.ndarray  # f[3]
    vfov: jnp.ndarray  # f[] radians; reference default 1.3963 (~80deg), camera.hpp:15


def default_camera(dtype=jnp.float32, vfov: float = 1.3963) -> Camera:
    """Reference defaults (camera.hpp:15-19): eye origin, forward -z."""
    return Camera(
        eye=jnp.zeros(3, dtype),
        forward=jnp.asarray([0.0, 0.0, -1.0], dtype),
        right=jnp.asarray([1.0, 0.0, 0.0], dtype),
        up=jnp.asarray([0.0, 1.0, 0.0], dtype),
        vfov=jnp.asarray(vfov, dtype),
    )


def look_at(eye, at, up=(0.0, 1.0, 0.0), vfov: float = 1.3963,
            dtype=jnp.float32) -> Camera:
    """Build a camera basis (reference: camera.hpp:29-37)."""
    eye = jnp.asarray(eye, dtype)
    at = jnp.asarray(at, dtype)
    up = jnp.asarray(up, dtype)
    forward = normalize(at - eye)
    right = normalize(cross(forward, up))
    cam_up = cross(right, forward)
    return Camera(eye=eye, forward=forward, right=right, up=cam_up,
                  vfov=jnp.asarray(vfov, dtype))


def camera_rays(cam: Camera, width: int, height: int,
                xy: jnp.ndarray, u: jnp.ndarray):
    """Generate jittered primary rays (reference: camera.hpp:51-60).

    Args:
      cam: camera basis.
      width/height: image resolution (static).
      xy: i32[N, 2] pixel coordinates (x, y).
      u: f[N, 2] uniform jitter samples (s-draw first, then t-draw —
         the reference consumes them in that order, camera.hpp:53-54).

    Returns:
      (orig V3 of f[N], dir V3 of f[N], pdf f[N]) — pdf is identically 1.
      Scalarized SoA: each component is a rank-1 [N] array (see
      drt_tpu/ops/vecmath.py).
    """
    from drt_tpu.ops.vecmath import V3, normalizev
    dtype = cam.forward.dtype
    n = xy.shape[0]
    x = xy[:, 0].astype(dtype)
    y = xy[:, 1].astype(dtype)
    s = (x + u[:, 0]) / width
    t = (y + u[:, 1]) / height
    aspect = float(width) / float(height)
    half = jnp.tan(cam.vfov / 2.0)
    a = (2.0 * s - 1.0) * aspect * half  # [N] right coefficient
    b = (2.0 * t - 1.0) * half  # [N] (-up) coefficient
    fwd, right, up = (V3.from_array(cam.forward), V3.from_array(cam.right),
                      V3.from_array(cam.up))
    d = normalizev(fwd + right * a + (-up) * b)
    orig = V3(*(jnp.broadcast_to(c, (n,)) for c in
                (cam.eye[0], cam.eye[1], cam.eye[2])))
    return orig, d, jnp.ones(n, dtype)


def pixel_grid(width: int, height: int) -> jnp.ndarray:
    """i32[H*W, 2] pixel coordinates in the reference's raster order
    (row-major: y outer, x inner — src/render.cpp:72-73)."""
    ys, xs = jnp.mgrid[0:height, 0:width]
    return jnp.stack([xs.ravel(), ys.ravel()], axis=-1).astype(jnp.int32)
