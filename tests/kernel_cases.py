"""Shared scenes and the XLA oracle for the path-kernel tests.

The oracle is the plain XLA wavefront (`trace_rays`) fed the kernel's own
hash draws (`pathkernel.hash_tapes`), so the kernel and the oracle trace
the same paths; `adjoint._param_grads` closes the oracle's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np

from drt_tpu.camera import camera_rays, look_at, pixel_grid
from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox, gallery
from drt_tpu.ops.pathkernel import hash_tapes
from drt_tpu.renderer import trace_rays
from drt_tpu.scene import SceneBuilder

SEEDS = jnp.asarray([12345, 67890], jnp.int32)


def build_mixed(dtype=jnp.float32):
    """Specular plane, mirror sphere, diffuse triangle, emissive sphere:
    the kernel branches the Cornell box never takes."""
    b = SceneBuilder()
    white = b.albedo_param([0.6, 0.6, 0.6])
    glossy = b.albedo_param([0.4, 0.5, 0.6])
    emission = b.emission_param([2.0, 1.5, 1.0])
    b.plane([0.0, 1.0, 0.0], -1.0, b.specular(glossy, 10.0))
    b.sphere([0.0, 0.0, 3.0], 1.0, b.mirror())
    b.triangle([-2.0, -0.5, 2.0], [2.0, -0.5, 2.0], [0.0, 2.0, 2.5],
               b.diffuse(white))
    b.sphere([0.0, 3.0, 3.0], 1.0, None, emission)
    scene, params = b.build(dtype)
    return scene, params, look_at([0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                  dtype=dtype)


BUILDERS = {"cbox": cbox.build, "glossy": gallery.build_glossy,
            "tri": gallery.build_tri, "mixed": build_mixed}


def scene(name):
    return BUILDERS[name](dtype=jnp.float32)


def cfg(width, height, spp=2, depth=4, **kw):
    return RenderConfig(width=width, height=height, spp=spp,
                        max_depth=depth, **kw)


def oracle(scene_, params, cam, cfg_, seeds=SEEDS):
    """(image f[H,W,3], per-ray radiance V3, BounceResiduals) of the XLA
    wavefront on the kernel's draws (rays spp-outer)."""
    npix = cfg_.width * cfg_.height
    cam_u, tape = hash_tapes(seeds, npix, cfg_.spp, cfg_.max_depth,
                             jnp.float32)
    xy = jnp.tile(pixel_grid(cfg_.width, cfg_.height), (cfg_.spp, 1))
    o, d, _ = camera_rays(cam, cfg_.width, cfg_.height, xy, cam_u.T)
    L, res = trace_rays(params, scene_, o, d, None, cfg_, tape=tape,
                        collect=True)
    img = np.stack([np.asarray(c).reshape(cfg_.spp, npix).mean(0)
                    for c in L], -1).reshape(cfg_.height, cfg_.width, 3)
    return img, L, res


def ray_cotangent(g, spp):
    """Per-pixel image cotangent f[H,W,3] -> per-ray V3 (spp-outer)."""
    from drt_tpu.ops.vecmath import V3
    return V3(*(jnp.tile(g[:, :, c].reshape(-1), spp) / spp
                for c in range(3)))


def random_cotangent(cfg_, seed=7):
    return jax.random.uniform(jax.random.key(seed),
                              (cfg_.height, cfg_.width, 3), jnp.float32)
