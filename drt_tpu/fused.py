"""Image-level differentiable renderer over the path kernel.

Composes drt_tpu/ops/pathkernel.py's forward (camera generation, hash
RNG and the whole bounce loop per pixel block) and its reverse sweep
into `render(params, seeds) -> image`, differentiable in params via a
`jax.custom_vjp`. The forward that a backward follows stores the
8 B/bounce-ray residuals `(sc, best)`, so the backward is a cheap
reverse sweep instead of a retrace — radiative backprop in the biased
(sample-replay) mode, reference: include/drt/integrate.hpp:26-37. The
unbiased mode (fresh retraces, integrate.hpp:11-24) and bsdf_samples > 1
stay on the XLA path (drt_tpu/adjoint.py).

The kernel's hash RNG is not the threefry stream of the XLA path, so
images agree with the XLA renderer statistically; `pathkernel.hash_tapes`
gives the XLA path the kernel's exact draws for parity tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from drt_tpu.camera import Camera
from drt_tpu.config import RenderConfig
from drt_tpu.ops.pathkernel import make_path_sweep, make_path_tracer
from drt_tpu.scene import Params, Scene, albedo_table, emission_table


def seeds_from_key(key) -> jnp.ndarray:
    """Derive the i32[2] (camera, bounce) seed pair from a JAX PRNG key."""
    data = jax.random.key_data(key).astype(jnp.uint32)
    return data.reshape(-1)[:2].astype(jnp.int32)


def make_kernel_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                               interpret: bool = False):
    """Build `render(params, seeds: i32[2]) -> image f[H, W, 3]`,
    differentiable in params (biased mode, bsdf_samples == 1)."""
    if cfg.unbiased or cfg.bsdf_samples != 1:
        raise ValueError("the path kernel renders the biased "
                         "1-sample-per-vertex estimator; unbiased "
                         "gradients and bsdf_samples > 1 run on the xla "
                         "backend")
    tracer = make_path_tracer(scene, cam, cfg, interpret=interpret)
    collect = make_path_tracer(scene, cam, cfg, collect=True,
                               interpret=interpret)
    sweep = make_path_sweep(scene, cfg, interpret=interpret)

    def tables(params):
        return albedo_table(scene, params), emission_table(scene, params)

    @jax.custom_vjp
    def render(params: Params, seeds: jnp.ndarray) -> jnp.ndarray:
        return tracer(*tables(params), seeds).astype(params.albedo.dtype)

    def fwd(params, seeds):
        img, rsc, rbest = collect(*tables(params), seeds)
        return img.astype(params.albedo.dtype), (params, rsc, rbest)

    def bwd(res, g):
        params, rsc, rbest = res
        # image = mean over spp of path radiance: each path's cotangent
        # is its pixel's g / spp.
        da, de = sweep(*tables(params), rsc, rbest, g / cfg.spp)
        k = params.albedo.shape[0]
        l = params.emission.shape[0]
        return (Params(albedo=da[:k].astype(params.albedo.dtype),
                       emission=de[:l].astype(params.emission.dtype)),
                None)

    render.defvjp(fwd, bwd)
    return render
