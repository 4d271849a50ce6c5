"""Sharded rendering / training-step builders.

Composes the wavefront renderer + radiative-backprop VJP with a device
mesh: rays sharded over (tiles, spp), params replicated, parameter-grad
partial sums psum'd by the SPMD partitioner (design per SURVEY.md §2/§7;
the reference has no parallel analogue — src/render.cpp:72-86 is serial).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from drt_tpu.adjoint import make_diff_image_renderer
from drt_tpu.camera import Camera
from drt_tpu.config import RenderConfig
from drt_tpu.parallel.mesh import constrain_rays, replicated
from drt_tpu.renderer import render_image, trace_rays
from drt_tpu.scene import Params, Scene


# Backend names make_renderer accepts besides "auto".
XLA = "xla"
KERNEL = "pathkernel"

# Share of the device's memory limit that the path kernel's stored
# residuals may take; the rest is left to the image, the sweep and XLA.
RESIDUAL_MEMORY_FRACTION = 0.25


def _platform() -> str:
    return jax.devices()[0].platform


def _bytes_limit() -> int | None:
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("bytes_limit")


def kernel_misfit(scene: Scene, cfg: RenderConfig,
                  mesh: Mesh | None) -> str | None:
    """Why the path kernel cannot render this at all, or None. It needs
    a single device, an f32 scene small enough to bake
    (pathkernel.MAX_SHAPES) at a depth it unrolls (pathkernel.MAX_DEPTH),
    the biased 1-sample-per-vertex estimator, and residuals within i32
    indexing."""
    from drt_tpu.ops import pathkernel

    if mesh is not None:
        return "it renders on one device, without a mesh"
    if cfg.unbiased or cfg.bsdf_samples != 1:
        return ("it renders the biased 1-sample-per-vertex estimator "
                "(unbiased=False, bsdf_samples=1)")
    if scene.shape_geo.dtype != jnp.float32:
        return f"it renders f32 scenes, not {scene.shape_geo.dtype}"
    if scene.num_shapes > pathkernel.MAX_SHAPES:
        return (f"it bakes at most {pathkernel.MAX_SHAPES} shapes, not "
                f"{scene.num_shapes}")
    if cfg.max_depth > pathkernel.MAX_DEPTH:
        return (f"it unrolls at most {pathkernel.MAX_DEPTH} bounces, not "
                f"{cfg.max_depth}")
    if pathkernel.residual_bytes(cfg) // 4 >= 2 ** 31:
        return "its residuals would overflow i32 indexing"
    return None


def kernel_fits(scene: Scene, cfg: RenderConfig,
                mesh: Mesh | None) -> bool:
    """Whether "auto" picks the path kernel: no `kernel_misfit`, and the
    stored residuals within RESIDUAL_MEMORY_FRACTION of the device's
    memory."""
    from drt_tpu.ops import pathkernel

    if kernel_misfit(scene, cfg, mesh) is not None:
        return False
    limit = _bytes_limit()
    return (limit is None or pathkernel.residual_bytes(cfg)
            <= RESIDUAL_MEMORY_FRACTION * limit)


def resolve_backend(scene: Scene, cfg: RenderConfig, mesh: Mesh | None,
                    backend: str = "auto") -> str:
    """Resolve a backend name to the one make_renderer will use.

    "auto" picks the path kernel (drt_tpu/fused.py over
    ops/pathkernel.py) on a GPU when `kernel_fits`, and the XLA
    wavefront otherwise: CPU, f64 scenes, meshes of many shapes, deep
    paths, unbiased gradients, bsdf_samples > 1, device meshes and
    residuals over the memory budget.
    """
    if backend not in ("auto", XLA, KERNEL):
        raise ValueError(f"unknown backend {backend!r}; expected 'auto', "
                         f"'{XLA}' or '{KERNEL}'")
    if backend != "auto":
        return backend
    if _platform() == "gpu" and kernel_fits(scene, cfg, mesh):
        return KERNEL
    return XLA


def make_renderer(scene: Scene, cfg: RenderConfig, cam: Camera,
                  mesh: Mesh | None = None, differentiable: bool = True,
                  backend: str = "auto", interpret: bool = False):
    """Build `render(params, key) -> image f[H,W,3]`, jitted.

    With a mesh, per-ray arrays are sharding-constrained over it and params
    are replicated; gradients of the returned function psum over the mesh.

    backend: "xla" = the shardable wavefront scan; "pathkernel" = the
    single-device Pallas kernel (GPU only; `interpret=True` runs it in
    the Pallas interpreter for tests; raises where `kernel_misfit`);
    "auto" = resolve_backend.
    """
    backend = resolve_backend(scene, cfg, mesh, backend)
    if backend == KERNEL:
        misfit = kernel_misfit(scene, cfg, mesh)
        if misfit is not None:
            raise ValueError(f"the path kernel cannot render this: "
                             f"{misfit}; use backend='xla' or 'auto'")
        if _platform() != "gpu" and not interpret:
            raise ValueError("the path kernel compiles for the GPU only; "
                             "pass interpret=True to run it in the "
                             "Pallas interpreter")
        from drt_tpu.fused import make_kernel_image_renderer, seeds_from_key
        kernel = make_kernel_image_renderer(scene, cam, cfg,
                                            interpret=interpret)

        def render(params: Params, key) -> jnp.ndarray:
            return kernel(params, seeds_from_key(key))

        return jax.jit(render)

    if mesh is not None:
        n_dev = mesh.devices.size
        n_rays = cfg.width * cfg.height * (cfg.spp // cfg.spp_chunks)
        if n_rays % n_dev != 0:
            raise ValueError(
                f"rays per chunk ({n_rays}) must divide evenly over the "
                f"{n_dev}-device mesh; adjust width/height/spp")
        # Works on bare [N] arrays and V3 pytrees alike.
        constrain = lambda t: jax.tree.map(  # noqa: E731
            lambda x: constrain_rays(x, mesh), t)
    else:
        constrain = None

    if differentiable:
        diff = make_diff_image_renderer(scene, cam, cfg,
                                        constrain=constrain)

        def render(params: Params, key) -> jnp.ndarray:
            return diff(params, jax.random.key_data(key))
    else:
        def trace_fn(p, o, d, k):
            if constrain is not None:
                o, d = constrain(o), constrain(d)
            return trace_rays(p, scene, o, d, k, cfg)

        def render(params: Params, key) -> jnp.ndarray:
            return render_image(params, scene, cam, key, cfg,
                                trace_fn=trace_fn)

    if mesh is not None:
        return jax.jit(render, in_shardings=(replicated(mesh), None))
    return jax.jit(render)
