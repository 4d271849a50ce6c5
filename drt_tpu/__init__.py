"""drt_tpu — differentiable path tracer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
C++ renderer (thalesfm/differentiable-renderer): a Monte-Carlo path tracer
whose radiance is reverse-mode differentiable w.r.t. shading parameters
(albedo, specular color, emission) via radiative backpropagation.

Architecture (not a translation of the reference):
  - flat SoA ray/hit state over a fixed-depth wavefront loop (`lax.scan`)
    instead of the reference's per-ray recursion
    (reference: include/drt/pathtracer.hpp:121-136),
  - `jax.custom_vjp` radiative backprop that closes parameter gradients
    from per-bounce residuals, instead of the reference's pointer-based
    autodiff tape (reference: include/drt/vector.hpp:120-318,
    integrate.hpp:11-52),
  - on a GPU, one Pallas kernel (Triton route) that keeps each path in
    registers and stores 8 B/bounce-ray residuals for the backward
    (drt_tpu/ops/pathkernel.py),
  - pixel-tile / sample sharding over a `jax.sharding.Mesh` with psum'd
    parameter gradients for multi-device scaling (reference: single
    thread).
"""

from drt_tpu.config import RenderConfig
from drt_tpu.scene import Scene, Params, SceneBuilder, make_scene
from drt_tpu.camera import Camera, look_at
from drt_tpu.renderer import trace_rays, render_image
from drt_tpu.adjoint import make_diff_renderer, make_diff_image_renderer
from drt_tpu.gradcheck import check_gradients, grad_image, grad_image_fwd
from drt_tpu.integrate import integrate
from drt_tpu.parallel.render import make_renderer, resolve_backend

__version__ = "0.2.0"

__all__ = [
    "RenderConfig",
    "Scene",
    "Params",
    "SceneBuilder",
    "make_scene",
    "integrate",
    "Camera",
    "look_at",
    "trace_rays",
    "render_image",
    "make_diff_renderer",
    "make_diff_image_renderer",
    "make_renderer",
    "resolve_backend",
    "check_gradients",
    "grad_image",
    "grad_image_fwd",
    "__version__",
]
