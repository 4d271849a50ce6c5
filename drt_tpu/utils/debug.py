"""Numerical sanitizers (SURVEY.md §5 "Race detection / sanitizers").

The reference is single-threaded by construction; its hazards under
threading (global libc RNG, `mutable m_grad +=`) don't exist in JAX's
functional model. The hazard class here is *numerical*: NaN/Inf
escaping masked lanes, out-of-range table indices feeding gathers. This
module provides checkify-based wrappers that turn those into hard errors
in tests/staging, and cheap assert helpers for scene construction.
"""

from __future__ import annotations

import jax
from jax.experimental import checkify

from drt_tpu.scene import Params, Scene


def checked(fn, *, errors=checkify.float_checks):
    """Wrap `fn` so NaN/Inf produced anywhere inside raises on call.

    Returns a function with the same signature; call `.throw()` semantics
    are handled internally. Intended for tests and staging runs — the
    checks disable XLA fusions, do not ship this in the hot path.
    """
    cfn = checkify.checkify(fn, errors=errors)

    def wrapped(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapped


def assert_finite(tree, name: str = "tree") -> None:
    """Host-side finiteness assert over a pytree of arrays."""
    import numpy as np

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        if a.dtype.kind == "f" and not np.isfinite(a).all():
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}")


def validate_scene(scene: Scene, params: Params) -> None:
    """Static index-range validation of the SoA scene: every gather the
    wavefront performs must be in range (the functional analogue of the
    OOB class of sanitizer findings)."""
    import numpy as np

    n_mat = scene.mat_type.shape[0]
    n_alb = params.albedo.shape[0]
    n_emit = params.emission.shape[0]
    sm = np.asarray(scene.shape_mat)
    se = np.asarray(scene.shape_emit)
    ma = np.asarray(scene.mat_albedo)
    if not ((0 <= sm) & (sm < n_mat)).all():
        raise IndexError(f"shape_mat out of range [0, {n_mat})")
    if not ((0 <= se) & (se <= n_emit)).all():
        raise IndexError(f"shape_emit out of range [0, {n_emit}]")
    if not ((0 <= ma) & (ma <= n_alb)).all():
        raise IndexError(f"mat_albedo out of range [0, {n_alb}]")
    geo = np.asarray(scene.shape_geo)
    if not np.isfinite(geo).all():
        raise FloatingPointError("non-finite scene geometry")
    st = np.asarray(scene.shape_type)
    sphere_r = geo[st == 1, 3]
    if (sphere_r <= 0).any():
        raise ValueError("sphere with non-positive radius")


def nan_debug(enable: bool = True) -> None:
    """Toggle jax_debug_nans globally (fails fast at the first NaN-
    producing primitive — coarse but zero-setup)."""
    jax.config.update("jax_debug_nans", enable)
