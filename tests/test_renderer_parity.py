"""Sample-matched parity: wavefront tracer vs the reference mirror.

The mirror consumes uniforms in the reference's exact recursive order
(SURVEY.md §3.2) and records them structured by (ray, bounce, slot); the
wavefront consumes the same values via tape injection. Radiance must match
to f64 roundoff for every sample — this exercises scene construction,
camera, intersection, BxDF sampling/eval, Russian roulette, emission
accumulation, and depth truncation end to end.
"""

import numpy as np
import jax.numpy as jnp

from drt_tpu.camera import camera_rays, pixel_grid
from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.renderer import trace_rays
import reference_impl as ref


def _run_parity(width, height, spp, max_depth, min_bounces, absorb, seed,
                dtype, rtol, atol):
    full, trunc, tape = ref.render_mirror(
        width, height, spp, absorb=absorb, min_bounces=min_bounces,
        max_depth=max_depth, seed=seed)
    scene, params, cam = cbox.build(dtype=dtype)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       min_bounces=min_bounces, absorb_prob=absorb,
                       max_depth=max_depth)
    xy = jnp.repeat(pixel_grid(width, height), spp, axis=0)
    o, d, pdf = camera_rays(cam, width, height, xy,
                            jnp.asarray(tape.cam_u, dtype))
    radiance = trace_rays(
        params, scene, o, d, None, cfg,
        tape=jnp.asarray(tape.bounce_u.transpose(0, 2, 1), dtype))
    radiance = (np.asarray(radiance.to_array())
                / np.asarray(pdf)[:, None])
    np.testing.assert_allclose(radiance, trunc, rtol=rtol, atol=atol)
    return radiance, full, trunc


def test_parity_f64_exact():
    radiance, full, trunc = _run_parity(
        width=12, height=9, spp=4, max_depth=16, min_bounces=1, absorb=0.5,
        seed=0, dtype=jnp.float64, rtol=1e-11, atol=1e-13)
    # sanity: the scene is actually lit
    assert radiance.max() > 0.1


def test_parity_f64_min_bounces_0():
    _run_parity(width=6, height=5, spp=3, max_depth=12, min_bounces=0,
                absorb=0.6, seed=3, dtype=jnp.float64, rtol=1e-11,
                atol=1e-13)


def test_parity_f64_deep():
    """Low absorb probability -> long paths stress depth handling."""
    _run_parity(width=5, height=4, spp=2, max_depth=24, min_bounces=2,
                absorb=0.3, seed=7, dtype=jnp.float64, rtol=1e-11,
                atol=1e-13)


def test_parity_f32_tolerance():
    """f32 agrees with the f64 mirror within single-precision
    accumulated tolerance (precision policy in SURVEY.md §7)."""
    radiance, full, trunc = _run_parity(
        width=10, height=8, spp=4, max_depth=12, min_bounces=1, absorb=0.5,
        seed=1, dtype=jnp.float32, rtol=2e-3, atol=2e-3)


def test_truncation_tail_is_small():
    """Truncated-vs-full gap decays like (1-absorb)^(D - min_bounces)."""
    full, trunc, _ = ref.render_mirror(8, 6, 4, absorb=0.5, min_bounces=1,
                                       max_depth=16, seed=2)
    gap = np.abs(full - trunc).max()
    assert gap < 1e-3
