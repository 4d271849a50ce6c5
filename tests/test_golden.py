"""Golden parity against the REAL reference C++ renderer.

Chain of custody: C++ (reference headers, tape-injected rand) == NumPy
mirror (replaying the same uniforms) == wavefront renderer (structured
tape). The first equality validates the mirror; the second is covered in
test_renderer_parity.py; here we also close the loop directly:
wavefront image/gradients vs the reference binary.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import golden_harness as gh
import reference_impl as ref
from drt_tpu.adjoint import make_diff_renderer
from drt_tpu.camera import camera_rays, pixel_grid
from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.renderer import trace_rays



@pytest.fixture(scope="module", autouse=True)
def golden_toolchain():
    """Decided per test, never at import: the reference headers and g++
    build the golden binary."""
    if not gh.golden_available():
        pytest.skip("reference headers or g++ missing")

W, H, SPP, DEPTH = 10, 8, 4, 32


@pytest.fixture(scope="module")
def golden():
    return gh.run(W, H, SPP, grad=True, seed=11)


@pytest.fixture(scope="module")
def mirror(golden):
    full, trunc, tape = ref.render_mirror(
        W, H, SPP, max_depth=DEPTH, tape_values=golden["uniforms"])
    return full, trunc, tape


def test_mirror_matches_cpp_exactly(golden, mirror):
    full, trunc, tape = mirror
    # Consumed draw counts must agree — proves identical control flow.
    assert len(tape.linear) == golden["consumed"]
    img_mirror = full.reshape(H, W, SPP, 3).mean(axis=2)
    np.testing.assert_allclose(img_mirror, golden["image"], rtol=1e-12,
                               atol=1e-15)


def test_wavefront_matches_cpp_image(golden, mirror):
    _, _, tape = mirror
    scene, params, cam = cbox.build(dtype=jnp.float64)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    xy = jnp.repeat(pixel_grid(W, H), SPP, axis=0)
    o, d, pdf = camera_rays(cam, W, H, xy, jnp.asarray(tape.cam_u))
    radiance = trace_rays(
        params, scene, o, d, None, cfg,
        tape=jnp.asarray(tape.bounce_u.transpose(0, 2, 1)))
    img = (np.asarray(radiance.to_array())
           / np.asarray(pdf)[:, None]).reshape(H, W, SPP, 3).mean(axis=2)
    # Truncation tail at depth 32, absorb 0.5 is ~2^-31: exact in practice.
    np.testing.assert_allclose(img, golden["image"], rtol=1e-9, atol=1e-12)


def test_wavefront_grads_match_cpp_autodiff(golden, mirror):
    """Radiative-backprop grads vs the reference's pointer-tape backward
    (vector.hpp:120-318) on identical samples. Golden grads are
    d/dparam of sum over ALL samples of radiance (backward(1) per sample,
    grads accumulate in the leaves — src/render.cpp:79-80 semantics)."""
    _, _, tape = mirror
    scene, params, cam = cbox.build(dtype=jnp.float64)
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_depth=DEPTH)
    xy = jnp.repeat(pixel_grid(W, H), SPP, axis=0)
    o, d, _ = camera_rays(cam, W, H, xy, jnp.asarray(tape.cam_u))
    diff = make_diff_renderer(scene, cfg, use_tape=True)
    tp = jnp.asarray(tape.bounce_u.transpose(0, 2, 1))
    def vsum(v):
        return v.x.sum() + v.y.sum() + v.z.sum()
    g = jax.grad(lambda p: vsum(diff(p, o, d, tp)))(params)
    # albedo rows: red, green, white  (golden rows 0,1,2); emission row 3.
    np.testing.assert_allclose(np.asarray(g.albedo), golden["grads"][:3],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(g.emission),
                               golden["grads"][3:4], rtol=1e-9, atol=1e-12)


def test_unbiased_backward_matches_cpp():
    """The reference's UNBIASED machinery at matched samples: the
    golden harness instantiates `integrate(..., unbiased=true)` (the
    IntegrateBackward redraw walk, integrate.hpp:11-24) on a recorded
    rand() stream; the NumPy oracle replays the identical stream.
    Draw-for-draw consumption equality proves identical control flow
    through the backward recursion; gradient equality pins the
    semantics."""
    w, h, spp = 6, 5, 3
    golden = gh.run(w, h, spp, grad=True, unbiased=True, seed=13)
    img, grads, tape = ref.render_mirror_unbiased(
        w, h, spp, tape_values=golden["uniforms"])
    assert len(tape.linear) == golden["consumed"]
    np.testing.assert_allclose(img, golden["image"], rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(grads["albedo"], golden["grads"][:3],
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(grads["emission"], golden["grads"][3:4],
                               rtol=1e-12, atol=1e-15)
    # The unbiased FORWARD consumes exactly like the biased forward
    # (integrate_unbiased's value loop, :45-47), so with no backward
    # interleaving draws the images agree draw-for-draw. (In grad mode
    # they diverge after the first sample: the backward consumes from
    # the shared global stream between samples.)
    unb_fwd = gh.run(w, h, spp, grad=False, unbiased=True, seed=13)
    biased = gh.run(w, h, spp, grad=False, seed=13)
    np.testing.assert_allclose(unb_fwd["image"], biased["image"],
                               rtol=1e-12, atol=1e-15)


def test_reference_render_seconds_reported():
    """The harness reports the C++ pixel-loop wall time (used by
    bench.py's vs_baseline to exclude process/tape overhead)."""
    out = gh.run(6, 5, 2, grad=True, seed=3)
    assert out["render_seconds"] > 0.0
