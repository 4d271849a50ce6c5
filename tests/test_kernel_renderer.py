"""Image-level path-kernel renderer (fused.make_kernel_image_renderer):
gradients against the XLA paths on the same draws, lowering for the GPU
from this CPU host, and the wrapper's shapes, padding and memory rule."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from drt_tpu.adjoint import make_diff_renderer
from drt_tpu.camera import camera_rays, pixel_grid
from drt_tpu.fused import make_kernel_image_renderer, seeds_from_key
from drt_tpu.models import cbox
from drt_tpu.ops import pathkernel
from drt_tpu.parallel import render as prender
from drt_tpu.renderer import trace_rays
from drt_tpu.scene import Params

import kernel_cases as kc


def _tape_rays(cam, cfg_):
    npix = cfg_.width * cfg_.height
    cam_u, tape = pathkernel.hash_tapes(kc.SEEDS, npix, cfg_.spp,
                                        cfg_.max_depth, jnp.float32)
    xy = jnp.tile(pixel_grid(cfg_.width, cfg_.height), (cfg_.spp, 1))
    o, d, _ = camera_rays(cam, cfg_.width, cfg_.height, xy, cam_u.T)
    return o, d, tape


def _mean_image(L, cfg_):
    npix = cfg_.width * cfg_.height
    return jnp.stack([c.reshape(cfg_.spp, npix).mean(0) for c in L],
                     -1).reshape(cfg_.height, cfg_.width, 3)


@pytest.mark.parametrize("name", list(kc.BUILDERS))
@pytest.mark.parametrize("depth", [2, 4])
def test_grad_matches_xla_diff_renderer(name, depth):
    """jax.grad through the kernel's custom VJP (stored residuals +
    sweep) equals jax.grad through the XLA radiative-backprop VJP
    (make_diff_renderer, tape mode) on the same draws."""
    scene_, params, cam = kc.scene(name)
    cfg_ = kc.cfg(9, 7, spp=2, depth=depth)
    w = kc.random_cotangent(cfg_, seed=3)
    render = make_kernel_image_renderer(scene_, cam, cfg_, interpret=True)
    g_k = jax.grad(lambda p: jnp.sum(w * render(p, kc.SEEDS)))(params)

    o, d, tape = _tape_rays(cam, cfg_)
    diff = make_diff_renderer(scene_, cfg_, use_tape=True)
    g_x = jax.grad(lambda p: jnp.sum(
        w * _mean_image(diff(p, o, d, tape), cfg_)))(params)
    for a, b in ((g_k.albedo, g_x.albedo), (g_k.emission, g_x.emission)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("name", list(kc.BUILDERS))
def test_grad_matches_forward_mode_ground_truth(name):
    """The kernel gradient of sum(w * image) against forward-mode AD
    (jax.jvp, the grad_image_fwd method) through the XLA tape render on
    the same draws: transport is channel-diagonal, so a one-hot row
    tangent gives d image_c / d theta_{row, c} for every channel."""
    scene_, params, cam = kc.scene(name)
    cfg_ = kc.cfg(8, 6, spp=2, depth=3)
    w = kc.random_cotangent(cfg_, seed=5)
    render = make_kernel_image_renderer(scene_, cam, cfg_, interpret=True)
    g_k = jax.grad(lambda p: jnp.sum(w * render(p, kc.SEEDS)))(params)
    o, d, tape = _tape_rays(cam, cfg_)

    def image(p):
        return _mean_image(trace_rays(p, scene_, o, d, None, cfg_,
                                      tape=tape), cfg_)

    for field in ("albedo", "emission"):
        rows = getattr(params, field).shape[0]
        for row in range(rows):
            tangent = Params(albedo=jnp.zeros_like(params.albedo),
                             emission=jnp.zeros_like(params.emission))
            one = jnp.zeros_like(getattr(params, field)).at[row].set(1.0)
            _, g_img = jax.jvp(image, (params,),
                               (tangent._replace(**{field: one}),))
            want = np.asarray(jnp.sum(w * g_img, axis=(0, 1)))
            got = np.asarray(getattr(g_k, field))[row]
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-5 * max(1.0,
                                                       np.abs(want).max()))


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_image_invariant_under_spp_chunks(chunks):
    """The hash stream is keyed by the global sample index, so the
    kernel's image does not depend on spp_chunks."""
    scene_, params, cam = cbox.build(dtype=jnp.float32)
    base = make_kernel_image_renderer(scene_, cam, kc.cfg(8, 8, spp=4),
                                      interpret=True)
    chunked = make_kernel_image_renderer(
        scene_, cam, kc.cfg(8, 8, spp=4, spp_chunks=chunks),
        interpret=True)
    np.testing.assert_array_equal(np.asarray(chunked(params, kc.SEEDS)),
                                  np.asarray(base(params, kc.SEEDS)))


@pytest.mark.parametrize("name", ["cbox", "glossy", "mixed"])
@pytest.mark.parametrize("step", ["forward", "forward+backward"])
def test_lowers_for_cuda_at_headline_shape(name, step):
    """Triton IR is emitted on this CPU host, so a primitive the Triton
    route cannot lower fails here without a card."""
    scene_, params, cam = kc.scene(name)
    cfg_ = kc.cfg(640, 480, spp=256, depth=5, min_bounces=1,
                  absorb_prob=0.5)
    render = make_kernel_image_renderer(scene_, cam, cfg_)
    fn = (render if step == "forward" else
          jax.value_and_grad(lambda p, s: render(p, s).mean()))
    seeds = seeds_from_key(jax.random.key(0))
    text = jax.jit(fn).trace(params, seeds).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text or "triton" in text.lower()
    n_kernels = 1 if step == "forward" else 2
    assert text.count("stablehlo.custom_call") >= n_kernels


def test_block_constants_and_padding():
    """Triton blocks are powers of two; pixels pad up to whole blocks."""
    for v in (pathkernel.BLOCK, pathkernel.NUM_WARPS):
        assert v > 0 and v & (v - 1) == 0
    cfg_ = kc.cfg(9, 8, spp=3, depth=4)
    n_pad = pathkernel.padded_pixels(cfg_)
    assert n_pad % pathkernel.BLOCK == 0 and 72 <= n_pad < 72 + \
        pathkernel.BLOCK
    assert pathkernel.residual_bytes(cfg_) == 8 * 3 * 4 * n_pad


@pytest.mark.parametrize("limit,fits", [(None, True), (1 << 40, True),
                                        (1 << 20, False)])
def test_memory_rule_of_kernel_choice(monkeypatch, limit, fits):
    """The residuals must fit RESIDUAL_MEMORY_FRACTION of the device's
    bytes_limit (no limit reported: no cap)."""
    scene_, _, _ = cbox.build(dtype=jnp.float32)
    monkeypatch.setattr(prender, "_bytes_limit", lambda: limit)
    cfg_ = kc.cfg(64, 48, spp=16, depth=5)
    assert prender.kernel_fits(scene_, cfg_, None) is fits


def test_i32_index_bound_routes_to_xla(monkeypatch):
    scene_, _, _ = cbox.build(dtype=jnp.float32)
    monkeypatch.setattr(prender, "_bytes_limit", lambda: None)
    huge = kc.cfg(4096, 4096, spp=1024, depth=32)
    assert not prender.kernel_fits(scene_, huge, None)


def test_kernel_renderer_rejects_unbiased_and_splitting():
    scene_, _, cam = cbox.build(dtype=jnp.float32)
    for kw in (dict(unbiased=True), dict(bsdf_samples=2)):
        with pytest.raises(ValueError, match="xla"):
            make_kernel_image_renderer(scene_, cam,
                                       kc.cfg(8, 8, spp=2, depth=3, **kw),
                                       interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_card(gpu_device):
    """The kernel as compiled for the card against the XLA oracle on the
    same draws (chip_smoke.py phase 2 runs this at 640x480)."""
    import chip_smoke

    with jax.default_device(gpu_device):
        out = chip_smoke.phase_parity(64, 48, 4)
    assert out["ok_fraction"] >= chip_smoke.PIX_OK_FRACTION
