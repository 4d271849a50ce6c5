"""Path kernel (ops/pathkernel.py) in the Pallas interpreter against the
XLA wavefront fed the kernel's own draws: image, stored residuals and
reverse-sweep gradients, over four scenes, two depths, and pixel counts
that are and are not a multiple of the block."""

import numpy as np
import pytest

import jax.numpy as jnp

from drt_tpu.adjoint import _param_grads
from drt_tpu.ops import pathkernel
from drt_tpu.scene import albedo_table, emission_table

import kernel_cases as kc

SCENES = list(kc.BUILDERS)
# 8x8 = one whole block; 9x8 = two programs, the second padded.
SIZES = [(8, 8), (9, 8)]


@pytest.fixture(scope="module", params=SCENES)
def named_scene(request):
    return request.param, kc.scene(request.param)


def _run(scene_, params, cam, cfg_, collect=True):
    tracer = pathkernel.make_path_tracer(scene_, cam, cfg_,
                                         collect=collect, interpret=True)
    return tracer(albedo_table(scene_, params),
                  emission_table(scene_, params), kc.SEEDS)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", [1, 4])
def test_image_matches_xla_on_same_draws(named_scene, depth, size):
    name, (scene_, params, cam) = named_scene
    cfg_ = kc.cfg(*size, spp=2, depth=depth)
    img = np.asarray(_run(scene_, params, cam, cfg_, collect=False))
    want, _, _ = kc.oracle(scene_, params, cam, cfg_)
    assert img.shape == (size[1], size[0], 3)
    assert want.mean() > 0 or depth == 1
    np.testing.assert_allclose(img, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("depth", [1, 4])
def test_residuals_match_xla_collect(named_scene, depth):
    """(sc, best) rows s*D + b against the XLA residuals of the same
    paths: sc, liveness (gate), and the hit shape's albedo and emission
    rows."""
    name, (scene_, params, cam) = named_scene
    cfg_ = kc.cfg(9, 8, spp=2, depth=depth)
    npix = 72
    _, rsc, rbest = _run(scene_, params, cam, cfg_)
    _, _, res = kc.oracle(scene_, params, cam, cfg_)
    assert rsc.shape == (cfg_.spp * depth, pathkernel.padded_pixels(cfg_))

    def per_bounce(x):  # [spp*D, P] -> [D, spp*npix] (spp-outer rays)
        x = np.asarray(x)[:, :npix].reshape(cfg_.spp, depth, npix)
        return x.transpose(1, 0, 2).reshape(depth, -1)

    sc, best = per_bounce(rsc), per_bounce(rbest)
    np.testing.assert_allclose(sc, np.asarray(res.sc), rtol=1e-4,
                               atol=1e-5)
    # After a null-BxDF (emitter) hit a path continues with a zero
    # direction and zero throughput (renderer._bounce); whether such a
    # ray "hits" again is decided by rounding alone and moves no value.
    # Liveness is compared where the path enters the bounce with
    # nonzero throughput.
    psum = (np.asarray(res.P.x) + np.asarray(res.P.y)
            + np.asarray(res.P.z))
    carries = np.ones(psum.shape, bool)
    carries[1:] = (psum[:-1] > 0) & (np.asarray(res.sc)[:-1] > 0)
    alive = best > 0
    np.testing.assert_array_equal(alive[carries],
                                  (np.asarray(res.gate) > 0)[carries])
    alive &= carries
    ss = pathkernel.StaticScene(scene_)
    alb_row = np.asarray(ss.albedo_row)[np.maximum(best - 1, 0)]
    emit_row = np.asarray(ss.emit_row)[np.maximum(best - 1, 0)]
    np.testing.assert_array_equal(alb_row[alive], np.asarray(res.aid)[alive])
    np.testing.assert_array_equal(emit_row[alive],
                                  np.asarray(res.eid)[alive])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("depth", [1, 4])
def test_sweep_matches_param_grads(named_scene, depth, size):
    name, (scene_, params, cam) = named_scene
    cfg_ = kc.cfg(*size, spp=2, depth=depth)
    _, rsc, rbest = _run(scene_, params, cam, cfg_)
    _, _, res = kc.oracle(scene_, params, cam, cfg_)
    g = kc.random_cotangent(cfg_)
    sweep = pathkernel.make_path_sweep(scene_, cfg_, interpret=True)
    da, de = sweep(albedo_table(scene_, params),
                   emission_table(scene_, params), rsc, rbest,
                   g / cfg_.spp)
    want = _param_grads(params, scene_, res, kc.ray_cotangent(g, cfg_.spp),
                        jnp.float32)
    k, l = params.albedo.shape[0], params.emission.shape[0]
    # Sentinel rows carry no parameter and stay zero.
    assert not np.asarray(da)[k:].any() and not np.asarray(de)[l:].any()
    for got, ref in ((np.asarray(da)[:k], np.asarray(want.albedo)),
                     (np.asarray(de)[:l], np.asarray(want.emission))):
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
