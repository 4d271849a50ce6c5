"""Gradient validation of the radiative-backprop custom VJP.

Strategy (SURVEY.md §4 "Gradient"):
  1. biased mode (key replay) must equal `jax.grad` of the forward
     estimator — the same identity the reference's biased integrate mode
     satisfies by construction (integrate.hpp:26-37);
  2. finite differences on a *fixed injected tape* (a deterministic
     function) must match;
  3. unbiased mode (fresh keys) must agree in expectation.
"""

import jax
import jax.numpy as jnp
import numpy as np

from drt_tpu.adjoint import make_diff_renderer
from drt_tpu.camera import camera_rays, pixel_grid
from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.renderer import trace_rays
from drt_tpu.scene import Params
import reference_impl as ref
from drt_tpu.ops.vecmath import V3


def vsum(v):
    return v.x.sum() + v.y.sum() + v.z.sum()


def _setup(width=8, height=6, spp=4, max_depth=12, seed=0,
           dtype=jnp.float64):
    full, trunc, tape = ref.render_mirror(width, height, spp,
                                          max_depth=max_depth, seed=seed)
    scene, params, cam = cbox.build(dtype=dtype)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth)
    xy = jnp.repeat(pixel_grid(width, height), spp, axis=0)
    o, d, _ = camera_rays(cam, width, height, xy,
                          jnp.asarray(tape.cam_u, dtype))
    tape3 = jnp.asarray(tape.bounce_u.transpose(0, 2, 1), dtype)
    return scene, params, cfg, o, d, tape3


def test_custom_vjp_equals_jax_grad_tape():
    scene, params, cfg, o, d, tape = _setup()
    diff = make_diff_renderer(scene, cfg, use_tape=True)

    def loss_custom(p):
        return vsum(diff(p, o, d, tape))

    def loss_ad(p):
        return vsum(trace_rays(p, scene, o, d, None, cfg, tape=tape))

    g_custom = jax.grad(loss_custom)(params)
    g_ad = jax.grad(loss_ad)(params)
    np.testing.assert_allclose(g_custom.albedo, g_ad.albedo, rtol=1e-10)
    np.testing.assert_allclose(g_custom.emission, g_ad.emission, rtol=1e-10)
    # gradients are non-trivial
    assert np.abs(np.asarray(g_custom.albedo)).max() > 0.1
    assert np.abs(np.asarray(g_custom.emission)).max() > 0.1


def test_custom_vjp_equals_jax_grad_key_mode():
    scene, params, cfg, o, d, _ = _setup()
    key = jax.random.key(123)
    rng = jax.random.key_data(key)
    diff = make_diff_renderer(scene, cfg)

    def loss_custom(p):
        return vsum(diff(p, o, d, rng))

    def loss_ad(p):
        return vsum(trace_rays(p, scene, o, d, key, cfg))

    g_custom = jax.grad(loss_custom)(params)
    g_ad = jax.grad(loss_ad)(params)
    np.testing.assert_allclose(g_custom.albedo, g_ad.albedo, rtol=1e-10)
    np.testing.assert_allclose(g_custom.emission, g_ad.emission, rtol=1e-10)


def test_finite_differences_tape():
    scene, params, cfg, o, d, tape = _setup(width=6, height=4, spp=2)
    diff = make_diff_renderer(scene, cfg, use_tape=True)

    def loss(p):
        return vsum(diff(p, o, d, tape))

    g = jax.grad(loss)(params)
    eps = 1e-6
    for (pname, row, col) in [("albedo", 0, 0), ("albedo", 2, 1),
                              ("emission", 0, 2)]:
        arr = getattr(params, pname)
        bump = arr.at[row, col].add(eps)
        p_plus = params._replace(**{pname: bump})
        bump = arr.at[row, col].add(-eps)
        p_minus = params._replace(**{pname: bump})
        fd = (loss(p_plus) - loss(p_minus)) / (2 * eps)
        np.testing.assert_allclose(getattr(g, pname)[row, col], fd,
                                   rtol=1e-5)


def test_per_ray_cotangents():
    """Non-uniform upstream cotangent: grad of weighted sum must equal the
    weighted combination of per-ray gradients."""
    scene, params, cfg, o, d, tape = _setup(width=4, height=3, spp=2)
    diff = make_diff_renderer(scene, cfg, use_tape=True)
    w = V3.from_array(jnp.asarray(
        np.random.default_rng(5).normal(size=(o.x.shape[0], 3))))

    def loss_custom(p):
        return vsum(diff(p, o, d, tape) * w)

    def loss_ad(p):
        return vsum(trace_rays(p, scene, o, d, None, cfg, tape=tape) * w)

    g_custom = jax.grad(loss_custom)(params)
    g_ad = jax.grad(loss_ad)(params)
    np.testing.assert_allclose(g_custom.albedo, g_ad.albedo, rtol=1e-10)
    np.testing.assert_allclose(g_custom.emission, g_ad.emission, rtol=1e-10)


def test_image_renderer_grads_match_jax_grad():
    """The chunked image-level custom VJP (chunk loop inside the VJP) must
    equal jax.grad of the unchunked forward render on the same keys."""
    import dataclasses
    from drt_tpu.adjoint import make_diff_image_renderer
    from drt_tpu.renderer import render_image
    from drt_tpu.models import cbox as cbox_m

    scene, params, cam = cbox_m.build(dtype=jnp.float64)
    cfg1 = RenderConfig(width=8, height=6, spp=4, max_depth=8, spp_chunks=1)
    cfg4 = dataclasses.replace(cfg1, spp_chunks=4)
    key = jax.random.key(11)
    rng = jax.random.key_data(key)
    w = jnp.asarray(np.random.default_rng(3).normal(size=(6, 8, 3)))

    for cfg in (cfg1, cfg4):
        diff = make_diff_image_renderer(scene, cam, cfg)

        def loss_custom(p):
            return (diff(p, rng) * w).sum()

        def loss_ad(p):
            return (render_image(p, scene, cam, key, cfg) * w).sum()

        img_c = diff(params, rng)
        img_a = render_image(params, scene, cam, key, cfg)
        np.testing.assert_allclose(img_c, img_a, rtol=1e-12)
        g_c = jax.grad(loss_custom)(params)
        g_a = jax.grad(loss_ad)(params)
        np.testing.assert_allclose(g_c.albedo, g_a.albedo, rtol=1e-9)
        np.testing.assert_allclose(g_c.emission, g_a.emission, rtol=1e-9)


def test_unbiased_mode_agrees_in_expectation():
    """Fresh-key adjoint (reference: integrate.hpp:11-24) is a different
    estimator; averaged over many keys it must approach the biased-replay
    gradient of the converged estimator.

    The tolerance is scaled to the measured standard error of the mean
    difference (4*SE per entry), and the test asserts its own power:
    4*SE < 10% of the gradient scale, so a 10% systematic bias in the
    unbiased estimator necessarily fails the bound (verified by mutation:
    scaling the unbiased grads by 1.1 trips the per-entry assert)."""
    import dataclasses
    # 3072 rays/trial x 200 paired trials: 4*SE lands at ~5-7% of the
    # gradient scale, below the 10% power floor asserted below.
    scene, params, cfg0, o, d, _ = _setup(width=16, height=12, spp=16)
    cfg_u = dataclasses.replace(cfg0, unbiased=True)
    diff_u = make_diff_renderer(scene, cfg_u)
    diff_b = make_diff_renderer(scene, cfg0)

    def make_gfn(diff):  # jit once; trials only execute
        return jax.jit(jax.grad(lambda p, rng: vsum(diff(p, o, d, rng))))

    gfn_u, gfn_b = make_gfn(diff_u), make_gfn(diff_b)

    def g_of(gfn, seed):
        rng = jax.random.key_data(jax.random.key(seed))
        return np.asarray(gfn(params, rng).albedo)

    # Paired seeds: both estimators share the forward stream per seed, so
    # the difference isolates the backward-retrace noise and the paired
    # SE is far tighter than the marginal one.
    n_trials = 200
    gb = np.stack([g_of(gfn_b, s) for s in range(n_trials)])
    gu = np.stack([g_of(gfn_u, s) for s in range(n_trials)])
    d_pair = gu - gb
    mean_d = d_pair.mean(axis=0)
    se = np.sqrt(d_pair.var(axis=0) / n_trials)
    scale = np.abs(gb.mean(0)).max()
    # Power: the bound must be able to catch a 10% systematic bias.
    assert (4.0 * se).max() < 0.10 * scale, (se.max(), scale)
    np.testing.assert_array_less(np.abs(mean_d), 4.0 * se + 1e-12 * scale)


def test_bsdf_samples_biased_grads_equal_jax_grad():
    """bsdf_samples > 1 (integrate.hpp:56-66 n_samples, per-vertex tree
    splitting): the biased custom VJP must still equal jax.grad of the
    (splitting) forward estimator — the same identity as n=1."""
    import dataclasses
    scene, params, cfg0, o, d, _ = _setup(width=8, height=6, spp=4,
                                          max_depth=4)
    cfg = dataclasses.replace(cfg0, bsdf_samples=2)
    key = jax.random.key(77)
    rng = jax.random.key_data(key)
    diff = make_diff_renderer(scene, cfg)

    g_custom = jax.grad(lambda p: vsum(diff(p, o, d, rng)))(params)
    g_ad = jax.grad(lambda p: vsum(trace_rays(p, scene, o, d, key,
                                              cfg)))(params)
    np.testing.assert_allclose(g_custom.albedo, g_ad.albedo, rtol=1e-10)
    np.testing.assert_allclose(g_custom.emission, g_ad.emission,
                               rtol=1e-10)
    assert np.abs(np.asarray(g_custom.albedo)).max() > 1e-3


def test_bsdf_samples_same_expectation_lower_variance():
    """The n-sample tree estimator has the same expectation as n=1 and
    strictly lower variance (each scattering integral is averaged over
    n draws, integrate.hpp:62-65)."""
    import dataclasses
    scene, params, cfg1, o, d, _ = _setup(width=4, height=3, spp=2,
                                          max_depth=4)
    cfg2 = dataclasses.replace(cfg1, bsdf_samples=2)

    def mean_radiance(cfg, seed):
        L = trace_rays(params, scene, o, d, jax.random.key(seed), cfg)
        return float((L.x + L.y + L.z).mean())

    trials = 80
    v1 = np.asarray([mean_radiance(cfg1, s) for s in range(trials)])
    v2 = np.asarray([mean_radiance(cfg2, s + 1000)
                     for s in range(trials)])
    se = np.sqrt(v1.var() / trials + v2.var() / trials)
    assert abs(v1.mean() - v2.mean()) < 4.0 * se, (
        v1.mean(), v2.mean(), se)
    assert v2.var() < 0.75 * v1.var(), (v1.var(), v2.var())


def test_adjoint_samples_variance_reduction():
    """Unbiased backward with adjoint_samples=4 (the integrate.hpp:15-19
    n_samples loop): same gradient expectation as n=1, variance cut
    ~1/4."""
    import dataclasses
    scene, params, cfg0, o, d, _ = _setup(width=4, height=3, spp=4,
                                          max_depth=6)
    cfg1 = dataclasses.replace(cfg0, unbiased=True)
    cfg4 = dataclasses.replace(cfg0, unbiased=True, adjoint_samples=4)
    diff1 = make_diff_renderer(scene, cfg1)
    diff4 = make_diff_renderer(scene, cfg4)

    def make_gfn(diff):  # jit once; trials only execute
        return jax.jit(jax.grad(lambda p, rng: vsum(diff(p, o, d, rng))))

    gfn1, gfn4 = make_gfn(diff1), make_gfn(diff4)

    def g_albedo(gfn, seed):
        rng = jax.random.key_data(jax.random.key(seed))
        return np.asarray(gfn(params, rng).albedo)

    trials = 40
    g1 = np.stack([g_albedo(gfn1, s) for s in range(trials)])
    g4 = np.stack([g_albedo(gfn4, s) for s in range(trials)])
    # Forward streams are shared per seed, so the backward-retrace noise
    # is the only difference; compare means with an SE-scaled bound.
    se = np.sqrt(g1.var(0) / trials + g4.var(0) / trials)
    np.testing.assert_array_less(
        np.abs(g1.mean(0) - g4.mean(0)), 4.0 * se + 1e-12)
    # n=4 averages 4 independent retraces: backward-sourced variance
    # drops ~4x; total per-entry variance must drop clearly.
    v1 = g1.var(0).mean()
    v4 = g4.var(0).mean()
    assert v4 < 0.6 * v1, (v1, v4)


def test_jvp_dual_number_ground_truth():
    """The reference validates reverse-mode grads against a forward-mode
    dual-number render (README.md:138-145, Dual<double> at
    src/render.cpp:22-23). Equivalent here: jax.jvp through the tape-mode
    estimator is exactly that dual-number pass; for every tangent
    direction v, <vjp-grad, v> must equal the jvp tangent."""
    scene, params, cfg, o, d, tape = _setup(max_depth=6)
    diff = make_diff_renderer(scene, cfg, use_tape=True)

    def loss(p):
        return vsum(diff(p, o, d, tape))

    def loss_ad(p):  # plain AD graph (no custom VJP) for the jvp pass
        return vsum(trace_rays(p, scene, o, d, None, cfg, tape=tape))

    grad = jax.grad(loss)(params)
    rng = np.random.default_rng(3)
    for _ in range(4):
        v = Params(
            albedo=jnp.asarray(rng.normal(size=params.albedo.shape)),
            emission=jnp.asarray(rng.normal(size=params.emission.shape)))
        _, tangent = jax.jvp(loss_ad, (params,), (v,))
        dot = (jnp.sum(grad.albedo * v.albedo)
               + jnp.sum(grad.emission * v.emission))
        np.testing.assert_allclose(float(dot), float(tangent),
                                   rtol=1e-9, atol=1e-12)


def test_tape_driven_unbiased_identity():
    """bwd_tape mode: the unbiased backward consumes a
    SECOND injected tape for its fresh retrace. With tape_bwd ==
    tape_fwd it must reduce EXACTLY to the biased replay — the
    sample-matched identity between integrate.hpp:26-37 (replay) and
    integrate.hpp:11-24 (redraw) when the 'fresh' draws happen to equal
    the forward's."""
    import dataclasses
    scene, params, cfg0, o, d, tape = _setup()
    cfg = dataclasses.replace(cfg0, unbiased=True)
    diff_u = make_diff_renderer(scene, cfg, use_tape=True, bwd_tape=True)
    diff_b = make_diff_renderer(scene, cfg0, use_tape=True)

    g_u = jax.grad(lambda p: vsum(diff_u(p, o, d, tape, tape)))(params)
    g_b = jax.grad(lambda p: vsum(diff_b(p, o, d, tape)))(params)
    np.testing.assert_array_equal(np.asarray(g_u.albedo),
                                  np.asarray(g_b.albedo))
    np.testing.assert_array_equal(np.asarray(g_u.emission),
                                  np.asarray(g_b.emission))


def test_tape_driven_unbiased_expectation():
    """The tape-driven unbiased backward retraces a FULLY fresh path
    from the second tape, so its expectation over backward tapes equals
    the expectation of the replay gradient over FORWARD tapes (both are
    i.i.d. draws of the same radiative-backprop estimator of dL/dp) —
    NOT the replay gradient at one fixed forward tape, whose own sample
    noise would read as a systematic offset. Compare ensemble means
    with a combined standard-error band."""
    import dataclasses
    scene, params, cfg0, o, d, tape = _setup(width=6, height=4, spp=2,
                                             max_depth=6)
    cfg = dataclasses.replace(cfg0, unbiased=True)
    diff_u = make_diff_renderer(scene, cfg, use_tape=True, bwd_tape=True)
    diff_b = make_diff_renderer(scene, cfg0, use_tape=True)

    n_trials = 256
    k_u, k_b = jax.random.split(jax.random.key(123))
    tapes_u = jax.random.uniform(k_u, (n_trials,) + tape.shape,
                                 dtype=tape.dtype)
    tapes_b = jax.random.uniform(k_b, (n_trials,) + tape.shape,
                                 dtype=tape.dtype)

    def flat(g):
        return jnp.concatenate([g.albedo.ravel(), g.emission.ravel()])

    g_u = jax.jit(jax.vmap(lambda tb: flat(jax.grad(
        lambda p: vsum(diff_u(p, o, d, tape, tb)))(params))))(tapes_u)
    g_r = jax.jit(jax.vmap(lambda tf: flat(jax.grad(
        lambda p: vsum(diff_b(p, o, d, tf)))(params))))(tapes_b)
    g_u, g_r = np.asarray(g_u), np.asarray(g_r)

    mean_u, mean_r = g_u.mean(axis=0), g_r.mean(axis=0)
    se = np.sqrt(g_u.var(axis=0, ddof=1) / n_trials
                 + g_r.var(axis=0, ddof=1) / n_trials)
    scale = np.abs(mean_r).max()
    # 5-sigma band; also require the band to be informative on the
    # DOMINANT gradient entry (a 100% systematic error there must be
    # detectable — small noisy entries may legitimately have wide
    # relative bands).
    np.testing.assert_array_less(np.abs(mean_u - mean_r),
                                 5.0 * se + 1e-12 * scale)
    assert 5.0 * se[np.argmax(np.abs(mean_r))] < scale
