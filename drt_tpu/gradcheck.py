"""Gradient images and forward-mode gradient checking.

The reference's flagship validation artifact is the per-pixel gradient
image d(pixel)/d(red-wall albedo) rendered by its reverse-mode tape and
validated against a dual-number (forward-mode) render
(reference: README.md:138-145, docs/images/cbox-grad.png vs
cbox-grad-gt.png; the dual scalar is include/drt/dual.hpp:10-72, used at
src/render.cpp:22-23).

Equivalents here, both exposed as library facilities:

- `grad_image`: the radiative-backprop gradient image. One retrace per
  spp chunk; the reverse suffix sweep keeps the PER-RAY gradient
  d L_c / d theta_{row,c} instead of segment-summing it into parameter
  rows (transport is componentwise — no channel mixing — so the
  per-channel diagonal IS the full Jacobian structure).
- `grad_image_fwd`: the same image by `jax.jvp` through the plain AD
  graph of the renderer with a one-hot tangent — the exact analogue of
  the reference's Dual<double> render, usable as ground truth for any
  scene (dual.hpp as a reusable drop-in validator).
- `check_gradients`: <vjp-grad, v> == jvp-tangent spot checks on random
  directions — the user-callable gradient-check utility.

In biased mode (key replay) the two images agree to float rounding by
the AD identity; `python -m drt_tpu.cli grad-image` renders and saves
both (the re-creation of the reference's headline figure).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from drt_tpu.camera import Camera
from drt_tpu.config import RenderConfig
from drt_tpu.renderer import (chunk_pixel_ids, chunk_rays, lane_count,
                              render_image, trace_rays)
from drt_tpu.scene import Params, Scene, albedo_table, emission_table


def _parse_param(params: Params, param: str):
    """'albedo:0' -> ('albedo', 0), validated against the param shapes."""
    name, _, row_s = param.partition(":")
    row = int(row_s) if row_s else 0
    if name not in ("albedo", "emission"):
        raise ValueError(f"unknown parameter {name!r} "
                         "(expected albedo or emission)")
    n_rows = getattr(params, name).shape[0]
    if not 0 <= row < n_rows:
        raise ValueError(f"{name} row {row} out of range [0, {n_rows})")
    return name, row


def grad_image(scene: Scene, cam: Camera, cfg: RenderConfig,
               params: Params, key, param: str = "albedo:0") -> jnp.ndarray:
    """d(image)/d(params.<name>[row]) as f[H,W,3] via radiative backprop.

    Channel c of the output is d(pixel_c)/d(theta_{row,c}) — transport
    never mixes channels, so the off-diagonal Jacobian blocks are
    identically zero (reference estimator: pathtracer.hpp:97-114).
    Biased (key-replay) retrace, so it equals forward-mode AD of the
    estimator rendered with the same `key` (grad_image_fwd).
    """
    name, row = _parse_param(params, param)
    if cfg.unbiased:
        raise ValueError(
            "grad_image renders the biased (key-replay) gradient "
            "artifact, which equals forward-mode AD of the estimator; "
            "an unbiased-mode per-pixel image is a different estimator "
            "with no matching jvp ground truth — set unbiased=False")
    dtype = cam.forward.dtype
    w, h = cfg.width, cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    M = lane_count(cfg)
    xy_rep = chunk_pixel_ids(cfg)
    albedo_tab = albedo_table(scene, params).astype(dtype)
    emission_tab = emission_table(scene, params).astype(dtype)

    from drt_tpu.ops.vecmath import V3, gatherv

    def chunk_image(chunk_idx):
        ck = jax.random.fold_in(key, chunk_idx)
        o, d, pdf = chunk_rays(cam, cfg, xy_rep, ck)
        _, res = trace_rays(params, scene, o, d, ck, cfg, collect=True)
        n_lanes = res.sc.shape[1]

        # Reverse suffix sweep (adjoint.py _param_grads math), keeping
        # the per-ray row-k gradient instead of reducing over rays:
        #   d L_c/d albedo_{k,c}  = sum_b P_b sc_b S_{b+1} [aid_b = k]
        #   d L_c/d emission_{l,c} = sum_b P_b [eid_b = l]
        def rev_body(carry, res_b):
            S, acc = carry
            P, sc, gate, aid, eid = res_b
            if name == "albedo":
                m = (aid == row).astype(dtype)
                acc = acc + P * (sc * m) * S
            else:
                m = (eid == row).astype(dtype)
                acc = acc + P * m
            e = gatherv(emission_tab, eid)
            w_b = gatherv(albedo_tab, aid) * sc
            S = (e + w_b * S) * gate
            return (S, acc), None

        S0 = V3.zeros((n_lanes,), dtype)
        (S, acc), _ = lax.scan(rev_body, (S0, S0), res, reverse=True)
        # lanes per pixel: spp_c rays x M split lanes, contiguous.
        pdf_l = jnp.repeat(pdf, M) if M > 1 else pdf
        chans = [(c / pdf_l).reshape(h, w, spp_c * M).mean(axis=2)
                 for c in acc]
        return jnp.stack(chans, axis=-1)

    if cfg.spp_chunks == 1:
        return chunk_image(jnp.asarray(0))
    images = lax.map(chunk_image, jnp.arange(cfg.spp_chunks))
    return images.mean(axis=0)


def grad_image_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
                   params: Params, key,
                   param: str = "albedo:0") -> jnp.ndarray:
    """The same gradient image by forward-mode AD (`jax.jvp`) through the
    plain renderer graph — the reference's Dual<double> ground-truth
    render (dual.hpp:10-72) in one tangent pass: tangent = ones on the
    chosen row, and since transport is channel-diagonal the jvp output
    IS the per-channel gradient image."""
    name, row = _parse_param(params, param)
    if cfg.unbiased:
        raise ValueError("grad_image_fwd is the biased-mode ground "
                         "truth; set unbiased=False (see grad_image)")

    def render(p):
        return render_image(p, scene, cam, key, cfg)

    tangent = Params(
        albedo=jnp.zeros_like(params.albedo),
        emission=jnp.zeros_like(params.emission))
    one_row = jnp.zeros_like(getattr(params, name)).at[row].set(1.0)
    tangent = tangent._replace(**{name: one_row})
    _, g_img = jax.jvp(render, (params,), (tangent,))
    return g_img


def check_gradients(scene: Scene, cam: Camera, cfg: RenderConfig,
                    params: Params, key, n_directions: int = 4,
                    seed: int = 0, rtol: float = 1e-4,
                    atol: float = 1e-8):
    """Validate the radiative-backprop VJP against forward-mode AD on
    random tangent directions: for each v,  <grad L, v>  must equal the
    jvp tangent of the same scalar loss (the reference's dual-number
    validation methodology, README.md:138-145, as a reusable utility).

    Returns a list of (dot, tangent) pairs; raises AssertionError on
    mismatch. Biased mode only (unbiased is a different estimator whose
    expectation, not value, matches)."""
    if cfg.unbiased:
        raise ValueError("check_gradients validates the biased "
                         "(key-replay) adjoint; set unbiased=False")
    from drt_tpu.adjoint import make_diff_image_renderer

    diff = make_diff_image_renderer(scene, cam, cfg)
    rng = jax.random.key_data(key)

    def loss_vjp(p):
        return diff(p, rng).sum()

    def loss_ad(p):
        return render_image(p, scene, cam, key, cfg).sum()

    grad = jax.grad(loss_vjp)(params)
    results = []
    rand = np.random.default_rng(seed)
    for _ in range(n_directions):
        v = Params(
            albedo=jnp.asarray(rand.normal(size=params.albedo.shape),
                               params.albedo.dtype),
            emission=jnp.asarray(rand.normal(size=params.emission.shape),
                                 params.emission.dtype))
        _, tangent = jax.jvp(loss_ad, (params,), (v,))
        dot = (jnp.sum(grad.albedo * v.albedo)
               + jnp.sum(grad.emission * v.emission))
        np.testing.assert_allclose(float(dot), float(tangent),
                                   rtol=rtol, atol=atol)
        results.append((float(dot), float(tangent)))
    return results
