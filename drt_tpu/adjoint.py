"""Radiative backpropagation as a `jax.custom_vjp`.

The reference differentiates radiance through a pointer-based autodiff tape
over 3-vectors (reference: include/drt/vector.hpp:120-318) whose backward
is a recursive DAG walk accumulating into parameter leaves
(vector.hpp:185-191, 281-284). Its MC integration operator either reuses
the forward's samples (biased mode, integrate.hpp:26-37) or re-draws fresh
samples at backward time and re-traces (unbiased mode / "radiative
backprop", integrate.hpp:11-24, 39-52).

Here: the forward saves NO per-bounce state — only
(params, rays, key). The backward *retraces* the wavefront (replaying the
forward's counter-based keys in biased mode; folding in a fresh salt in
unbiased mode), collects compact per-bounce residuals, and closes the
gradient analytically from the path-estimator factorization

    L_c = sum_b P_{b,c} e_{b,c},    w_{b,c} = albedo_{aid_b, c} * sc_b,

giving  dL_c/d e_{l,c}      = sum_b P_{b,c} [eid_b = l]
        dL_c/d albedo_{k,c} = sum_b P_{b,c} sc_b S_{b+1,c} [aid_b = k]

with the suffix radiance S computed by a reverse scan
S_b = gate_b * (e_b + w_b * S_{b+1}).  Per-bounce scatter-adds become
`segment_sum`s into the parameter pytree; under pjit/shard_map the partial
sums are psum'd across the mesh by the SPMD partitioner.

In biased mode this equals reverse-mode AD of the forward estimator
(verified against `jax.grad` in tests/test_adjoint.py); in unbiased mode it
is an independent unbiased estimate of the true gradient, matching the
semantics of the reference's `IntegrateBackward`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from drt_tpu.camera import Camera
from drt_tpu.config import RenderConfig
from drt_tpu.ops.vecmath import V3
from drt_tpu.renderer import (BWD_SALT, chunk_pixel_ids, chunk_rays,
                              lane_count, render_image, trace_rays)
from drt_tpu.scene import Params, Scene, albedo_table, emission_table


def _lane_cotangent(g, cfg: RenderConfig):
    """Expand a per-ray cotangent V3[N] to the splitting tracer's
    per-lane V3[N*M] (radiance is the lane MEAN, so each lane gets
    g/M). Identity at bsdf_samples == 1."""
    M = lane_count(cfg)
    if M == 1:
        return g
    inv = 1.0 / M
    return V3(jnp.repeat(g.x * inv, M), jnp.repeat(g.y * inv, M),
              jnp.repeat(g.z * inv, M))


def _param_grads(params: Params, scene: Scene, residuals, g, dtype) -> Params:
    """Close the gradient from per-bounce residuals via a reverse scan.

    g: V3 of f[N] per-ray cotangent. Scatter-adds run per channel over
    [N] arrays (no [N, 3] temporaries inside the scan).
    """
    from drt_tpu.ops.vecmath import V3, gatherv

    albedo_tab = albedo_table(scene, params).astype(dtype)  # [K+1, 3]
    emission_tab = emission_table(scene, params).astype(dtype)  # [L+1, 3]
    n_alb = albedo_tab.shape[0]  # K + 1 (ones sentinel)
    n_emit = emission_tab.shape[0]  # L + 1 (zeros sentinel)
    n_rays = g.x.shape[0]

    def segv(data: V3, ids, num) -> V3:
        """V3 of f[N] -> V3 of f[num] by segment id: `num` masked
        reductions per channel (the tables have a handful of rows)."""
        def seg1(c):
            return jnp.stack([jnp.sum(jnp.where(ids == k, c, 0))
                              for k in range(num)])
        return V3(seg1(data.x), seg1(data.y), seg1(data.z))

    def rev_body(carry, res_b):
        S, da, de = carry  # S = suffix radiance S_{b+1}, V3 of f[N]
        P, sc, gate, aid, eid = res_b
        e = gatherv(emission_tab, eid)
        gP = g * P
        de = de + segv(gP, eid, n_emit)
        da = da + segv(gP * sc * S, aid, n_alb)
        w = gatherv(albedo_tab, aid) * sc
        S = (e + w * S) * gate
        return (S, da, de), None

    S0 = V3.zeros((n_rays,), dtype)
    da0 = V3.zeros((n_alb,), dtype)
    de0 = V3.zeros((n_emit,), dtype)
    (S, da, de), _ = lax.scan(rev_body, (S0, da0, de0), residuals,
                              reverse=True)
    k = params.albedo.shape[0]
    l = params.emission.shape[0]
    return Params(albedo=da.to_array()[:k].astype(params.albedo.dtype),
                  emission=de.to_array()[:l].astype(params.emission.dtype))


def make_diff_renderer(scene: Scene, cfg: RenderConfig, use_tape: bool = False,
                       bwd_tape: bool = False):
    """Build the differentiable radiance estimator for a scene.

    Returns `f(params, orig, dir, rng) -> radiance f[N,3]` where `rng` is
    raw PRNG key data (`jax.random.key_data(key)`) — or, with
    `use_tape=True`, an injected uniform tape f[max_depth, N, 3] for the
    sample-matched parity harness. Differentiable in `params` via the
    radiative-backprop custom VJP; upstream cotangents flow per-ray.

    bwd_tape=True (requires use_tape=True and cfg.unbiased): the
    TAPE-DRIVEN unbiased mode — `f(params, orig, dir, tape_fwd,
    tape_bwd)` where the backward's fresh retrace (the reference's
    IntegrateBackward re-draws, integrate.hpp:11-24) consumes the
    SECOND injected tape instead of salted PRNG keys. With
    tape_bwd == tape_fwd this reduces exactly to the biased replay
    (integrate.hpp:26-37) — the sample-matched identity that pins the
    unbiased machinery's wiring (tests/test_adjoint.py).
    """
    if bwd_tape:
        if not (use_tape and cfg.unbiased):
            raise ValueError("bwd_tape requires use_tape=True and "
                             "cfg.unbiased=True")
        if cfg.bsdf_samples != 1:
            raise ValueError("bwd_tape mode is single-BSDF-sample only "
                             "(a 1-stream tape cannot drive a tree)")

        @jax.custom_vjp
        def diff_trace2(params, orig, dir, tape_f, tape_b):
            return trace_rays(params, scene, orig, dir, None, cfg,
                              tape=tape_f)

        def fwd2(params, orig, dir, tape_f, tape_b):
            return (diff_trace2(params, orig, dir, tape_f, tape_b),
                    (params, orig, dir, tape_f, tape_b))

        def bwd2(res, g):
            params, orig, dir, tape_f, tape_b = res
            # Fresh-sample adjoint sweep driven by the injected bwd tape.
            _, residuals = trace_rays(params, scene, orig, dir, None,
                                      cfg, tape=tape_b, collect=True)
            dparams = _param_grads(params, scene, residuals, g,
                                   orig.x.dtype)
            return (dparams, jax.tree.map(jnp.zeros_like, orig),
                    jax.tree.map(jnp.zeros_like, dir),
                    jnp.zeros_like(tape_f), jnp.zeros_like(tape_b))

        diff_trace2.defvjp(fwd2, bwd2)
        return diff_trace2

    @jax.custom_vjp
    def diff_trace(params, orig, dir, rng):
        return _forward(params, orig, dir, rng)

    def _forward(params, orig, dir, rng, collect=False):
        if use_tape:
            return trace_rays(params, scene, orig, dir, None, cfg,
                              tape=rng, collect=collect)
        key = jax.random.wrap_key_data(rng)
        return trace_rays(params, scene, orig, dir, key, cfg,
                          collect=collect)

    def fwd(params, orig, dir, rng):
        # Radiative backprop saves no path state — backward retraces.
        return _forward(params, orig, dir, rng), (params, orig, dir, rng)

    def bwd(res, g):
        params, orig, dir, rng = res
        g = _lane_cotangent(g, cfg)
        if cfg.unbiased and not use_tape:
            # Fresh-sample adjoint sweep (reference: integrate.hpp:11-24);
            # integrate.hpp:15-19 loops n_samples independent draws — the
            # adjoint_samples mean cuts unbiased-gradient variance ~1/n.
            key0 = jax.random.wrap_key_data(rng)

            def one_sample(s):
                bk = jax.random.fold_in(key0, BWD_SALT + s)
                _, residuals = _forward(params, orig, dir,
                                        jax.random.key_data(bk),
                                        collect=True)
                return _param_grads(params, scene, residuals, g,
                                    orig.x.dtype)

            if cfg.adjoint_samples == 1:
                dparams = one_sample(jnp.asarray(0))
            else:
                stacked = lax.map(one_sample,
                                  jnp.arange(cfg.adjoint_samples))
                dparams = jax.tree.map(lambda x: x.mean(0), stacked)
        else:
            # Replay the forward's samples (reference: integrate.hpp:26-37).
            _, residuals = _forward(params, orig, dir, rng, collect=True)
            dparams = _param_grads(params, scene, residuals, g,
                                   orig.x.dtype)
        d_orig = jax.tree.map(jnp.zeros_like, orig)
        d_dir = jax.tree.map(jnp.zeros_like, dir)
        if use_tape:
            d_rng = jnp.zeros_like(rng)
        else:
            d_rng = np.zeros(np.shape(rng), jax.dtypes.float0)
        return (dparams, d_orig, d_dir, d_rng)

    diff_trace.defvjp(fwd, bwd)
    return diff_trace


def make_diff_image_renderer(scene: Scene, cam: Camera, cfg: RenderConfig,
                             constrain=None):
    """Build `render(params, rng) -> image f[H,W,3]`, differentiable in
    params, with the spp-chunk loop INSIDE the custom VJP.

    This is the memory-correct composition: the forward stores only
    (params, rng) — true radiative backprop, nothing per-ray survives the
    forward — and the backward rebuilds each chunk's rays from the key,
    retraces, and accumulates parameter gradients chunk by chunk. Naively
    differentiating through the chunked `render_image` would instead stack
    per-chunk residuals across the whole sample budget.

    constrain: optional fn(x) applying a mesh sharding constraint to
    per-ray arrays (see drt_tpu.parallel.mesh.constrain_rays).
    """
    spp_c = cfg.spp // cfg.spp_chunks
    ident = constrain if constrain is not None else (lambda x: x)

    def _trace(p, o, d, k, collect=False):
        return trace_rays(p, scene, ident(o), ident(d), k, cfg,
                          collect=collect)

    @jax.custom_vjp
    def render(params, rng):
        key = jax.random.wrap_key_data(rng)
        return render_image(params, scene, cam, key, cfg,
                            trace_fn=lambda p, o, d, k: _trace(p, o, d, k))

    def fwd(params, rng):
        return render(params, rng), (params, rng)

    def bwd(res, g):
        params, rng = res
        key = jax.random.wrap_key_data(rng)
        dtype = cam.forward.dtype
        xy_rep = chunk_pixel_ids(cfg)
        # Per-ray cotangent: image = mean over chunks of (mean over spp_c
        # of radiance/pdf), so d radiance = g[pixel] / (spp_c * chunks * pdf).
        g_pix = (g / (spp_c * cfg.spp_chunks)).astype(dtype)

        from drt_tpu.ops.vecmath import V3
        # Per-channel [H, W] planes -> per-ray [N] gathers (no [N, 3]).
        g_planes = V3(g_pix[:, :, 0], g_pix[:, :, 1], g_pix[:, :, 2])

        def chunk_grads(chunk_idx):
            ck = jax.random.fold_in(key, chunk_idx)
            o, d, pdf = chunk_rays(cam, cfg, xy_rep, ck)
            yidx, xidx = xy_rep[:, 1], xy_rep[:, 0]
            g_ray = V3(*(ident(p[yidx, xidx] / pdf) for p in g_planes))
            g_ray = _lane_cotangent(g_ray, cfg)

            def one_sample(bk):
                _, residuals = _trace(params, o, d, bk, collect=True)
                return _param_grads(params, scene, residuals, g_ray, dtype)

            if not cfg.unbiased:
                return one_sample(ck)
            # integrate.hpp:15-19: average adjoint_samples fresh draws.
            if cfg.adjoint_samples == 1:
                return one_sample(jax.random.fold_in(ck, BWD_SALT))
            stacked = lax.map(
                lambda s: one_sample(jax.random.fold_in(ck, BWD_SALT + s)),
                jnp.arange(cfg.adjoint_samples))
            return jax.tree.map(lambda x: x.mean(0), stacked)

        if cfg.spp_chunks == 1:
            dparams = chunk_grads(jnp.asarray(0))
        else:
            stacked = lax.map(chunk_grads, jnp.arange(cfg.spp_chunks))
            dparams = jax.tree.map(lambda x: x.sum(0), stacked)
        return (dparams, np.zeros(np.shape(rng), jax.dtypes.float0))

    render.defvjp(fwd, bwd)
    return render
