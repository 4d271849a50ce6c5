"""Fixed-depth wavefront path tracer over flat SoA ray state.

This replaces the reference's unbounded per-ray recursion
(reference: include/drt/pathtracer.hpp:121-136 `trace`, :91-115 `scatter`,
:72-89 `raycast`) with a `lax.scan` over bounces: every bounce intersects
the whole live wavefront, adds emission into a radiance accumulator, samples
the BxDF, and updates throughput. Dead rays (absorbed by Russian roulette,
missed, or carrying exactly-zero throughput) are masked, never branched on.

Per-path estimator identity (what the adjoint in drt_tpu/adjoint.py
differentiates analytically):

    L = sum_b P_b * e_b,   P_b = prod_{j<=b} gate_j * prod_{j<b} w_j

where gate_j is the Russian-roulette survival factor at bounce j
(1/(1-absorb) past min_bounces, 0 if absorbed/missed — reference:
pathtracer.hpp:128-133), w_j = albedo_j * s_j * cos_j / pdf_j is the
componentwise throughput factor (reference: pathtracer.hpp:97-111), and
e_b is the gathered emission (reference: pathtracer.hpp:113-114).

RNG: counter-based `jax.random` (threefry). Per-bounce uniforms come from
`fold_in(key, bounce)`; slot layout per ray is (rr, u1, u2), mirroring the
reference's per-vertex consumption order RR -> theta -> phi (SURVEY.md §3.2).
A `tape` argument injects recorded uniforms instead, for exact parity with
the reference's libc-rand stream (reference: random.hpp:7-10).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from drt_tpu.camera import Camera, camera_rays, pixel_grid
from drt_tpu.config import RenderConfig
from drt_tpu.constants import RAY_EPS
from drt_tpu.ops.bxdf import eval_scale, sample_bxdf
from drt_tpu.ops.intersect import intersect_scene
from drt_tpu.ops.vecmath import V3, dotv, gatherv, wherev
from drt_tpu.scene import Params, Scene, albedo_table, emission_table

# Key salts (arbitrary distinct constants) for independent streams.
CAMERA_SALT = 0x0CA3
BWD_SALT = 0x0ADD


class BounceResiduals(NamedTuple):
    """Per-bounce values stacked over depth, consumed by the adjoint.
    Scalarized SoA: P is a V3 of f[D, N] arrays, so every stacked buffer
    is rank-2 with the huge ray axis minor."""

    P: V3  # V3 of f[D, N]: emission weight (gated throughput prefix)
    sc: jnp.ndarray  # f[D, N] scalar factor s*cos/pdf so w = albedo[aid]*sc
    gate: jnp.ndarray  # f[D, N] RR/liveness gate at this bounce
    aid: jnp.ndarray  # i32[D, N] albedo row of this bounce's material
    eid: jnp.ndarray  # i32[D, N] emission row of this bounce's emitter


def _bounce(params_tabs, scene: Scene, cfg: RenderConfig, carry, b, u):
    """One wavefront bounce. carry = (o, d, T, L, alive).

    A ray dies only when absorbed by Russian roulette or on a miss — NOT
    when its throughput reaches zero: the reference keeps recursing with a
    zero BRDF value (e.g. after a null-BxDF emitter hit,
    pathtracer.hpp:17-35), and gradient parity requires it — a red->green
    wall sequence zeroes all throughput channels while per-channel
    gradients still flow through the continued path.
    """
    albedo_tab, emission_tab = params_tabs
    o, d, T, L, alive = carry  # o, d, T, L: V3 of f[N]
    n_emit = emission_tab.shape[0] - 1  # sentinel (zero) row index
    u_rr, u1, u2 = u

    # Russian roulette at path vertex depth b (reference: pathtracer.hpp:
    # 128-133): absorb with prob `absorb` once depth >= min_bounces;
    # survivors are compensated by 1/(1 - absorb).
    do_rr = b >= cfg.min_bounces
    absorbed = do_rr & (u_rr < cfg.absorb_prob)
    rr_scale = jnp.where(do_rr, 1.0 / (1.0 - cfg.absorb_prob), 1.0)
    alive = alive & ~absorbed

    # Nearest hit (reference: pathtracer.hpp:72-89).
    hit = intersect_scene(scene, o, d, emit_sentinel=n_emit)
    alive = alive & hit.valid
    gate = jnp.where(alive, rr_scale, 0.0).astype(u1.dtype)

    # Emission contribution at this vertex (reference: pathtracer.hpp:
    # 113-114); the RR divide applies to emission too (pathtracer.hpp:133).
    P = T * gate  # gate=0 masks dead rays; T is NaN-free
    e = gatherv(emission_tab, hit.emit)
    L = L + P * e

    # BxDF sample + eval (reference: pathtracer.hpp:91-111). dir_in is the
    # negated incoming ray direction (pathtracer.hpp:100-101, 106-109).
    mt = scene.mat_type[hit.mat]
    mex = scene.mat_exponent[hit.mat].astype(u1.dtype)
    aid = scene.mat_albedo[hit.mat]
    d_in = -d
    dir_out, pdf = sample_bxdf(mt, mex, hit.normal, d_in, u1, u2)
    s = eval_scale(mt, mex, hit.normal, d_in, dir_out)
    cos_t = dotv(hit.normal, dir_out)  # raw normal dot (pathtracer.hpp:103)
    # Sanitize the scalar factor for dead rays (their hit data is garbage
    # — inf/NaN from the miss) so NaN never enters throughput or, via
    # 0 * NaN, reverse-mode cotangents.
    # pdf > 0 guard: in f32, a specular u1 within ~(e+2)*2^-25 of 1
    # rounds cos(theta_h) to exactly 1, collapsing the half-vector pdf
    # (bxdf.hpp:117-118) to 0 -> 0/0. The true limit of s*cos/pdf there
    # is finite (~cos), so dropping the sample biases ~1e-6 on a
    # ~1e-6-probability set — vs NaN radiance. In f64 the guard never
    # fires (collapse needs u1 within 2^-48 of 1), so the reference
    # golden parity is untouched.
    sc = jnp.where(alive & (pdf > 0), s * cos_t / pdf, 0.0)
    a = gatherv(albedo_tab, aid)
    T_next = P * (a * sc)

    o_next = wherev(alive, hit.point + dir_out * RAY_EPS, 0.0)
    d_next = wherev(alive, dir_out, 0.0)

    new_carry = (o_next, d_next, T_next, L, alive)
    res = (P, sc, gate, aid, hit.emit)
    return new_carry, res


@partial(jax.jit, static_argnames=("cfg", "collect"))
def trace_rays(params: Params, scene: Scene, orig: jnp.ndarray,
               dir: jnp.ndarray, key, cfg: RenderConfig,
               tape: jnp.ndarray | None = None, collect: bool = False):
    """Trace a wavefront of rays to radiance.

    Args:
      params: differentiable shading parameters.
      scene: static scene arrays.
      orig, dir: V3 of f[N] primary rays (scalarized SoA).
      key: PRNG key for per-bounce sampling (ignored if `tape` given).
      cfg: static config (max_depth, min_bounces, absorb_prob, ...).
      tape: optional f[max_depth, 3, N] injected uniforms with slot layout
        (rr, u1, u2) per bounce — the sample-injection parity harness.
      collect: also return per-bounce `BounceResiduals` for the adjoint.

    Returns radiance as a V3 of f[N], or (radiance, BounceResiduals).

    bsdf_samples > 1 (the reference integration operator's n_samples,
    include/drt/integrate.hpp:56-66, drawn per path vertex by the
    scattering recursion pathtracer.hpp:91-111): the wavefront is
    expanded by per-vertex splitting into bsdf_samples^(max_depth-1)
    leaf lanes per ray — lanes sharing a digit prefix share that
    prefix's samples, so lane-averaging reproduces the recursive
    n-sample tree estimator exactly. Returned radiance is the per-ray
    lane average; with collect=True the residuals stay PER-LANE
    (f[D, N*M]) and the caller scales its cotangent by 1/M (see
    drt_tpu/adjoint.py). Key-driven only (a 1-stream tape cannot drive a
    branching tree).
    """
    dtype = orig.x.dtype
    n = orig.x.shape[0]
    albedo_tab = albedo_table(scene, params).astype(dtype)
    emission_tab = emission_table(scene, params).astype(dtype)

    if cfg.bsdf_samples > 1:
        if tape is not None:
            raise ValueError("bsdf_samples > 1 is key-driven only")
        return _trace_rays_splitting(
            (albedo_tab, emission_tab), scene, orig, dir, key, cfg,
            collect=collect)

    one = jnp.ones(n, dtype)
    zero = jnp.zeros(n, dtype)
    T0 = V3(one, one, one)
    L0 = V3(zero, zero, zero)
    alive0 = jnp.ones((n,), bool)

    def body(carry, xb):
        b = xb[0] if tape is not None else xb
        if tape is not None:
            u = (xb[1][0], xb[1][1], xb[1][2])
        else:
            u3 = jax.random.uniform(jax.random.fold_in(key, b), (3, n),
                                    dtype=dtype)
            u = (u3[0], u3[1], u3[2])
        return _bounce((albedo_tab, emission_tab), scene, cfg, carry, b, u)

    bounces = jnp.arange(cfg.max_depth)
    xs = (bounces, tape) if tape is not None else bounces
    (o, d, T, L, alive), res = lax.scan(
        body, (orig, dir, T0, L0, alive0), xs
    )
    if collect:
        return L, BounceResiduals(*res)
    return L


def lane_count(cfg: RenderConfig) -> int:
    """Leaf lanes per primary ray under per-vertex splitting: bounces
    0..max_depth-2 each branch bsdf_samples ways (the last bounce's
    sampled direction is never traced)."""
    return cfg.bsdf_samples ** max(cfg.max_depth - 1, 0)


def _trace_rays_splitting(tabs, scene: Scene, orig: V3, dir: V3, key,
                          cfg: RenderConfig, collect: bool = False):
    """n-sample-per-vertex tree estimator (integrate.hpp:56-66 semantics)
    as a flat wavefront over N*M leaf lanes, M = bsdf_samples^(D-1).

    Lane m encodes branch digits (j_1..j_{D-1}), j_1 most significant.
    The vertex reached at bounce b is determined by the first b digits,
    so its RR draw is indexed by prefix p_b = m // n^(D-1-b) while the
    bounce's (u1, u2) BSDF draw — which creates child j_{b+1} — is
    indexed by p_{b+1}. Lanes sharing a prefix therefore share exactly
    the samples the recursive tree shares, and the per-ray lane MEAN
    equals the tree estimator: vertex-b emission appears in n^(D-1-b)
    lanes, giving it weight n^(D-1-b)/n^(D-1) = n^-b — the product of b
    nested 1/n averages."""
    n_s = cfg.bsdf_samples
    D = cfg.max_depth
    M = lane_count(cfg)
    dtype = orig.x.dtype
    n = orig.x.shape[0]

    rep = lambda c: jnp.repeat(c, M)  # noqa: E731  ray-major lane expand
    o = V3(rep(orig.x), rep(orig.y), rep(orig.z))
    d = V3(rep(dir.x), rep(dir.y), rep(dir.z))
    nm = n * M
    one = jnp.ones(nm, dtype)
    zero = jnp.zeros(nm, dtype)
    carry = (o, d, V3(one, one, one), V3(zero, zero, zero),
             jnp.ones((nm,), bool))

    def draw(k, count, salt):
        """One uniform per (ray, prefix), broadcast to the M lanes."""
        u = jax.random.uniform(jax.random.fold_in(k, salt), (n, count),
                               dtype=dtype)
        return jnp.repeat(u, M // count, axis=1).reshape(-1)

    res_list = []
    for b in range(D):
        kb = jax.random.fold_in(key, b)
        u_rr = draw(kb, min(n_s ** b, M), 0)
        n_child = min(n_s ** (b + 1), M)
        u1 = draw(kb, n_child, 1)
        u2 = draw(kb, n_child, 2)
        carry, res = _bounce(tabs, scene, cfg, carry, b, (u_rr, u1, u2))
        res_list.append(res)

    L = carry[3]
    L_ray = V3(*(c.reshape(n, M).mean(axis=1) for c in L))
    if collect:
        residuals = jax.tree.map(lambda *xs: jnp.stack(xs), *res_list)
        return L_ray, BounceResiduals(*residuals)
    return L_ray


def chunk_pixel_ids(cfg: RenderConfig) -> jnp.ndarray:
    """i32[N_c, 2] pixel coordinates for one spp chunk (spp-major within a
    pixel, pixels in the reference's raster order)."""
    assert cfg.spp % cfg.spp_chunks == 0
    spp_c = cfg.spp // cfg.spp_chunks
    return jnp.repeat(pixel_grid(cfg.width, cfg.height), spp_c, axis=0)


def chunk_rays(cam: Camera, cfg: RenderConfig, xy_rep: jnp.ndarray,
               chunk_key):
    """Primary rays for one spp chunk (deterministic in chunk_key)."""
    n = xy_rep.shape[0]
    cam_u = jax.random.uniform(
        jax.random.fold_in(chunk_key, CAMERA_SALT), (n, 2),
        dtype=cam.forward.dtype)
    return camera_rays(cam, cfg.width, cfg.height, xy_rep, cam_u)


def render_image(params: Params, scene: Scene, cam: Camera, key,
                 cfg: RenderConfig, trace_fn=None) -> jnp.ndarray:
    """Render an image: mean over spp of per-sample radiance / camera pdf
    (reference main loop: src/render.cpp:72-87; camera pdf is 1).

    trace_fn: optional replacement for `trace_rays(params, orig, dir, key)`
    — with signature (params, orig, dir, key) -> f[N,3]. Memory is bounded
    by rendering `cfg.spp_chunks` sample chunks sequentially under
    `lax.map`.

    NOTE: do not differentiate through this function when spp_chunks > 1 —
    reverse-mode AD through the chunk loop stacks per-chunk residuals and
    defeats the chunking. Use `drt_tpu.adjoint.make_diff_image_renderer`,
    which keeps the chunk loop inside the custom VJP.
    """
    w, h = cfg.width, cfg.height
    spp_c = cfg.spp // cfg.spp_chunks
    xy_rep = chunk_pixel_ids(cfg)

    if trace_fn is None:
        def trace_fn(p, o, d, k):
            return trace_rays(p, scene, o, d, k, cfg)

    def render_chunk(chunk_idx):
        ck = jax.random.fold_in(key, chunk_idx)
        o, d, pdf = chunk_rays(cam, cfg, xy_rep, ck)
        radiance = trace_fn(params, o, d, ck) / pdf  # V3 of f[N]
        chans = [c.reshape(h, w, spp_c).mean(axis=2) for c in radiance]
        return jnp.stack(chans, axis=-1)

    if cfg.spp_chunks == 1:
        return render_chunk(jnp.asarray(0))
    images = lax.map(render_chunk, jnp.arange(cfg.spp_chunks))
    return images.mean(axis=0)
