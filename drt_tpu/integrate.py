"""The generic Monte-Carlo integration operator.

The reference's L2 public interface is one reusable function,
`integrate(forward, sampler, n_samples, unbiased)`
(reference: include/drt/integrate.hpp:56-66), applicable to ANY
integrand — the path tracer is merely its caller
(pathtracer.hpp:96-112). This module is the JAX equivalent, usable with
any differentiable integrand:

- biased (default): the estimate `mean_i f(params, x_i) / pdf(x_i)` is
  differentiated by replaying the SAME samples — plain AD through the
  estimator, the semantics of `integrate_biased` (integrate.hpp:26-37)
  where the tape reuses the forward's samples.
- unbiased: the primal value is the same estimate, but the backward
  draws `n_samples` FRESH samples and averages their parameter
  gradients (`internal::IntegrateBackward`, integrate.hpp:11-24 — the
  "Avoiding Bias" machinery, README.md:104-136). Expectation of the
  gradient equals the gradient of the expectation; the estimator's own
  sample noise no longer correlates forward and backward.

n_samples > 1 semantics: the reference's loops SUM `forward/pdf` over
n_samples with no 1/n (integrate.hpp:33-34 `r += ...`; same in
IntegrateBackward:15-18), so its value and gradient scale linearly
with n — a Monte-Carlo estimator of n * E[f/pdf]. This operator
DEFAULTS to the MEAN (the standard n-sample estimator of E[f/pdf],
and what the renderer's bsdf_samples / adjoint_samples knobs
implement), and offers `combine="sum"` for the reference's exact
accumulate-without-1/n semantics. At n_samples = 1 — the only value
the reference app ever instantiates (pathtracer.hpp:111) — all modes
coincide exactly, which is what the golden-parity suite pins.

The renderer's in-config knobs (`RenderConfig.unbiased`,
`bsdf_samples`, `adjoint_samples`) are this operator's semantics fused
into the wavefront and path-kernel paths; use this module when integrating
something else (test: tests/test_integrate.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BWD_SALT = 0x1A7E9


def integrate(forward, sampler, params, key, n_samples: int = 1,
              unbiased: bool = False, combine: str = "mean"):
    """MC estimate of `E[forward(params, x)/pdf(x)]`, differentiable in
    `params`.

    forward(params, sample) -> array/pytree value (differentiable in
      params). Matches the reference's `forward` functor
      (pathtracer.hpp:97-105).
    sampler(key) -> (sample, pdf). Matches `sampler`
      (pathtracer.hpp:106-109); pdf may be a scalar or broadcastable.
    n_samples: number of draws; in unbiased mode the backward also
      draws n_samples fresh samples (integrate.hpp:15-19).
    combine: "mean" (default) averages the draws — the standard
      n-sample estimator; "sum" accumulates without 1/n, the
      reference's exact loop semantics (integrate.hpp:33-34 and
      IntegrateBackward:15-19 both `+=` with no normalization).
      Identical at n_samples=1. See the module docstring.
    unbiased: see module docstring.
    """
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if combine not in ("mean", "sum"):
        raise ValueError("combine must be 'mean' or 'sum'")
    denom = n_samples if combine == "mean" else 1

    def estimate(p, k):
        def one(i):
            sample, pdf = sampler(jax.random.fold_in(k, i))
            v = forward(p, sample)
            return jax.tree.map(lambda x: x / pdf, v)

        vals = [one(i) for i in range(n_samples)]
        return jax.tree.map(lambda *xs: sum(xs) / denom, *vals)

    if not unbiased:
        # Biased: backward replays the forward's samples — plain AD
        # (integrate.hpp:26-37).
        return estimate(params, key)

    @jax.custom_vjp
    def est_u(p, k):
        return estimate(p, k)

    def fwd(p, k):
        return estimate(p, k), (p, k)

    def bwd(res, g):
        p, k = res
        bk = jax.random.fold_in(k, _BWD_SALT)
        # Fresh samples at backward time (integrate.hpp:11-24); the
        # n_samples loop of integrate.hpp:15-19 via fold_in(bk, i)
        # inside `estimate`.
        _, pullback = jax.vjp(lambda pp: estimate(pp, bk), p)
        (dp,) = pullback(g)
        return (dp, None)

    est_u.defvjp(fwd, bwd)
    return est_u(params, key)
