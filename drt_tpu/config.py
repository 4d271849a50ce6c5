"""Render configuration.

The reference exposes width/height/samples/min-bounces/absorb-prob as CLI
flags (reference: src/args.hpp:19-67) and has *unbounded* recursion depth
terminated only by Russian roulette (reference: include/drt/pathtracer.hpp:121-136).
A wavefront needs a static trip count, so `max_depth` bounds the bounce
scan; with absorb prob a the truncated tail mass is <= (1-a)^(max_depth -
min_bounces), e.g. < 1e-9 relative at defaults with max_depth=32.
"""

from __future__ import annotations

import dataclasses

# Memory budget for a splitting config's per-chunk wavefront: half the
# device's memory limit where the device reports one, else this default.
DEFAULT_SPLIT_BYTES = 1 << 33


def max_split_bytes() -> int:
    """Bytes a bsdf_samples > 1 chunk may take: half of the first
    device's `bytes_limit` (the rest is the image, the backward and
    XLA's temporaries), or DEFAULT_SPLIT_BYTES if it reports none."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"]) // 2
    return DEFAULT_SPLIT_BYTES


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) configuration for the wavefront tracer.

    Defaults mirror the reference CLI defaults (src/args.hpp:24,32,40,48,56):
    640x480, 100 spp, min_bounces=1, absorb_prob=0.5.
    """

    width: int = 640
    height: int = 480
    spp: int = 100
    min_bounces: int = 1
    absorb_prob: float = 0.5
    max_depth: int = 32
    # Gradient mode of the radiative-backprop adjoint:
    #   biased=False  -> backward retraces with *fresh* RNG keys
    #                    (reference: include/drt/integrate.hpp:11-24,39-52)
    #   biased=True   -> backward replays the forward's keys; equals
    #                    autodiff of the forward estimator
    #                    (reference: include/drt/integrate.hpp:26-37)
    # The reference tracer hard-codes biased mode (pathtracer.hpp:111).
    unbiased: bool = False
    # Number of sample-per-pixel chunks rendered sequentially (lax.map) to
    # bound live wavefront memory on large renders. spp % spp_chunks == 0.
    spp_chunks: int = 1
    # n_samples of the reference's integration operator
    # (include/drt/integrate.hpp:56-66), split by where it acts. Both
    # knobs AVERAGE their n draws; the reference's integrate loops SUM
    # without 1/n (integrate.hpp:33-34) — a deliberate deviation
    # documented in drt_tpu/integrate.py (identical at n=1, the only
    # value the reference app instantiates).
    #   bsdf_samples    — BSDF samples drawn per path vertex in the
    #                     forward estimator (the scattering-integral
    #                     n_samples; the reference app instantiates 1,
    #                     pathtracer.hpp:111). XLA path only.
    #   adjoint_samples — fresh retraces averaged by the UNBIASED
    #                     backward (integrate.hpp:15-19 loops n_samples
    #                     independent draws); variance of the unbiased
    #                     gradient scales ~1/n. Ignored in biased mode
    #                     (the biased backward replays the forward's
    #                     single stream, integrate.hpp:26-37).
    bsdf_samples: int = 1
    adjoint_samples: int = 1

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0 or self.spp <= 0:
            raise ValueError("width, height and spp must be positive")
        if not 0.0 <= self.absorb_prob < 1.0:
            raise ValueError(
                f"absorb_prob must be in [0, 1): {self.absorb_prob} "
                "(1.0 would make the RR reweighting 1/(1-absorb) infinite)")
        if self.min_bounces < 0:
            raise ValueError("min_bounces must be >= 0")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive")
        if self.min_bounces > self.max_depth:
            raise ValueError(
                f"min_bounces ({self.min_bounces}) exceeds max_depth "
                f"({self.max_depth}): no Russian roulette would ever run "
                "and the truncation-tail bound does not hold")
        if self.spp_chunks <= 0 or self.spp % self.spp_chunks != 0:
            raise ValueError(
                f"spp_chunks ({self.spp_chunks}) must divide spp "
                f"({self.spp}) evenly")
        if self.bsdf_samples < 1 or self.adjoint_samples < 1:
            raise ValueError("bsdf_samples and adjoint_samples must be >= 1")
        if self.bsdf_samples > 1:
            # Per-vertex splitting materializes
            # bsdf_samples**(max_depth-1) leaf lanes per camera ray
            # (renderer.lane_count); at the default max_depth=32 even
            # bsdf_samples=2 means 2^31 lanes per ray. Catch it here,
            # before tracing tries to materialize the wavefront.
            lanes_per_ray = self.bsdf_samples ** (self.max_depth - 1)
            rays = self.width * self.height * (self.spp // self.spp_chunks)
            total = rays * lanes_per_ray
            # 64 B/lane wavefront carry + the backward's per-bounce
            # residuals (renderer.BounceResiduals: P, sc, gate, aid,
            # eid = 28 B/lane/bounce).
            bytes_per_lane = 64 + 28 * self.max_depth
            budget = max_split_bytes()
            if total * bytes_per_lane > budget:
                raise ValueError(
                    f"bsdf_samples={self.bsdf_samples} at max_depth="
                    f"{self.max_depth} expands each of the {rays} rays "
                    f"per chunk into bsdf_samples**(max_depth-1) = "
                    f"{lanes_per_ray} leaf lanes ({total:.3g} total; "
                    f"{total * bytes_per_lane:.3g} B of carry+residuals "
                    f"> budget {budget} B); lower max_depth / "
                    "bsdf_samples / resolution / spp, or raise "
                    "spp_chunks")


def headline_config(width: int = 640, height: int = 480, spp: int = 256,
                    spp_chunks: int = 16) -> RenderConfig:
    """The Cornell-box workload that bench.py and chip_smoke.py time
    (BASELINE.json config 2): depth 5, Russian roulette at 0.5 after
    bounce 1; smaller sizes for the parity and CPU runs."""
    return RenderConfig(width=width, height=height, spp=spp, max_depth=5,
                        min_bounces=1, absorb_prob=0.5,
                        spp_chunks=spp_chunks)
