"""Scaling benchmark: sharded-render throughput vs device count.

BASELINE.md asks for rays/s scaling efficiency from 1 device to N. This
tool measures the sharded XLA wavefront path over an N-device mesh:

  - on a host with several GPUs it measures real scaling over NVLink;
  - with --virtual N it runs on virtual CPU devices
    (XLA_FLAGS=--xla_force_host_platform_device_count=N), which validates
    the sharding/collective structure and reports *functional* scaling
    numbers (CPU "devices" share the same cores, so speedup is not
    expected — efficiency is meaningful only on real chips).

Prints one JSON line per device count plus a summary line with the
1 -> max-devices efficiency.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="device counts to measure (default: 1..all)")
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices (set before jax init)")
    ap.add_argument("-x", "--width", type=int, default=512)
    ap.add_argument("-y", "--height", type=int, default=384)
    ap.add_argument("-n", "--spp", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=4)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from drt_tpu.config import RenderConfig
    from drt_tpu.models import cbox
    from drt_tpu.parallel.mesh import make_mesh
    from drt_tpu.parallel.render import make_renderer

    n_dev = len(jax.devices())
    counts = args.devices or [c for c in (1, 2, 4, 8, 16, 32) if c <= n_dev]
    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth)
    n_rays = args.width * args.height * args.spp

    results = {}
    for c in counts:
        mesh = make_mesh(devices=jax.devices()[:c],
                         shape=(c, 1))
        render = make_renderer(scene, cfg, cam, mesh=mesh,
                               differentiable=True)

        def loss(p, key):
            return render(p, key).sum()

        step = jax.jit(jax.value_and_grad(loss))
        key = jax.random.key(0)
        jax.block_until_ready(step(params, key))  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(step(params, key))
            best = min(best, time.perf_counter() - t0)
        mrays = n_rays / best / 1e6
        results[c] = mrays
        print(json.dumps({"devices": c, "fwdbwd_mrays_s": round(mrays, 3),
                          "t_s": round(best, 4), "backend": "xla"}))

    lo, hi = min(results), max(results)
    eff = results[hi] / (results[lo] * (hi / lo)) if hi > lo else 1.0
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(eff, 3),
        "unit": f"fraction of linear {lo}->{hi} devices",
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "note": ("virtual CPU devices share cores; efficiency is "
                 "meaningful on real chips only"
                 if jax.devices()[0].platform == "cpu"
                 else "real devices"),
    }))


if __name__ == "__main__":
    sys.exit(main())
