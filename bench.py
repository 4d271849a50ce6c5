"""Benchmark: Cornell-box forward+backward throughput on one GPU.

Headline metric (BASELINE.json): Mrays/s per card, forward + radiative
backprop, Cornell box at 256 spp. A "ray" here is a camera path sample
(W*H*spp); each path traces up to `max_depth` bounces.

Production path: make_renderer(backend="auto"), which on a GPU is the
path kernel (drt_tpu/ops/pathkernel.py: camera generation, hash RNG and
the whole bounce loop per pixel block, with a stored-residual reverse
sweep for the backward). chip_smoke.py phase 6 times it against the XLA
wavefront on the same workload (drt_tpu.config.headline_config).

vs_baseline: ratio against the reference C++ renderer (single thread, -O3)
measured on this machine via the golden harness in fwd+bwd mode
(per-sample backward through its autodiff tape, src/render.cpp:79-80
semantics), scaled from a reduced-spp run (cost is linear in spp). If the
reference can't be built here, vs_baseline is null.

Needs a GPU; it refuses any other platform. Run: python bench.py
Prints exactly one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

from drt_tpu.config import headline_config

# BASELINE.json config 2: "full path tracing, depth-5, 256 spp".
HEADLINE = headline_config()
BASELINE_SPP = 2  # reference measured at reduced spp, scaled linearly


def measure_ours() -> dict:
    """Headline forward and forward+backward, median of 5 blocking runs,
    and the pipelined rate."""
    import jax
    import jax.numpy as jnp

    from drt_tpu.models import cbox
    from drt_tpu.parallel.render import make_renderer, resolve_backend
    from drt_tpu.utils.profiling import timed

    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = HEADLINE
    n_rays = cfg.width * cfg.height * cfg.spp
    fwd = make_renderer(scene, cfg, cam)
    fwdbwd = jax.jit(jax.value_and_grad(lambda p, k: fwd(p, k).sum()))
    key = jax.random.key(0)
    t_fwd, _ = timed(fwd, params, key)
    t_fwdbwd, _ = timed(fwdbwd, params, key)
    out = {"backend": resolve_backend(scene, cfg, None, "auto"),
           "fwd_mrays_s": n_rays / t_fwd / 1e6,
           "fwdbwd_mrays_s": n_rays / t_fwdbwd / 1e6,
           "t_fwd_s": t_fwd, "t_fwdbwd_s": t_fwdbwd}

    # Steady-state (pipelined) throughput: enqueue K steps, block once.
    # The blocking numbers above pay the host dispatch per step; a
    # training loop that does not synchronize per step runs at this rate.
    K = 10
    keys = [jax.random.key(100 + i) for i in range(K)]

    def time_pipelined(fn):
        jax.block_until_ready(fn(params, keys[0]))
        t0 = time.perf_counter()
        outs = [fn(params, k) for k in keys]
        jax.block_until_ready(outs)
        return (time.perf_counter() - t0) / K

    out["fwd_mrays_s_pipelined"] = n_rays / time_pipelined(fwd) / 1e6
    out["fwdbwd_mrays_s_pipelined"] = n_rays / time_pipelined(fwdbwd) / 1e6
    return out


def measure_extra_configs() -> dict:
    """BASELINE.json configs 1, 3, 4, 5 (config 2 is the headline) and
    the triangle-mesh legs.

    1: direct lighting (depth-2), 16 spp, forward Mrays/s.
    3: gradient check — radiative-backprop gradient image vs the
       forward-mode (dual-number) ground truth, max relative error.
    4: inverse rendering — steps/s and recovered-parameter max error.
    5: megapixel 2048x2048 fwd+bwd Mrays/s (~67M rays).
    mesh87 / mesh1280: icosphere meshes (87 and 1287 shapes) fwd+bwd
       through make_renderer, which routes them to the XLA wavefront.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp
    import optax

    from drt_tpu.config import RenderConfig
    from drt_tpu.gradcheck import grad_image, grad_image_fwd
    from drt_tpu.models import cbox
    from drt_tpu.optim import init_state, make_train_step
    from drt_tpu.parallel.render import make_renderer
    from drt_tpu.scene import Params
    from drt_tpu.utils.profiling import timed

    scene, params, cam = cbox.build(dtype=jnp.float32)
    out = {}
    W, H = HEADLINE.width, HEADLINE.height

    # Config 1: direct lighting (1 bounce => depth 2), 16 spp forward.
    cfg1 = dataclasses.replace(HEADLINE, spp=16, max_depth=2, spp_chunks=1)
    r1 = make_renderer(scene, cfg1, cam, differentiable=False)
    t1, _ = timed(r1, params, jax.random.key(0), reps=3)
    out["direct_16spp_fwd_mrays_s"] = round(W * H * 16 / t1 / 1e6, 3)

    # Config 3: gradient check (the reference's dual-number methodology).
    cfg3 = RenderConfig(width=64, height=48, spp=8, max_depth=4)
    key3 = jax.random.key(1)
    g_bp = np.asarray(grad_image(scene, cam, cfg3, params, key3,
                                 "albedo:0"))
    g_fw = np.asarray(grad_image_fwd(scene, cam, cfg3, params, key3,
                                     "albedo:0"))
    scale = max(np.abs(g_fw).max(), 1e-12)
    out["grad_image_max_rel_err"] = float(np.abs(g_bp - g_fw).max() / scale)

    # Config 4: inverse rendering (shortened): steps/s + recovered max err.
    cfg4 = RenderConfig(width=64, height=48, spp=32, max_depth=5)
    r4 = make_renderer(scene, cfg4, cam, differentiable=False)
    target = jax.block_until_ready(r4(params, jax.random.key(7)))
    init = Params(albedo=jnp.full_like(params.albedo, 0.25),
                  emission=jnp.full_like(params.emission, 0.5))
    opt = optax.adam(4e-2)
    step_fn = make_train_step(scene, cfg4, cam, target, opt)
    state = init_state(init, opt)
    state, _ = step_fn(state, jax.random.key(0))  # compile
    jax.block_until_ready(state)
    steps = 150
    t0 = time.perf_counter()
    for i in range(1, steps):
        state, _ = step_fn(state, jax.random.fold_in(jax.random.key(0), i))
    jax.block_until_ready(state)
    dt4 = time.perf_counter() - t0
    out["invert_steps_per_s"] = round((steps - 1) / dt4, 2)
    # Production form (cli invert default): K steps per dispatch via the
    # scanned block — bit-equal stream, ~K× fewer host dispatches.
    from drt_tpu.optim import make_train_block
    block_fn = make_train_block(scene, cfg4, cam, target, opt)
    bstate = init_state(init, opt)
    bstate, _ = block_fn(bstate, jax.random.key(0), 8)  # compile
    jax.block_until_ready(bstate)
    t0 = time.perf_counter()
    for _ in range((steps - 1) // 8):
        bstate, _ = block_fn(bstate, jax.random.key(0), 8)
    jax.block_until_ready(bstate)
    dt4b = time.perf_counter() - t0
    out["invert_steps_per_s_blocked8"] = round(
        ((steps - 1) // 8) * 8 / dt4b, 2)
    out["invert_albedo_max_err"] = float(
        np.abs(np.asarray(state.params.albedo)
               - np.asarray(params.albedo)).max())
    out["invert_emission_max_err"] = float(
        np.abs(np.asarray(state.params.emission)
               - np.asarray(params.emission)).max())

    # Config 5: megapixel 2048^2 fwd+bwd (67M rays/step).
    cfg5 = headline_config(2048, 2048, 16, spp_chunks=4)
    r5 = make_renderer(scene, cfg5, cam, differentiable=True)

    @jax.jit
    def fwdbwd5(p, key):
        return jax.value_and_grad(
            lambda pp: r5(pp, key).sum())(p)

    t5, _ = timed(fwdbwd5, params, jax.random.key(0), reps=3)
    out["megapixel_2048_fwdbwd_mrays_s"] = round(
        2048 * 2048 * 16 / t5 / 1e6, 3)

    # Framework extension: icosphere triangle meshes past the path
    # kernel's shape limit, through make_renderer (the XLA wavefront).
    from drt_tpu.models import gallery
    for tag, level, spp, chunks in (("mesh87", 1, 64, 4),
                                    ("mesh1280", 3, 16, 2)):
        scene_m, params_m, cam_m = gallery.build_mesh(level=level,
                                                      dtype=jnp.float32)
        cfg_m = headline_config(spp=spp, spp_chunks=chunks)
        rm = make_renderer(scene_m, cfg_m, cam_m)
        step_m = jax.jit(jax.value_and_grad(
            lambda pp, k, rm=rm: rm(pp, k).sum()))
        t_m, _ = timed(step_m, params_m, jax.random.key(0), reps=3)
        out[f"{tag}_fwdbwd_mrays_s"] = round(W * H * spp / t_m / 1e6, 2)
    return out


def measure_reference() -> float | None:
    """Reference fwd+bwd throughput in Mrays/s (camera samples), or None.

    Uses the render-loop wall time the harness now reports from INSIDE
    the binary (pixel loop only — no process spawn / tape generation /
    file IO)."""
    sys.path.insert(0, "tests")
    try:
        import golden_harness as gh
        if not gh.golden_available():
            return None
        gh.build()
        c = HEADLINE
        dt = min(gh.run(c.width, c.height, BASELINE_SPP,
                        min_bounces=c.min_bounces, absorb=c.absorb_prob,
                        grad=True, seed=s)["render_seconds"]
                 for s in (0, 1))
        return c.width * c.height * BASELINE_SPP / dt / 1e6
    except Exception:
        return None


def main() -> int:
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {device.platform!r})",
              file=sys.stderr)
        return 2
    from drt_tpu.utils.cache import enable_compile_cache
    from drt_tpu.utils.profiling import card_info

    enable_compile_cache()
    card = card_info()
    ours = measure_ours()
    extra = measure_extra_configs()
    ref = measure_reference()
    vs = (ours["fwdbwd_mrays_s"] / ref) if ref else None
    print(json.dumps({
        "metric": "cbox_640x480_256spp_depth5_fwdbwd_throughput",
        "value": round(ours["fwdbwd_mrays_s"], 3),
        "unit": "Mrays/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "device": {"platform": device.platform,
                   "kind": device.device_kind,
                   "count": len(jax.devices()), "card": card},
        "detail": {
            **{k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in ours.items() if k != "fwdbwd_mrays_s"},
            "reference_fwdbwd_mrays_s": round(ref, 4) if ref else None,
            **extra,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
