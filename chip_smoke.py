"""Quickest proof that the renderer runs on the GPU, at full width.

Usage:
  python chip_smoke.py               # one card: phases 0-6
  python chip_smoke.py --devices 4   # four cards: the sharded phase only

Everything runs in this one JAX process (one process per card). Phases:
  0  environment: card name and power limit, JAX version, devices; any
     platform but "gpu" is refused; persistent compile cache.
  1  compile the headline Cornell-box forward and forward+backward steps
     (640x480, 256 spp, depth 5) and print their memory analyses; "auto"
     must pick the path kernel.
  2  the path kernel against the plain XLA reference (trace_rays fed the
     kernel's own hash draws; adjoint._param_grads for the gradients) at
     640x480, 16 spp.
  3  the main path: make_renderer("auto") forward and value_and_grad at
     the headline size; image semantics, finite positive gradients, peak
     device memory.
  4  inverse rendering: 16 Adam steps at 640x480x16spp, checkpointed;
     the loss falls and a resumed run is bit-exact.
  5  the XLA path on the card: the 87- and 1287-shape triangle meshes,
     forward+backward; time and peak device memory.
  6  path kernel against the XLA wavefront, median times of both.
  --devices N: sharded XLA forward+backward over a 2D mesh of N cards at
     2048x2048x16spp against the same render on one card.

Each phase is a function taking its sizes; the CPU tests run them at tiny
sizes with the kernel in the Pallas interpreter. The last line of stdout
is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

from drt_tpu.adjoint import _param_grads
from drt_tpu.camera import camera_rays, pixel_grid
from drt_tpu.config import RenderConfig, headline_config
from drt_tpu.fused import seeds_from_key
from drt_tpu.models import cbox, gallery
from drt_tpu.ops.pathkernel import hash_tapes, make_path_sweep, \
    make_path_tracer
from drt_tpu.ops.vecmath import V3
from drt_tpu.parallel.render import KERNEL, XLA, make_renderer, \
    resolve_backend
from drt_tpu.renderer import trace_rays
from drt_tpu.scene import Params, albedo_table, emission_table
from drt_tpu.utils.profiling import card_info, timed

# Kernel-vs-reference tolerances (phase 2), all f32. The two sides run
# the same paths on the same draws, but sums are taken in another order
# and the GPU contracts mul+add into FMA where XLA's code may not; a
# near-tie between two shapes' hit distances can then flip which one a
# path hits, which changes that whole path. So pixels are held to a
# tight bound except a small flipped share, and the mean absolute error
# bounds how much the flips may move the image. Each bound sits near
# the geometric mean of the worst sound reading seen and the
# mildest reading of planted faults (0.1 % albedo or emission errors, a
# path one bounce short, Russian roulette a bounce late, results rounded
# to bf16), read on an H100 at 640x480x16spp with tools/parity_bounds.py:
#   share of pixels off  sound <= 6.5e-6   faults >= 1.7e-2
#   mean |d|             sound <= 4.1e-7   faults >= 4.2e-6 (bf16)
#   grad err / max|grad| sound <= 7.0e-5   faults >= 8.3e-4 (albedo 0.1 %)
PIX_ATOL = 1e-4
PIX_OK_FRACTION = 0.999
PIX_MEAN_ABS = 1.5e-6
PARITY_GRAD_RTOL = 2.5e-4
# The seeds phase 2 checks (a seed keys the hash draws and the cotangent).
PARITY_SEEDS = (1, 2, 3)
# Sharded against one device: the same paths, only the sum order moves.
SHARD_GRAD_RTOL = 1e-4


def _peak_bytes(device=None) -> str:
    stats = (device or jax.devices()[0]).memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "not available"
    return f"{stats['peak_bytes_in_use'] / 2**30:.3f} GiB"


def _grad_step(render):
    return jax.jit(jax.value_and_grad(lambda p, k: render(p, k).mean()))


def phase_compile(cfg: RenderConfig, backend="auto", interpret=False):
    """Phase 1: lower and compile the forward and forward+backward steps;
    returns the backend "auto" resolved to."""
    scene, params, cam = cbox.build(dtype=jnp.float32)
    chosen = resolve_backend(scene, cfg, None, backend)
    render = make_renderer(scene, cfg, cam, backend=chosen,
                           interpret=interpret)
    key = jax.random.key(0)
    for name, fn in (("forward", render), ("forward+backward",
                                           _grad_step(render))):
        t0 = time.perf_counter()
        compiled = fn.lower(params, key).compile()
        print(f"phase 1 {name} [{chosen}] compiled in "
              f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
              f"{compiled.memory_analysis()}", flush=True)
    return chosen


def parity_kernel(scene, cam, cfg: RenderConfig, interpret=False):
    """The path kernel as one jitted function of (albedo table, emission
    table, seeds, cotangent g[H, W, 3]) -> (image, d albedo table,
    d emission table): forward with residuals, then the reverse sweep."""
    tracer = make_path_tracer(scene, cam, cfg, collect=True,
                              interpret=interpret)
    sweep = make_path_sweep(scene, cfg, interpret=interpret)

    @jax.jit
    def run(alb, emi, seeds, g):
        img, rsc, rbest = tracer(alb, emi, seeds)
        return (img, *sweep(alb, emi, rsc, rbest, g / cfg.spp))

    return run


def parity_reference(scene, params, cam, cfg: RenderConfig):
    """The plain XLA reference of `parity_kernel`, a jitted function of
    (seeds, g): trace_rays fed the kernel's own hash draws, and
    adjoint._param_grads for the gradients."""
    w, h, spp = cfg.width, cfg.height, cfg.spp
    npix = w * h

    @jax.jit
    def run(seeds, g):
        cam_u, tape = hash_tapes(seeds, npix, spp, cfg.max_depth,
                                 jnp.float32)
        xy = jnp.tile(pixel_grid(w, h), (spp, 1))
        o, d, _ = camera_rays(cam, w, h, xy, cam_u.T)
        L, res = trace_rays(params, scene, o, d, None, cfg, tape=tape,
                            collect=True)
        img = jnp.stack([c.reshape(spp, npix).mean(0) for c in L], -1)
        g_ray = V3(*(jnp.tile(g[:, :, c].reshape(-1), spp) / spp
                     for c in range(3)))
        grads = _param_grads(params, scene, res, g_ray, jnp.float32)
        return img.reshape(h, w, 3), grads.albedo, grads.emission

    return run


def parity_inputs(seed: int, width: int, height: int):
    """The kernel's seed pair and a random image cotangent for `seed`."""
    key = jax.random.key(seed)
    g = jax.random.uniform(jax.random.fold_in(key, 1), (height, width, 3),
                           jnp.float32)
    return seeds_from_key(key), g


def parity_errors(got, want) -> dict:
    """Errors of the kernel's (image, d albedo, d emission) against the
    reference's; table rows past the reference's parameters are padding."""
    img, da, de = (np.asarray(x) for x in got)
    ref, ra, re = (np.asarray(x) for x in want)
    err = np.abs(img - ref)
    grad_rel = max(float(np.abs(a[:len(b)] - b).max() / np.abs(b).max())
                   for a, b in ((da, ra), (de, re)))
    return {"ok_fraction": float((err.max(axis=-1) <= PIX_ATOL).mean()),
            "mean_abs": float(err.mean()), "grad_rel": grad_rel,
            "finite": bool(np.isfinite(img).all()),
            "image_mean": float(ref.mean())}


def phase_parity(width=640, height=480, spp=16, seeds=PARITY_SEEDS,
                 interpret=False):
    """Phase 2: kernel image and gradients against the XLA reference on
    the kernel's own draws, for each seed. Returns the worst errors."""
    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = headline_config(width, height, spp, spp_chunks=1)
    kernel = parity_kernel(scene, cam, cfg, interpret)
    reference = parity_reference(scene, params, cam, cfg)
    alb, emi = albedo_table(scene, params), emission_table(scene, params)
    rows = []
    for seed in seeds:
        s, g = parity_inputs(seed, width, height)
        e = parity_errors(kernel(alb, emi, s, g), reference(s, g))
        print(f"phase 2 parity {width}x{height}x{spp}spp seed {seed}: "
              f"pixels within {PIX_ATOL:g}: {e['ok_fraction']:.6f} (need "
              f">= {PIX_OK_FRACTION}); mean |d| {e['mean_abs']:.3e} (need "
              f"<= {PIX_MEAN_ABS:g}); max grad error / max |grad| "
              f"{e['grad_rel']:.3e} (need <= {PARITY_GRAD_RTOL:g}); image "
              f"mean {e['image_mean']:.5f}", flush=True)
        assert e["finite"], "non-finite kernel pixels"
        assert e["image_mean"] > 0, "reference image is black"
        rows.append(e)
    worst = {"ok_fraction": min(e["ok_fraction"] for e in rows),
             "mean_abs": max(e["mean_abs"] for e in rows),
             "grad_rel": max(e["grad_rel"] for e in rows)}
    assert worst["ok_fraction"] >= PIX_OK_FRACTION, worst
    assert worst["mean_abs"] <= PIX_MEAN_ABS, worst
    assert worst["grad_rel"] <= PARITY_GRAD_RTOL, worst
    return worst


def phase_main_path(cfg: RenderConfig, backend="auto", interpret=False,
                    reps=3):
    """Phase 3: forward, then value_and_grad `reps` times, through
    make_renderer at the given size; checks the image semantics."""
    scene, params, cam = cbox.build(dtype=jnp.float32)
    render = make_renderer(scene, cfg, cam, backend=backend,
                           interpret=interpret)
    img = np.asarray(jax.block_until_ready(render(params,
                                                  jax.random.key(0))))
    h, w = cfg.height, cfg.width
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    band = max(1, h // 8)
    top, bottom = img[:band].mean(), img[-band:].mean()
    left, right = img[:, : max(1, w // 4)], img[:, -max(1, w // 4):]
    # The reference camera mirrors x (drt_tpu/camera.py): the red wall
    # is on the image's left, the green wall on its right.
    assert top > bottom, (top, bottom)
    assert left[..., 0].mean() > left[..., 1].mean(), "left not red"
    assert right[..., 1].mean() > right[..., 0].mean(), "right not green"
    step = _grad_step(render)
    for i in range(reps):
        val, grads = jax.block_until_ready(step(params,
                                                jax.random.key(10 + i)))
        ga = np.asarray(grads.albedo)
        assert np.isfinite(ga).all() and np.isfinite(
            np.asarray(grads.emission)).all()
        assert (ga > 0).all(), ga
    print(f"phase 3 main path {w}x{h}x{cfg.spp}spp depth {cfg.max_depth} "
          f"[{resolve_backend(scene, cfg, None, backend)}]: image mean "
          f"{img.mean():.5f}, top/bottom {top:.4f}/{bottom:.4f}, "
          f"loss {float(val):.6f}, d albedo {ga.round(4).tolist()}; "
          f"peak device memory {_peak_bytes()}", flush=True)


def phase_invert(width=640, height=480, spp=16, steps=16,
                 steps_per_call=8, backend="auto"):
    """Phase 4: inverse rendering with checkpoints; a run resumed from
    its halfway checkpoint must end bit-equal to the uninterrupted one."""
    from drt_tpu.optim import inverse_render

    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = headline_config(width, height, spp, spp_chunks=1)
    target = make_renderer(scene, cfg, cam, differentiable=False,
                           backend=backend)(params, jax.random.key(1))
    init = Params(albedo=jnp.full_like(params.albedo, 0.25),
                  emission=jnp.full_like(params.emission, 0.5))
    kw = dict(learning_rate=2e-2, backend=backend,
              steps_per_call=steps_per_call, checkpoint_every=steps // 2)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        full, metrics = inverse_render(scene, cfg, cam, target, init,
                                       jax.random.key(3), steps=steps,
                                       checkpoint_dir=f"{tmp}/a", **kw)
        inverse_render(scene, cfg, cam, target, init, jax.random.key(3),
                       steps=steps // 2, checkpoint_dir=f"{tmp}/b", **kw)
        resumed, _ = inverse_render(scene, cfg, cam, target, init,
                                    jax.random.key(3), steps=steps,
                                    checkpoint_dir=f"{tmp}/b", **kw)
    loss = np.asarray(metrics["loss"])
    quarter = max(1, steps // 4)
    first, last = loss[:quarter].mean(), loss[-quarter:].mean()
    print(f"phase 4 inverse rendering {width}x{height}x{spp}spp, {steps} "
          f"steps in {time.perf_counter() - t0:.1f} s (three runs, "
          f"compile included): loss {first:.6g} -> {last:.6g}", flush=True)
    assert np.isfinite(loss).all() and last < first, loss
    np.testing.assert_array_equal(np.asarray(resumed.albedo),
                                  np.asarray(full.albedo))
    np.testing.assert_array_equal(np.asarray(resumed.emission),
                                  np.asarray(full.emission))


def phase_xla_meshes(width=640, height=480, runs=((1, 64, 4), (3, 16, 2)),
                     reps=3):
    """Phase 5: triangle meshes past the kernel's shape limit, forward+
    backward through "auto" (the XLA wavefront). runs: (icosphere level,
    spp, spp_chunks)."""
    for level, spp, chunks in runs:
        scene, params, cam = gallery.build_mesh(level=level,
                                                dtype=jnp.float32)
        cfg = headline_config(width, height, spp, spp_chunks=chunks)
        assert resolve_backend(scene, cfg, None, "auto") == XLA
        step = _grad_step(make_renderer(scene, cfg, cam))
        t0 = time.perf_counter()
        mem = step.lower(params, jax.random.key(0)).compile() \
            .memory_analysis()
        val, grads = jax.block_until_ready(step(params, jax.random.key(0)))
        t_first = time.perf_counter() - t0
        med, _ = timed(step, params, jax.random.key(0), reps=reps)
        assert np.isfinite(float(val))
        assert np.isfinite(np.asarray(grads.albedo)).all()
        n = width * height * spp
        print(f"phase 5 mesh {scene.num_shapes} shapes {width}x{height}x"
              f"{spp}spp fwd+bwd [xla]: first call {t_first:.2f} s, "
              f"median {med * 1e3:.1f} ms ({n / med / 1e6:.1f} Mpaths/s); "
              f"step temp memory {mem.temp_size_in_bytes / 2**30:.3f} GiB"
              f" (memory_analysis); process peak {_peak_bytes()}",
              flush=True)


def phase_timing(cfg: RenderConfig, card: str, reps=5):
    """Phase 6: median forward and forward+backward times of the path
    kernel and of the XLA wavefront on the headline config."""
    scene, params, cam = cbox.build(dtype=jnp.float32)
    key = jax.random.key(0)
    n = cfg.width * cfg.height * cfg.spp
    out = {}
    for backend in (KERNEL, XLA):
        render = make_renderer(scene, cfg, cam, backend=backend)
        t_f, _ = timed(render, params, key, reps=reps)
        t_b, _ = timed(_grad_step(render), params, key, reps=reps)
        out[backend] = (t_f, t_b)
        print(f"phase 6 {backend}: forward median {t_f * 1e3:.2f} ms "
              f"({n / t_f / 1e6:.1f} Mpaths/s), forward+backward median "
              f"{t_b * 1e3:.2f} ms ({n / t_b / 1e6:.1f} Mpaths/s); "
              f"{cfg.width}x{cfg.height}x{cfg.spp}spp depth "
              f"{cfg.max_depth}, {reps} runs; card {card}", flush=True)
    faster = (out[KERNEL][0] < out[XLA][0]
              and out[KERNEL][1] < out[XLA][1])
    print(f"phase 6 decision: path kernel "
          f"{'faster' if faster else 'NOT faster'} than xla in both "
          f"forward and forward+backward", flush=True)
    return out


def phase_sharded(n_devices=4, width=2048, height=2048, spp=16,
                  spp_chunks=4):
    """--devices N: sharded forward+backward over a 2D mesh of N devices
    against the same XLA render on one device; checks that the work is
    split over all N devices."""
    from drt_tpu.parallel.mesh import make_mesh

    devices = jax.devices()[:n_devices]
    assert len(devices) == n_devices, f"need {n_devices} devices"
    mesh = make_mesh(devices=devices)
    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = headline_config(width, height, spp, spp_chunks=spp_chunks)
    assert resolve_backend(scene, cfg, mesh, "auto") == XLA

    def step_of(render):
        def loss(p, k):
            img = render(p, k)
            return img.mean(), img
        return jax.jit(jax.value_and_grad(loss, has_aux=True))

    key = jax.random.key(4)
    sharded = step_of(make_renderer(scene, cfg, cam, mesh=mesh))
    hlo = sharded.lower(params, key).compile().as_text()
    t0 = time.perf_counter()
    (_, img_m), g_m = jax.block_until_ready(sharded(params, key))
    t_m = time.perf_counter() - t0
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices]
    peak_gib = [None if p is None else round(p / 2**30, 3) for p in peaks]
    with jax.default_device(devices[0]):
        single = step_of(make_renderer(scene, cfg, cam, backend=XLA))
        t0 = time.perf_counter()
        (_, img_s), g_s = jax.block_until_ready(single(params, key))
        t_s = time.perf_counter() - t0
    np.testing.assert_allclose(np.asarray(img_m), np.asarray(img_s),
                               rtol=1e-5, atol=1e-6)
    for a, b in ((g_m.albedo, g_s.albedo), (g_m.emission, g_s.emission)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=SHARD_GRAD_RTOL,
                                   atol=SHARD_GRAD_RTOL * np.abs(b).max())
    # The work is split: the step all-reduces partial gradients, and
    # (where devices report memory) every device held a similar share.
    assert "all-reduce" in hlo, "sharded step has no all-reduce"
    if all(p is not None for p in peaks):
        assert min(peaks) > 0.5 * max(peaks), peaks
    print(f"sharded {n_devices} devices mesh {dict(mesh.shape)} "
          f"{width}x{height}x{spp}spp fwd+bwd: image and gradients match "
          f"one device; first calls (compile included) {t_m:.1f} s sharded"
          f", {t_s:.1f} s single; peak GiB per device after the sharded "
          f"step {peak_gib}; image mean "
          f"{float(np.asarray(img_m).mean()):.5f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1 runs only the sharded phase over N cards")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform "
              f"{devices[0].platform!r}); refusing to run",
              file=sys.stderr)
        return 2
    from drt_tpu.utils.cache import enable_compile_cache

    card = card_info()
    print(card, flush=True)
    print(f"jax {jax.__version__}; devices {devices}; compile cache "
          f"{enable_compile_cache()}", flush=True)

    if args.devices > 1:
        phase_sharded(args.devices)
    else:
        cfg = headline_config()
        assert phase_compile(cfg) == KERNEL
        phase_parity()
        phase_main_path(cfg)
        phase_invert()
        phase_xla_meshes()
        phase_timing(cfg, card)

    print(card, flush=True)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
