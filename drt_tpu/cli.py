"""Command-line renderer (the reference app's user surface).

Mirrors the reference CLI flags and defaults (reference: src/args.hpp:19-67
— width 640, height 480, samples 100, min-bounces 1, absorb-prob 0.5,
required output path) on the hard-coded sample scene (src/render.cpp:26-65),
plus framework extras: max depth, spp chunking, seed, PNG output,
gradient dumping, and the inverse-rendering subcommand.

Usage:
  python -m drt_tpu.cli render -o out.exr [-x W -y H -n SPP ...]
  python -m drt_tpu.cli invert -o recovered.json [--steps 200 ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _add_render_flags(p: argparse.ArgumentParser) -> None:
    # Reference flags (src/args.hpp:19-67).
    p.add_argument("-x", "--width", type=int, default=640)
    p.add_argument("-y", "--height", type=int, default=480)
    p.add_argument("-n", "--samples", type=int, default=100,
                   help="samples per pixel")
    p.add_argument("-b", "--min-bounces", type=int, default=1)
    p.add_argument("-p", "--absorb-prob", type=float, default=0.5)
    p.add_argument("-o", "--output", required=True)
    # Framework extras.
    p.add_argument("--max-depth", type=int, default=32)
    p.add_argument("--spp-chunks", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true",
                   help="trace in float64 (CPU validation mode)")
    p.add_argument("--backend", choices=("auto", "xla", "pathkernel"),
                   default="auto",
                   help="auto = the path kernel on a GPU for scenes it "
                        "bakes (<= 24 shapes, depth <= 32, biased, one "
                        "BSDF sample per vertex), the XLA wavefront "
                        "otherwise")
    p.add_argument("--unbiased", action="store_true",
                   help="unbiased gradient mode: the backward retraces "
                        "with fresh samples (integrate.hpp:39-52) instead "
                        "of replaying the forward's")
    p.add_argument("--adjoint-samples", type=int, default=1,
                   help="fresh retraces averaged by the unbiased backward "
                        "(integrate.hpp:15-19 n_samples)")
    p.add_argument("--bsdf-samples", type=int, default=1,
                   help="BSDF samples per path vertex in the forward "
                        "estimator (integrate.hpp:56-66 n_samples; "
                        "lanes are exponential in max_depth; runs on the "
                        "XLA wavefront)")


def _build(args):
    import jax.numpy as jnp

    from drt_tpu.config import RenderConfig
    from drt_tpu.models import cbox

    dtype = jnp.float64 if args.f64 else jnp.float32
    scene, params, cam = cbox.build(dtype=dtype)
    # Invalid combinations (spp % spp_chunks, absorb_prob >= 1, ...) are
    # rejected by RenderConfig.__post_init__ with a clear error.
    cfg = RenderConfig(width=args.width, height=args.height,
                       spp=args.samples, min_bounces=args.min_bounces,
                       absorb_prob=args.absorb_prob,
                       max_depth=args.max_depth,
                       spp_chunks=args.spp_chunks,
                       unbiased=getattr(args, "unbiased", False),
                       adjoint_samples=getattr(args, "adjoint_samples", 1),
                       bsdf_samples=getattr(args, "bsdf_samples", 1))
    return scene, params, cam, cfg


def _write(path: str, img: np.ndarray) -> None:
    from drt_tpu.utils.image import write_exr, write_png

    if path.endswith(".png"):
        write_png(path, img)
    else:
        write_exr(path, img)


def cmd_render(args) -> int:
    import jax

    from drt_tpu.parallel.render import make_renderer
    from drt_tpu.utils.profiling import mrays_per_second

    scene, params, cam, cfg = _build(args)
    render = make_renderer(scene, cfg, cam, differentiable=False,
                           backend=args.backend)
    key = jax.random.key(args.seed)
    t0 = time.time()
    img = render(params, key)
    img = np.asarray(jax.block_until_ready(img))
    dt = time.time() - t0
    _write(args.output, img)
    n_rays = cfg.width * cfg.height * cfg.spp
    print(f"rendered {cfg.width}x{cfg.height}x{cfg.spp}spp in {dt:.2f}s "
          f"({mrays_per_second(n_rays, dt):.2f} Mrays/s incl. compile) "
          f"-> {args.output}", file=sys.stderr)
    return 0


def cmd_grad(args) -> int:
    """Render + parameter gradients of the mean image intensity, through
    the production backend for the platform (the path kernel's sweep on
    a GPU; `--backend` applies to gradients, not just the forward)."""
    import jax

    from drt_tpu.parallel.render import make_renderer, resolve_backend

    scene, params, cam, cfg = _build(args)
    backend = resolve_backend(scene, cfg, None, args.backend)
    print(f"gradient backend: {backend}", file=sys.stderr)
    render = make_renderer(scene, cfg, cam, differentiable=True,
                           backend=backend)
    key = jax.random.key(args.seed)

    def loss(p):
        return render(p, key).mean()

    val, grads = jax.jit(jax.value_and_grad(loss))(params)
    out = {
        "mean_intensity": float(val),
        "d_albedo": np.asarray(grads.albedo).tolist(),
        "d_emission": np.asarray(grads.emission).tolist(),
        "backend": backend,
        "unbiased": cfg.unbiased,
    }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"gradients -> {args.output}", file=sys.stderr)
    return 0


def cmd_grad_image(args) -> int:
    """Per-pixel gradient image d(pixel)/d(param row) — the reference's
    headline validation artifact (README.md:138-145) — rendered BOTH by
    radiative backprop and by forward-mode AD (the dual-number ground
    truth), written side by side."""
    import jax

    from drt_tpu.gradcheck import grad_image, grad_image_fwd

    if args.backend not in ("auto", "xla"):
        # grad_image/grad_image_fwd compute the backprop-vs-jvp pair
        # through the XLA wavefront (the jvp ground truth has no kernel);
        # honoring --backend pathkernel here would silently lie.
        print("grad-image runs the XLA wavefront path (the jvp ground "
              "truth is XLA-only); use --backend auto/xla here, or "
              "`grad` for production-backend gradients", file=sys.stderr)
        return 2
    scene, params, cam, cfg = _build(args)
    key = jax.random.key(args.seed)
    g_bp = np.asarray(jax.jit(
        lambda p: grad_image(scene, cam, cfg, p, key, args.param))(params))
    g_fw = np.asarray(jax.jit(
        lambda p: grad_image_fwd(scene, cam, cfg, p, key,
                                 args.param))(params))
    diff = np.abs(g_bp - g_fw).max()
    scale = max(np.abs(g_fw).max(), 1e-12)

    def _write_pair(path, img):
        if path.endswith(".png"):
            # Signed map -> [0,1] around mid-gray for PNG preview.
            from drt_tpu.utils.image import write_png
            write_png(path, 0.5 + 0.5 * img / scale, gamma=1.0)
        else:
            _write(path, img)

    stem, ext = os.path.splitext(args.output)  # dir-safe: only the
    gt_path = f"{stem}-gt{ext}"                # basename's ext splits
    _write_pair(args.output, g_bp)
    _write_pair(gt_path, g_fw)
    print(f"grad image d(pixel)/d({args.param}) -> {args.output}; "
          f"jvp ground truth -> {gt_path}; "
          f"max |backprop - jvp| = {diff:.3e} (scale {scale:.3e})",
          file=sys.stderr)
    return 0


def cmd_invert(args) -> int:
    """Inverse rendering (BASELINE.json config 4): recover albedos +
    emission from a ground-truth render."""
    import jax
    import jax.numpy as jnp

    from drt_tpu.optim import inverse_render
    from drt_tpu.parallel.render import make_renderer
    from drt_tpu.scene import Params

    scene, params, cam, cfg = _build(args)
    render = make_renderer(scene, cfg, cam, differentiable=False,
                           backend=args.backend)
    target = render(params, jax.random.key(args.seed + 1))

    init = Params(albedo=jnp.full_like(params.albedo, 0.25),
                  emission=jnp.full_like(params.emission, 0.5))
    recovered, metrics = inverse_render(
        scene, cfg, cam, target, init, jax.random.key(args.seed),
        steps=args.steps, learning_rate=args.lr,
        log_every=args.log_every, backend=args.backend,
        checkpoint_dir=args.checkpoint_dir,
        metrics_jsonl=args.metrics_jsonl,
        steps_per_call=args.steps_per_call)
    out = {
        "true_albedo": np.asarray(params.albedo).tolist(),
        "recovered_albedo": np.asarray(recovered.albedo).tolist(),
        "true_emission": np.asarray(params.emission).tolist(),
        "recovered_emission": np.asarray(recovered.emission).tolist(),
        "final_loss": float(metrics["loss"][-1]),
    }
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    print(f"recovered params -> {args.output}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="drt_tpu")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="forward render the sample scene")
    _add_render_flags(pr)
    pr.set_defaults(fn=cmd_render)

    pg = sub.add_parser("grad", help="parameter gradients of mean intensity")
    _add_render_flags(pg)
    pg.set_defaults(fn=cmd_grad)

    pgi = sub.add_parser(
        "grad-image",
        help="per-pixel gradient image d(pixel)/d(param row), with the "
             "forward-mode (dual-number) ground-truth image beside it")
    _add_render_flags(pgi)
    pgi.add_argument("--param", default="albedo:0",
                     help="parameter row, e.g. albedo:0 or emission:0")
    pgi.set_defaults(fn=cmd_grad_image)

    pi = sub.add_parser("invert", help="inverse rendering recovery loop")
    _add_render_flags(pi)
    pi.add_argument("--steps", type=int, default=200)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--log-every", type=int, default=20)
    pi.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint dir (one .npz per saved step); "
                         "resumes from its latest step")
    pi.add_argument("--metrics-jsonl", default=None,
                    help="stream per-step metrics to this JSONL file")
    pi.add_argument("--steps-per-call", type=int, default=8,
                    help="optimizer steps per device dispatch (lax.scan "
                         "block; bit-equal to 1 — same fold_in stream)")
    pi.set_defaults(fn=cmd_invert)

    args = parser.parse_args(argv)
    from drt_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
