"""Where to set chip_smoke.py's phase-2 tolerances: the path kernel
against its XLA reference over several seeds, sound and with planted
faults, at 640x480x16spp on the card.

Each fault is applied to the kernel side only; the reference stays
sound. A bound belongs between the largest sound reading and the
smallest fault reading of its metric.

  python tools/parity_bounds.py [--seeds 8] [--out parity_bounds.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from drt_tpu.config import headline_config  # noqa: E402
from drt_tpu.models import cbox  # noqa: E402
from drt_tpu.scene import albedo_table, emission_table  # noqa: E402
from drt_tpu.utils.profiling import card_info  # noqa: E402

WIDTH, HEIGHT, SPP = 640, 480, 16  # chip_smoke.py phase 2's size
WHITE = 2  # cbox albedo row of the white walls (most paths hit them)


def _scaled(params, field, row, factor):
    arr = getattr(params, field)
    return params._replace(**{field: arr.at[row].multiply(factor)})


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(x.dtype)


def variants(params, cfg):
    """name -> (params for the kernel's tables, kernel cfg, output map)."""
    same = lambda out: out  # noqa: E731
    return {
        "sound": (params, cfg, same),
        "white albedo x1.01": (_scaled(params, "albedo", WHITE, 1.01), cfg,
                               same),
        "white albedo x1.001": (_scaled(params, "albedo", WHITE, 1.001),
                                cfg, same),
        "emission x0.999": (_scaled(params, "emission", 0, 0.999), cfg,
                            same),
        "one bounce short": (params, dataclasses.replace(
            cfg, max_depth=cfg.max_depth - 1), same),
        "roulette a bounce late": (params, dataclasses.replace(
            cfg, min_bounces=cfg.min_bounces + 1), same),
        "outputs rounded to bf16": (params, cfg,
                                    lambda out: tuple(map(_bf16, out))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--out", help="also write every reading to this JSON "
                    "file")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("parity_bounds: needs a GPU", file=sys.stderr)
        return 2
    card = card_info()
    print(card, flush=True)

    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = headline_config(WIDTH, HEIGHT, SPP, spp_chunks=1)
    reference = cs.parity_reference(scene, params, cam, cfg)
    runs = {}
    for name, (p, kcfg, post) in variants(params, cfg).items():
        kernel = cs.parity_kernel(scene, cam, kcfg)
        alb, emi = albedo_table(scene, p), emission_table(scene, p)
        rows = []
        for seed in range(1, args.seeds + 1):
            s, g = cs.parity_inputs(seed, WIDTH, HEIGHT)
            e = cs.parity_errors(post(kernel(alb, emi, s, g)),
                                 reference(s, g))
            rows.append({"seed": seed, **e})
        runs[name] = {
            "min_ok_fraction": min(r["ok_fraction"] for r in rows),
            "max_ok_fraction": max(r["ok_fraction"] for r in rows),
            "min_mean_abs": min(r["mean_abs"] for r in rows),
            "max_mean_abs": max(r["mean_abs"] for r in rows),
            "min_grad_rel": min(r["grad_rel"] for r in rows),
            "max_grad_rel": max(r["grad_rel"] for r in rows),
            "rows": rows}
        print(json.dumps({"variant": name, **{k: v for k, v in
                                              runs[name].items()
                                              if k != "rows"}}), flush=True)
    bounds = {"PIX_ATOL": cs.PIX_ATOL, "PIX_OK_FRACTION": cs.PIX_OK_FRACTION,
              "PIX_MEAN_ABS": cs.PIX_MEAN_ABS,
              "PARITY_GRAD_RTOL": cs.PARITY_GRAD_RTOL}
    sound = runs["sound"]
    sound_ok = (sound["min_ok_fraction"] >= cs.PIX_OK_FRACTION
                and sound["max_mean_abs"] <= cs.PIX_MEAN_ABS
                and sound["max_grad_rel"] <= cs.PARITY_GRAD_RTOL)
    caught = {name: [m for m, bad in (
        ("ok_fraction", r["max_ok_fraction"] < cs.PIX_OK_FRACTION),
        ("mean_abs", r["min_mean_abs"] > cs.PIX_MEAN_ABS),
        ("grad_rel", r["min_grad_rel"] > cs.PARITY_GRAD_RTOL)) if bad]
        for name, r in runs.items() if name != "sound"}
    print(json.dumps({"bounds": bounds, "sound_passes_every_seed": sound_ok,
                      "caught_on_every_seed_by": caught}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card,
                       "size": [WIDTH, HEIGHT, SPP],
                       "bounds": bounds, "sound_ok": sound_ok,
                       "caught": caught, "runs": runs}, f, indent=1)
    ok = sound_ok and all(caught.values())
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
