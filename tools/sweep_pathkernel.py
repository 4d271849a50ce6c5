"""Sweep the path kernel's block size and warp count on the card.

Times the headline Cornell-box render (640x480, 256 spp, depth 5)
forward and forward+backward through the path kernel for every
(BLOCK, NUM_WARPS) in {64, 128, 256, 512} x {2, 4, 8}, one process,
median of 5 blocking runs after a warm-up each. The winner is fixed as
the constants in drt_tpu/ops/pathkernel.py.

  python tools/sweep_pathkernel.py
"""

from __future__ import annotations

import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from drt_tpu.config import headline_config  # noqa: E402
from drt_tpu.models import cbox  # noqa: E402
from drt_tpu.ops import pathkernel  # noqa: E402
from drt_tpu.parallel.render import KERNEL, make_renderer  # noqa: E402
from drt_tpu.utils.cache import enable_compile_cache  # noqa: E402
from drt_tpu.utils.profiling import card_info, timed  # noqa: E402


def main() -> int:
    if jax.devices()[0].platform != "gpu":
        print("sweep_pathkernel: needs a GPU", file=sys.stderr)
        return 2
    enable_compile_cache()
    card = card_info()
    print(card, flush=True)
    scene, params, cam = cbox.build()
    cfg = headline_config()
    key = jax.random.key(0)
    rows = []
    for block, warps in itertools.product((64, 128, 256, 512), (2, 4, 8)):
        pathkernel.BLOCK, pathkernel.NUM_WARPS = block, warps
        render = make_renderer(scene, cfg, cam, backend=KERNEL)
        t_f, _ = timed(render, params, key)
        t_b, _ = timed(chip_smoke._grad_step(render), params, key)
        row = {"block": block, "num_warps": warps,
               "fwd_ms": round(t_f * 1e3, 3),
               "fwdbwd_ms": round(t_b * 1e3, 3), "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = min(rows, key=lambda r: r["fwdbwd_ms"])
    print(json.dumps({"best_fwdbwd": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
