"""Profiling & throughput counters (SURVEY.md §5 "Tracing / profiling").

The reference has no profiling at all. Here: `jax.profiler` trace capture
(Perfetto/TensorBoard-compatible), the one blocking timer (median of
runs) that bench.py, chip_smoke.py and the tools use, rays/s helpers,
and the card's name and power limit that every timing is printed with.
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace viewable in TensorBoard / Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timed(fn, *args, warmup: int = 1, reps: int = 5):
    """Median wall-clock of `reps` blocking runs of a jitted function
    after `warmup` runs (compilation included in the first). Returns
    (median_seconds, last_output)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), out


def rays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds


def mrays_per_second(n_rays: int, seconds: float) -> float:
    return n_rays / seconds / 1e6


def card_info() -> str:
    """`name, power.limit` of each GPU, one per line, as nvidia-smi
    reports them (a child process that stays off JAX). Every timing is
    reported beside it: a card set below its maximum power runs slower."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
