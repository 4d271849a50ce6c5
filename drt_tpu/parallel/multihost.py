"""Multi-host runtime: process groups, failure detection, elastic tiles.

The reference has no distributed anything (SURVEY.md §2/§5 — one OS
thread, src/render.cpp:72-86). The equivalents provided here:

- `initialize`: `jax.distributed.initialize` wrapper for multi-host
  process groups.
- `TileScheduler`: elastic, idempotent tile-based rendering. The image is
  split into independent pixel-tile jobs; each job is a pure function of
  (params, tile, seed), so a failed/preempted host's tiles can simply be
  re-dispatched — the renderer's natural unit of fault tolerance. Failure
  detection is by exception or non-finite output; `fault_rate` injects
  synthetic failures to exercise recovery (SURVEY.md §5 "fault-injection
  flag that drops a host's tiles").
- `heartbeat`: a tiny psum-based liveness collective — if a host dies,
  the collective raises on the survivors rather than hanging forever
  (bounded by the runtime's collective timeout), which is the failure
  signal for re-sharding/restart at the orchestration layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Start the multi-host runtime (no-op in single-process runs).

    Pass the three arguments explicitly (coordinator `host:port`,
    process count, this process's index); nothing detects them.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def heartbeat() -> int:
    """All-reduce a liveness counter across processes. Returns the number
    of participating processes. Raises (after the collective timeout) if
    a peer is gone — the detection signal for elastic recovery."""
    if jax.process_count() == 1:
        return 1
    # Exactly one marked device per process, so the global psum counts
    # processes directly — correct even with heterogeneous per-host
    # device counts.
    mark = jnp.asarray([1] + [0] * (jax.local_device_count() - 1),
                       jnp.int32)
    total = jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(mark)
    return int(np.asarray(total)[0])


@dataclasses.dataclass
class TileJob:
    index: int
    y0: int
    x0: int
    height: int
    width: int
    attempts: int = 0


class TileFailure(RuntimeError):
    pass


class TileScheduler:
    """Elastic tile-based render driver.

    render_tile(job, seed) -> f[th, tw, 3] must be pure and idempotent
    (same job + seed -> same tile), which makes re-dispatch after any
    failure trivially correct. Non-finite outputs and exceptions both
    count as failures; tiles are retried up to `max_attempts` times.
    """

    def __init__(self, width: int, height: int, tile: int = 128,
                 max_attempts: int = 3, fault_rate: float = 0.0,
                 fault_seed: int = 0):
        self.width = width
        self.height = height
        self.tile = tile
        self.max_attempts = max_attempts
        self.fault_rate = fault_rate
        self._fault_rng = np.random.default_rng(fault_seed)
        self.jobs = []
        idx = 0
        for y0 in range(0, height, tile):
            for x0 in range(0, width, tile):
                self.jobs.append(TileJob(
                    index=idx, y0=y0, x0=x0,
                    height=min(tile, height - y0),
                    width=min(tile, width - x0)))
                idx += 1
        self.retries = 0

    def run(self, render_tile: Callable[[TileJob, int], np.ndarray],
            seed: int = 0) -> np.ndarray:
        """Render all tiles, re-dispatching failures. Returns f[H,W,3]."""
        img = np.zeros((self.height, self.width, 3), np.float32)
        queue = list(self.jobs)
        while queue:
            job = queue.pop(0)
            job.attempts += 1
            try:
                if (self.fault_rate > 0.0 and job.attempts == 1
                        and self._fault_rng.uniform() < self.fault_rate):
                    raise TileFailure(
                        f"injected fault on tile {job.index}")
                out = np.asarray(render_tile(job, seed))
                if out.shape != (job.height, job.width, 3):
                    raise TileFailure(
                        f"tile {job.index}: bad shape {out.shape}")
                if not np.isfinite(out).all():
                    raise TileFailure(f"tile {job.index}: non-finite")
            except Exception:
                if job.attempts >= self.max_attempts:
                    raise
                self.retries += 1
                queue.append(job)
                continue
            img[job.y0:job.y0 + job.height,
                job.x0:job.x0 + job.width] = out
        return img

    def local_jobs(self, process_id: int | None = None,
                   process_count: int | None = None) -> list[TileJob]:
        """Static round-robin assignment of tiles to this host; the
        orchestration layer re-runs `run` over a dead peer's jobs."""
        pid = jax.process_index() if process_id is None else process_id
        n = jax.process_count() if process_count is None else process_count
        return [j for j in self.jobs if j.index % n == pid]


def make_tile_renderer(scene, cam, base_cfg, params, cam_u=None,
                       tape=None):
    """Build a `render_tile(job, seed)` for TileScheduler from the
    wavefront renderer: each tile is rendered as a sub-image with its own
    pixel grid offset (pure in (job, seed) -> idempotent re-dispatch).

    cam_u/tape: optional GLOBAL uniform arrays (f[N, 2] camera jitter,
    f[D, 3, N] bounce tape, N = W*H*spp in the monolithic raster
    pixel-major / spp-minor ray order). When given, each tile consumes
    its slice of the shared streams, so the tiled image equals the
    monolithic render EXACTLY (seed-matched decomposition) — per-ray
    randomness is a function of the global ray id, not of the tiling."""
    import jax.numpy as jnp2

    from drt_tpu.camera import camera_rays
    from drt_tpu.renderer import trace_rays

    spp = base_cfg.spp
    use_tape = tape is not None
    if use_tape != (cam_u is not None):
        raise ValueError("pass cam_u and tape together (or neither)")

    def render_tile(job: TileJob, seed: int) -> np.ndarray:
        ys, xs = np.mgrid[job.y0:job.y0 + job.height,
                          job.x0:job.x0 + job.width]
        pix = np.stack([xs.ravel(), ys.ravel()], -1)
        xy = jnp2.asarray(pix.repeat(spp, axis=0), jnp2.int32)
        n = xy.shape[0]
        if use_tape:
            # Global ray ids of this tile's rays (pixel-major, spp minor).
            gid = ((pix[:, 1] * base_cfg.width + pix[:, 0])[:, None] * spp
                   + np.arange(spp)).ravel()
            cu = cam_u[gid]
            tp = tape[:, :, gid]
            key = None
        else:
            key = jax.random.fold_in(jax.random.key(seed), job.index)
            cu = jax.random.uniform(jax.random.fold_in(key, 0), (n, 2),
                                    dtype=jnp2.float32)
            tp = None
        o, d, pdf = camera_rays(cam, base_cfg.width, base_cfg.height,
                                xy, cu)
        k = None if key is None else jax.random.fold_in(key, 1)
        L = trace_rays(params, scene, o, d, k, base_cfg, tape=tp)
        chans = [np.asarray(c / pdf).reshape(job.height, job.width, spp)
                 .mean(-1) for c in L]
        return np.stack(chans, -1)

    return render_tile
