"""Inverse rendering: recover scene parameters from a target image.

The reference only *documents* gradient-based recovery (the backward call
is present but commented out, src/render.cpp:79-80); this module is the
full loop the framework's north star requires: Adam over albedo/emission
against a ground-truth render (BASELINE.json config 4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from drt_tpu.camera import Camera
from drt_tpu.config import RenderConfig
from drt_tpu.parallel.render import make_renderer
from drt_tpu.scene import Params, Scene


class TrainState(NamedTuple):
    params: Params
    opt_state: optax.OptState
    step: jnp.ndarray  # i32[]


def make_train_step(scene: Scene, cfg: RenderConfig, cam: Camera,
                    target: jnp.ndarray, optimizer: optax.GradientTransformation,
                    mesh=None, paired: bool = True, backend: str = "auto"):
    """Build `(state, key) -> (state, metrics)` — one Adam step on the
    L2 image loss, differentiated through radiative backprop.

    paired=True uses the dual-buffer loss E[(X1-T)(X2-T)] with two
    independent renders per step: a plain MC-MSE loss E[(X-T)^2] also
    penalizes Var(X), which biases recovered albedos *down* at finite spp
    (observed: 0.2 recovered vs 0.5 true at 16 spp); the paired product is
    an unbiased estimator of the true expected-image loss.
    """
    body = _make_step_body(scene, cfg, cam, target, optimizer, mesh=mesh,
                           paired=paired, backend=backend)
    return jax.jit(body)


def _make_step_body(scene: Scene, cfg: RenderConfig, cam: Camera,
                    target: jnp.ndarray, optimizer, mesh=None,
                    paired: bool = True, backend: str = "auto"):
    """The un-jitted `(state, key) -> (state, metrics)` step body shared
    by the single-step fn and the scanned multi-step blocks."""
    render = make_renderer(scene, cfg, cam, mesh=mesh, differentiable=True,
                           backend=backend)

    def loss_fn(params, key):
        if paired:
            img1 = render(params, jax.random.fold_in(key, 0))
            img2 = render(params, jax.random.fold_in(key, 1))
            return jnp.mean((img1 - target) * (img2 - target))
        img = render(params, key)
        return jnp.mean((img - target) ** 2)

    def step(state: TrainState, key):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, key)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        # Albedo/emission are physically non-negative; albedo <= 1 for
        # energy conservation (the reference never constrains, but its
        # sample params live in [0, 1] — src/render.cpp:26-29).
        params = Params(albedo=jnp.clip(params.albedo, 0.0, 1.0),
                        emission=jnp.maximum(params.emission, 0.0))
        grad_norm = optax.global_norm(grads)
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss, "grad_norm": grad_norm}

    return step


def make_train_block(scene: Scene, cfg: RenderConfig, cam: Camera,
                     target: jnp.ndarray,
                     optimizer: optax.GradientTransformation,
                     mesh=None, paired: bool = True,
                     backend: str = "auto"):
    """Build `run(state, base_key, length) -> (state, stacked_metrics)`:
    `length` optimizer steps as ONE device dispatch (a lax.scan inside
    one jit), with the per-step key derived IN-device as
    `fold_in(base_key, state.step)` — bit-equal to `length` calls of the
    single-step fn with host-side `fold_in(key, i)` (threefry is the
    same function either side of the trace). Where per-dispatch latency
    rivals the device step time this is the train loop's 'enqueue K,
    sync once' form: ~K× fewer dispatches. The reference analogue being beaten is the serial
    per-step host loop, src/render.cpp:72-86."""
    body = _make_step_body(scene, cfg, cam, target, optimizer, mesh=mesh,
                           paired=paired, backend=backend)
    jitted: dict[int, object] = {}  # one compiled scan per block length

    def _block(length: int):
        def run(state: TrainState, key):
            def scan_body(st, _):
                st2, metrics = body(st, jax.random.fold_in(key, st.step))
                return st2, metrics
            return jax.lax.scan(scan_body, state, None, length=length)

        return jax.jit(run)

    def run(state: TrainState, key, length: int):
        fn = jitted.get(length)
        if fn is None:
            fn = jitted[length] = _block(int(length))
        return fn(state, key)

    return run


def init_state(params: Params, optimizer) -> TrainState:
    return TrainState(params, optimizer.init(params), jnp.asarray(0))


def inverse_render(scene: Scene, cfg: RenderConfig, cam: Camera,
                   target: jnp.ndarray, init_params: Params, key,
                   steps: int = 200, learning_rate: float = 2e-2,
                   mesh=None, log_every: int = 0, logger=None,
                   backend: str = "auto", checkpoint_dir: str | None = None,
                   checkpoint_every: int = 50,
                   metrics_jsonl: str | None = None,
                   steps_per_call: int = 1):
    """Run the recovery loop (BASELINE.json config 4). Returns
    (final params, per-step metrics dict of stacked arrays).

    checkpoint_dir: if given, resumes from the latest checkpoint there
    (params + Adam moments + RNG key + step — SURVEY.md §5; one .npz
    file per saved step) and saves every `checkpoint_every` steps.
    metrics_jsonl: if given, per-step metrics stream to this JSONL file.
    steps_per_call: optimizer steps per device dispatch (a lax.scan
    block, make_train_block). Bit-equal to 1 (same fold_in stream);
    blocks shorten automatically so checkpoints still land exactly on
    `checkpoint_every` boundaries.
    """
    from drt_tpu.utils.logging import MetricsLogger

    optimizer = optax.adam(learning_rate)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if steps_per_call > 1:
        block_fn = make_train_block(scene, cfg, cam, target, optimizer,
                                    mesh=mesh, backend=backend)
    else:
        step_fn = make_train_step(scene, cfg, cam, target, optimizer,
                                  mesh=mesh, backend=backend)
    state = init_state(init_params, optimizer)
    start = 0
    if checkpoint_dir is not None:
        from drt_tpu.utils import checkpoint
        last = checkpoint.latest_step(checkpoint_dir)
        if last is not None:
            state, key = checkpoint.restore(
                str(checkpoint.step_path(checkpoint_dir, last)), state)
            start = last

    mlog = MetricsLogger(metrics_jsonl) if metrics_jsonl else None
    losses, grad_norms = [], []

    def _after(i, loss_i, gn_i):
        losses.append(loss_i)
        grad_norms.append(gn_i)
        if log_every and (i % log_every == 0 or i == steps - 1):
            if mlog:
                mlog.log(i, loss=loss_i, grad_norm=gn_i)
            else:
                (logger or print)(f"step {i:4d} loss {float(loss_i):.6g}")

    i = start
    while i < steps:
        if steps_per_call > 1:
            n = steps - i
            if checkpoint_dir is not None and checkpoint_every:
                # Shorten the block so the save still lands exactly on
                # the checkpoint_every boundary (bit-exact resume).
                n = min(n, checkpoint_every - (i % checkpoint_every))
            n = min(n, steps_per_call)
            state, metrics = block_fn(state, key, n)
            for j in range(n):
                _after(i + j, metrics["loss"][j], metrics["grad_norm"][j])
            i += n
        else:
            state, metrics = step_fn(state, jax.random.fold_in(key, i))
            _after(i, metrics["loss"], metrics["grad_norm"])
            i += 1
        if (checkpoint_dir is not None and checkpoint_every
                and (i % checkpoint_every == 0 or i == steps)):
            checkpoint.save(str(checkpoint.step_path(checkpoint_dir, i)),
                            state, key)
    if mlog:
        mlog.close()
    if not losses:  # fully resumed past `steps`
        return state.params, {"loss": jnp.zeros(0), "grad_norm": jnp.zeros(0)}
    return state.params, {
        "loss": jnp.stack(losses),
        "grad_norm": jnp.stack(grad_norms),
    }
