"""Inverse rendering end-to-end (BASELINE.json config 4, shortened):
recover cbox albedos + emitter intensity from a ground-truth render."""

import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.optim import inverse_render
from drt_tpu.parallel.render import make_renderer
from drt_tpu.scene import Params


def test_recover_albedo_and_emission():
    scene, true_params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=24, height=18, spp=32, max_depth=6)
    render = make_renderer(scene, cfg, cam, differentiable=False)
    target = render(true_params, jax.random.key(100))

    init = Params(albedo=jnp.full_like(true_params.albedo, 0.25),
                  emission=jnp.full_like(true_params.emission, 0.5))
    recovered, metrics = inverse_render(
        scene, cfg, cam, target, init, jax.random.key(0), steps=200,
        learning_rate=4e-2)

    losses = np.asarray(metrics["loss"])
    # The paired dual-buffer loss bottoms out at the target's own MC noise
    # floor; assert substantial descent, then parameter recovery below.
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    # BASELINE-grade recovery (config 4): every albedo/emission channel
    # to 0.05 absolute (measured at this config: 0.042 / 0.004).
    np.testing.assert_allclose(np.asarray(recovered.albedo),
                               np.asarray(true_params.albedo), atol=0.05)
    np.testing.assert_allclose(np.asarray(recovered.emission),
                               np.asarray(true_params.emission), atol=0.05)


def test_checkpoint_resume_midloop(tmp_path):
    import optax
    from drt_tpu.optim import init_state, make_train_step
    from drt_tpu.utils import checkpoint

    scene, true_params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=4)
    render = make_renderer(scene, cfg, cam, differentiable=False)
    target = render(true_params, jax.random.key(5))
    opt = optax.adam(1e-2)
    step = make_train_step(scene, cfg, cam, target, opt)

    state = init_state(Params(albedo=true_params.albedo * 0.3,
                              emission=true_params.emission * 0.5), opt)
    key = jax.random.key(1)
    for i in range(3):
        state, _ = step(state, jax.random.fold_in(key, i))
    ckpt = str(tmp_path / "ck.npz")
    checkpoint.save(ckpt, state, key)

    # Continue 2 more steps from live state...
    cont = state
    for i in range(3, 5):
        cont, m_live = step(cont, jax.random.fold_in(key, i))
    # ...and from the restored checkpoint: must be identical.
    restored, rkey = checkpoint.restore(ckpt, state)
    for i in range(3, 5):
        restored, m_resumed = step(restored, jax.random.fold_in(rkey, i))
    np.testing.assert_allclose(np.asarray(cont.params.albedo),
                               np.asarray(restored.params.albedo))
    np.testing.assert_allclose(float(m_live["loss"]),
                               float(m_resumed["loss"]))
    assert int(restored.step) == 5


def test_train_block_bit_equals_single_steps():
    """The scanned multi-step block (make_train_block;
    'enqueue K, sync once') derives per-step keys in-device as
    fold_in(base_key, state.step) — the SAME threefry fold the host loop
    does — so K blocked steps must be bit-equal to K single steps."""
    import optax
    from drt_tpu.optim import init_state, make_train_block, make_train_step

    scene, true_params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=4)
    render = make_renderer(scene, cfg, cam, differentiable=False)
    target = render(true_params, jax.random.key(5))
    opt = optax.adam(1e-2)
    step = make_train_step(scene, cfg, cam, target, opt)
    block = make_train_block(scene, cfg, cam, target, opt)

    init = init_state(Params(albedo=true_params.albedo * 0.3,
                             emission=true_params.emission * 0.5), opt)
    key = jax.random.key(1)

    ref = init
    ref_losses = []
    for i in range(5):
        ref, m = step(ref, jax.random.fold_in(key, i))
        ref_losses.append(float(m["loss"]))

    got, m3 = block(init, key, 3)        # steps 0..2
    got, m2 = block(got, key, 2)         # steps 3..4 (uneven remainder)
    np.testing.assert_array_equal(np.asarray(got.params.albedo),
                                  np.asarray(ref.params.albedo))
    np.testing.assert_array_equal(np.asarray(got.params.emission),
                                  np.asarray(ref.params.emission))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(m3["loss"]), np.asarray(m2["loss"])]),
        np.asarray(ref_losses, np.float32))
    assert int(got.step) == 5


def test_inverse_render_steps_per_call_matches(tmp_path):
    """inverse_render(steps_per_call=4) == steps_per_call=1 bit-for-bit,
    including checkpoint placement (blocks shorten to land saves on the
    checkpoint_every boundary)."""
    scene, true_params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=8, height=6, spp=4, max_depth=4)
    render = make_renderer(scene, cfg, cam, differentiable=False)
    target = render(true_params, jax.random.key(5))
    init = Params(albedo=jnp.full_like(true_params.albedo, 0.25),
                  emission=jnp.full_like(true_params.emission, 0.5))

    kw = dict(steps=10, learning_rate=1e-2)
    p1, m1 = inverse_render(scene, cfg, cam, target, init,
                            jax.random.key(3), **kw)
    p4, m4 = inverse_render(scene, cfg, cam, target, init,
                            jax.random.key(3), steps_per_call=4, **kw)
    np.testing.assert_array_equal(np.asarray(p1.albedo),
                                  np.asarray(p4.albedo))
    np.testing.assert_array_equal(np.asarray(m1["loss"]),
                                  np.asarray(m4["loss"]))

    # Checkpointed run: saves land on the same steps as the unblocked
    # loop (boundary at 6 < steps_per_call stride).
    ck = str(tmp_path / "ck4")
    p4c, _ = inverse_render(scene, cfg, cam, target, init,
                            jax.random.key(3), steps_per_call=4,
                            checkpoint_dir=ck, checkpoint_every=6, **kw)
    np.testing.assert_array_equal(np.asarray(p4c.albedo),
                                  np.asarray(p4.albedo))
    saved = sorted(p.name for p in pathlib.Path(ck).iterdir())
    assert saved == ["step_00000006.npz", "step_00000010.npz"], saved


def test_checkpoint_latest_step_roundtrip(tmp_path):
    """npz checkpoints (SURVEY.md §5 "Checkpoint / resume"): one file per
    step, the latest step found by name, TrainState + RNG key restored."""
    import optax

    from drt_tpu.optim import TrainState, init_state
    from drt_tpu.utils import checkpoint

    params = Params(albedo=jnp.full((3, 3), 0.3),
                    emission=jnp.ones((1, 3)))
    opt = optax.adam(1e-2)
    state = init_state(params, opt)
    key = jax.random.key(42)
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None
    for step in (7, 12):
        st = TrainState(state.params, state.opt_state, jnp.asarray(step))
        checkpoint.save(str(checkpoint.step_path(d, step)), st, key)
    assert checkpoint.latest_step(d) == 12
    restored, rkey = checkpoint.restore(
        str(checkpoint.step_path(d, 12)), init_state(params, opt))
    assert int(restored.step) == 12
    np.testing.assert_array_equal(np.asarray(restored.params.albedo),
                                  np.asarray(params.albedo))
    assert (jax.random.key_data(rkey) == jax.random.key_data(key)).all()


@pytest.mark.parametrize("steps_per_call", [1, 4])
def test_inverse_render_resume_is_bit_exact(tmp_path, steps_per_call):
    """A run cut at a checkpoint and resumed from its directory ends
    bit-equal to the uninterrupted run."""
    scene, true_params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=8, height=6, spp=2, max_depth=3)
    render = make_renderer(scene, cfg, cam, differentiable=False)
    target = render(true_params, jax.random.key(5))
    init = Params(albedo=jnp.full_like(true_params.albedo, 0.25),
                  emission=jnp.full_like(true_params.emission, 0.5))
    kw = dict(learning_rate=1e-2, checkpoint_every=3,
              steps_per_call=steps_per_call)
    full, _ = inverse_render(scene, cfg, cam, target, init,
                             jax.random.key(3), steps=6,
                             checkpoint_dir=str(tmp_path / "a"), **kw)
    ck = str(tmp_path / "b")
    inverse_render(scene, cfg, cam, target, init, jax.random.key(3),
                   steps=3, checkpoint_dir=ck, **kw)
    resumed, m = inverse_render(scene, cfg, cam, target, init,
                                jax.random.key(3), steps=6,
                                checkpoint_dir=ck, **kw)
    assert np.asarray(m["loss"]).shape == (3,)  # only steps 3..5 ran
    np.testing.assert_array_equal(np.asarray(resumed.albedo),
                                  np.asarray(full.albedo))
    np.testing.assert_array_equal(np.asarray(resumed.emission),
                                  np.asarray(full.emission))
