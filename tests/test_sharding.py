"""Multi-chip sharding on the virtual 8-device CPU mesh (SURVEY.md §4).

The renderer's scaling axes are pixel tiles x spp (SURVEY.md §2 table);
these tests assert that sharded execution is numerically identical to
single-device execution — same images, same psum'd parameter gradients —
and that the full sharded train step runs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from drt_tpu.adjoint import make_diff_image_renderer
from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.parallel.mesh import make_mesh, ray_sharding, replicated
from drt_tpu.parallel.render import make_renderer
from drt_tpu.renderer import render_image



@pytest.fixture(autouse=True)
def eight_devices():
    """Decided per test, never at import (xdist workers must collect the
    same tests): conftest provides 8 virtual CPU devices."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.fixture(scope="module")
def setup():
    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=16, height=12, spp=8, max_depth=6)
    return scene, params, cam, cfg


def test_sharded_render_matches_single_device(setup):
    scene, params, cam, cfg = setup
    key = jax.random.key(0)
    mesh = make_mesh()
    img_single = render_image(params, scene, cam, key, cfg)
    render = make_renderer(scene, cfg, cam, mesh=mesh, differentiable=False)
    img_sharded = render(params, key)
    np.testing.assert_allclose(np.asarray(img_sharded),
                               np.asarray(img_single), rtol=1e-6, atol=1e-7)


def test_sharded_grads_match_single_device(setup):
    scene, params, cam, cfg = setup
    rng = jax.random.key_data(jax.random.key(3))
    mesh = make_mesh()

    diff_single = make_diff_image_renderer(scene, cam, cfg)
    g_single = jax.jit(jax.grad(lambda p: diff_single(p, rng).sum()))(params)

    render_sharded = make_renderer(scene, cfg, cam, mesh=mesh,
                                   differentiable=True)
    g_sharded = jax.jit(jax.grad(
        lambda p: render_sharded(p, jax.random.wrap_key_data(rng)).sum()
    ))(params)
    np.testing.assert_allclose(np.asarray(g_sharded.albedo),
                               np.asarray(g_single.albedo),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_sharded.emission),
                               np.asarray(g_single.emission),
                               rtol=1e-5)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("tiles", "spp")
    mesh2 = make_mesh(shape=(8, 1))
    assert dict(mesh2.shape) == {"tiles": 8, "spp": 1}


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_uneven_ray_count_rejected(setup):
    scene, params, cam, _ = setup
    mesh = make_mesh()
    cfg = RenderConfig(width=3, height=3, spp=1, max_depth=2)
    with pytest.raises(ValueError, match="divide evenly"):
        make_renderer(scene, cfg, cam, mesh=mesh)


def test_backend_dispatch():
    """make_renderer backend selection: auto is the XLA wavefront off
    the GPU; the path kernel refuses a mesh."""
    import pytest

    from drt_tpu.models import cbox
    from drt_tpu.parallel.mesh import make_mesh
    from drt_tpu.parallel.render import make_renderer

    scene, params, cam = cbox.build(dtype=jnp.float32)
    cfg = RenderConfig(width=8, height=6, spp=2, max_depth=2)
    render = make_renderer(scene, cfg, cam, backend="auto")  # cpu -> xla
    img = render(params, jax.random.key(0))
    assert img.shape == (6, 8, 3)
    with pytest.raises(ValueError):
        make_renderer(scene, cfg, cam, mesh=make_mesh(),
                      backend="pathkernel", interpret=True)
