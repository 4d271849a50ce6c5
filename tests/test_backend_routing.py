"""resolve_backend / make_renderer routing (parallel/render.py).

The GPU branch is exercised by monkeypatching the platform probe — the
decision is pure Python over static config/scene facts and the device's
memory limit, so this validates exactly what runs on a card.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from drt_tpu.config import RenderConfig
from drt_tpu.models import cbox
from drt_tpu.parallel import render as prender
from drt_tpu.parallel.mesh import make_mesh

HEADLINE = RenderConfig(width=640, height=480, spp=256, max_depth=5,
                        spp_chunks=16)


@pytest.fixture
def gpu(monkeypatch):
    monkeypatch.setattr(prender, "_platform", lambda: "gpu")
    # An 80 GB card at JAX's default 75 % memory fraction.
    monkeypatch.setattr(prender, "_bytes_limit", lambda: 60 << 30)


@pytest.fixture
def cbox_scene():
    scene, params, cam = cbox.build(dtype=jnp.float32)
    return scene


def _resized_scene(base, n):
    return base._replace(
        shape_type=jnp.zeros(n, jnp.int32),
        shape_geo=jnp.zeros((n, base.shape_geo.shape[1]), jnp.float32),
        shape_mat=jnp.zeros(n, jnp.int32),
        shape_emit=jnp.zeros(n, jnp.int32))


def test_cpu_resolves_xla(cbox_scene):
    assert prender.resolve_backend(cbox_scene, HEADLINE, None,
                                   "auto") == "xla"


@pytest.mark.parametrize("name", ["xla", "pathkernel"])
def test_explicit_backend_passthrough(cbox_scene, name):
    assert prender.resolve_backend(cbox_scene, RenderConfig(), None,
                                   name) == name


@pytest.mark.parametrize("name", ["pallas", "pallas-dyn", "cuda", "XLA"])
def test_unknown_backend_raises(cbox_scene, name):
    with pytest.raises(ValueError, match="unknown backend"):
        prender.resolve_backend(cbox_scene, RenderConfig(), None, name)


def test_gpu_single_device_picks_kernel(gpu, cbox_scene):
    assert prender.resolve_backend(cbox_scene, HEADLINE, None,
                                   "auto") == "pathkernel"


def test_gpu_24_shapes_still_kernel(gpu, cbox_scene):
    assert prender.resolve_backend(_resized_scene(cbox_scene, 24),
                                   HEADLINE, None, "auto") == "pathkernel"


def _unfit(cbox_scene, case):
    """(scene, cfg, mesh) that the path kernel should not render."""
    scene, cfg, mesh = cbox_scene, HEADLINE, None
    if case == "f64":
        scene = cbox.build(dtype=jnp.float64)[0]
    elif case == "deep":
        cfg = dataclasses.replace(cfg, max_depth=33)
    elif case == "shapes":
        scene = _resized_scene(cbox_scene, 25)
    elif case == "unbiased":
        cfg = dataclasses.replace(cfg, unbiased=True)
    elif case == "bsdf_samples":
        cfg = RenderConfig(width=64, height=48, spp=4, max_depth=5,
                           bsdf_samples=2)
    elif case == "mesh":
        mesh = make_mesh(shape=(len(jax.devices()), 1))
    elif case == "residuals":
        # 2048^2 x 1024 spp x depth 5 stores 172 GB of residuals.
        cfg = RenderConfig(width=2048, height=2048, spp=1024, max_depth=5)
    return scene, cfg, mesh


@pytest.mark.parametrize("case", ["f64", "deep", "shapes", "unbiased",
                                  "bsdf_samples", "mesh", "residuals"])
def test_gpu_falls_back_to_xla(gpu, cbox_scene, case):
    scene, cfg, mesh = _unfit(cbox_scene, case)
    assert prender.resolve_backend(scene, cfg, mesh, "auto") == "xla"


@pytest.mark.parametrize("case,match", [
    ("f64", "f32 scenes"), ("deep", "at most 32 bounces"),
    ("shapes", "at most 24 shapes"), ("unbiased", "biased"),
    ("bsdf_samples", "biased"), ("mesh", "one device")])
def test_explicit_kernel_outside_its_limits_raises(gpu, cbox_scene, case,
                                                   match):
    """Asked for by name, the kernel refuses what auto would route to
    XLA (except the memory budget, which only steers auto)."""
    scene, cfg, mesh = _unfit(cbox_scene, case)
    cam = cbox.build(dtype=jnp.float32)[2]
    with pytest.raises(ValueError, match=match):
        prender.make_renderer(scene, cfg, cam, mesh=mesh,
                              backend="pathkernel", interpret=True)


def test_kernel_off_gpu_without_interpret_raises(cbox_scene):
    scene, params, cam = cbox.build(dtype=jnp.float32)
    with pytest.raises(ValueError, match="GPU only"):
        prender.make_renderer(scene, RenderConfig(width=8, height=8, spp=1,
                                                  max_depth=2), cam,
                              backend="pathkernel")


def test_kernel_with_mesh_raises(cbox_scene):
    scene, params, cam = cbox.build(dtype=jnp.float32)
    with pytest.raises(ValueError, match="one device"):
        prender.make_renderer(scene, RenderConfig(width=8, height=8, spp=8,
                                                  max_depth=2), cam,
                              mesh=make_mesh(), backend="pathkernel",
                              interpret=True)


def test_kernel_in_interpreter_renders(cbox_scene):
    scene, params, cam = cbox.build(dtype=jnp.float32)
    render = prender.make_renderer(
        scene, RenderConfig(width=8, height=8, spp=2, max_depth=3), cam,
        backend="pathkernel", interpret=True)
    img = np.asarray(render(params, jax.random.key(0)))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.mean() > 0


def test_auto_on_gpu_builds_kernel_renderer(gpu, monkeypatch, cbox_scene):
    """make_renderer(auto) on a GPU wires the kernel renderer (built in
    the interpreter here, since this host has no card)."""
    import drt_tpu.fused as fused

    built = []
    real = fused.make_kernel_image_renderer

    def spy(*a, **kw):
        built.append(kw)
        return real(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(fused, "make_kernel_image_renderer", spy)
    scene, params, cam = cbox.build(dtype=jnp.float32)
    render = prender.make_renderer(
        scene, RenderConfig(width=8, height=8, spp=2, max_depth=3), cam)
    assert built and np.isfinite(np.asarray(render(params,
                                                   jax.random.key(1)))).all()
