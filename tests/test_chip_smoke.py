"""chip_smoke.py on the CPU: it refuses a platform without a GPU, and
its phases run at tiny sizes with the path kernel in the Pallas
interpreter. Also the compile-cache helper every entry point calls."""

import os
import pathlib
import subprocess
import sys

import pytest

import jax

import chip_smoke as cs
from drt_tpu.config import headline_config
from drt_tpu.parallel.render import KERNEL
from drt_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_main_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_phase_compile_tiny():
    cfg = headline_config(16, 8, 4, spp_chunks=2)
    assert cs.phase_compile(cfg, backend=KERNEL, interpret=True) == KERNEL


def test_phase_parity_tiny():
    out = cs.phase_parity(16, 8, 2, interpret=True)
    assert out["ok_fraction"] == 1.0
    assert out["grad_rel"] <= cs.PARITY_GRAD_RTOL


@pytest.mark.parametrize("backend", [KERNEL, "xla"])
def test_phase_main_path_tiny(backend):
    cs.phase_main_path(headline_config(16, 12, 4, spp_chunks=2),
                       backend=backend, interpret=True, reps=1)


def test_phase_invert_tiny():
    cs.phase_invert(16, 12, 4, steps=8, steps_per_call=2, backend="xla")


def test_phase_xla_meshes_tiny():
    cs.phase_xla_meshes(8, 6, runs=((1, 2, 1),), reps=1)


def test_phase_sharded_on_four_virtual_devices():
    assert len(jax.devices()) >= 4
    cs.phase_sharded(4, 16, 8, 4, spp_chunks=1)


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv(cache.ENV_VAR, "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert cache.enable_compile_cache() == path
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
