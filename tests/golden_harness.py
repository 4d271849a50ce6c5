"""Build & run the C++ golden harness against the reference headers.

The harness (tools/golden/golden_main.cpp) compiles the *actual reference
code* (headers at /root/reference/include) with a tape-backed rand()
override, giving golden images and — crucially — golden gradients from the
reference's own autodiff tape (vector.hpp:120-318).
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
REF_INCLUDE = pathlib.Path("/root/reference/include")
SRC = REPO / "tools" / "golden" / "golden_main.cpp"
RAND_MAX = 2**31 - 1

_build_dir = None


def golden_available() -> bool:
    return REF_INCLUDE.is_dir() and shutil.which("g++") is not None


def build() -> pathlib.Path:
    global _build_dir
    if _build_dir is None:
        _build_dir = pathlib.Path(tempfile.mkdtemp(prefix="drt_golden_"))
        binary = _build_dir / "golden"
        subprocess.run(
            ["g++", "-O2", "-std=c++17", f"-I{REF_INCLUDE}", str(SRC),
             "-o", str(binary)],
            check=True, capture_output=True, text=True, timeout=600)
    return _build_dir / "golden"


def make_tape_ints(n: int, seed: int) -> np.ndarray:
    """Uniform int draws in [0, RAND_MAX) — the values rand() returns."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, RAND_MAX, size=n, dtype=np.int32)


def run(width: int, height: int, spp: int, *, min_bounces=1, absorb=0.5,
        seed=0, grad=False, unbiased=False, draws_per_sample=96):
    """Run the golden harness. Returns dict with:
       image f64[H,W,3], grads f64[4,3] (grad mode), uniforms f64[n],
       consumed int (tape draws used), render_seconds float (the C++
       pixel loop only — no process spawn / tape IO overhead).

    unbiased=True enables the reference's IntegrateBackward machinery
    (integrate.hpp:11-24): the backward re-draws samples from the SAME
    global rand() stream at backward time (extra tape consumption —
    unbiased gradient runs consume far more than draws_per_sample)."""
    binary = build()
    n_samples = width * height * spp
    if unbiased and grad:
        draws_per_sample = max(draws_per_sample, 512)
    n_tape = n_samples * draws_per_sample + 1024
    for attempt in range(4):
        ints = make_tape_ints(n_tape, seed)
        with tempfile.TemporaryDirectory() as td:
            tape_path = pathlib.Path(td) / "tape.bin"
            out_path = pathlib.Path(td) / "out.bin"
            ints.tofile(tape_path)
            proc = subprocess.run(
                [str(binary), str(width), str(height), str(spp),
                 str(min_bounces), str(absorb), str(tape_path),
                 str(out_path), "1" if grad else "0",
                 "1" if unbiased else "0"],
                capture_output=True, text=True, timeout=600)
            if proc.returncode == 3:  # tape exhausted: retry bigger
                n_tape *= 4
                continue
            proc.check_returncode()
            data = np.fromfile(out_path, dtype=np.float64)
        break
    else:
        raise RuntimeError("tape kept exhausting")
    n_img = width * height * 3
    image = data[:n_img].reshape(height, width, 3)
    off = n_img
    grads = None
    if grad:
        grads = data[off:off + 12].reshape(4, 3)
        off += 12
    consumed = int(data[off])
    render_seconds = float(data[off + 1])
    uniforms = ints.astype(np.float64) / RAND_MAX
    return {"image": image, "grads": grads, "uniforms": uniforms,
            "consumed": consumed, "render_seconds": render_seconds}
