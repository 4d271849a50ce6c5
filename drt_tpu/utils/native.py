"""On-demand build + ctypes loader for the native (C++) runtime pieces.

The reference's runtime is native C++ end-to-end (image output goes
through OpenEXR, src/write.hpp). drt_tpu keeps the device compute path in
JAX/Pallas and implements host-side runtime components natively in C++
(native/*.cpp), compiled once on first use into a shared library and
bound through ctypes (no pybind11 in this environment).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

_ROOT = pathlib.Path(__file__).resolve().parents[2]
_SRC_DIR = _ROOT / "native"
_BUILD_DIR = _SRC_DIR / "build"
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}


def _build(name: str) -> pathlib.Path | None:
    src = _SRC_DIR / f"{name}.cpp"
    if not src.exists():
        return None
    so = _BUILD_DIR / f"lib{name}.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    # PID-unique tmp: concurrent builders (pytest-xdist, multi-host on a
    # shared filesystem) must not clobber each other's partial writes;
    # the final rename is atomic so the winner is always a complete .so.
    tmp = so.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           str(src), "-o", str(tmp)]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        tmp.rename(so)
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def load(name: str) -> ctypes.CDLL | None:
    """Build (if needed) and load native/<name>.cpp as a CDLL. Returns
    None when the toolchain or source is unavailable — callers fall back
    to their pure-Python implementation."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        so = _build(name)
        lib = None
        if so is not None:
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                lib = None
        _LIBS[name] = lib
        return lib


def exr_writer() -> ctypes.CDLL | None:
    """The native EXR writer (native/exr_writer.cpp), or None."""
    lib = load("exr_writer")
    if lib is not None and not getattr(lib, "_drt_sig", False):
        lib.drt_write_exr.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.drt_write_exr.restype = ctypes.c_int
        lib._drt_sig = True
    return lib
