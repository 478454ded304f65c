"""Build and load the CUDA kernels of ``csrc/ring_kernels.cu``.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, keyed by a hash of the source and the flags (so a
stale library is never loaded), under ``oddio_tpu_torch/_build/`` (listed
in ``.gitignore``), and loaded with ``ctypes``.  Nothing here runs at
import time: the package imports on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "lib", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ring_kernels.cu"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lib = None


def _nvcc():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build only on a "
        "machine with the CUDA toolkit"
    )


def build():
    """Compile the kernels if no library for this source exists yet.
    Returns ``(path, seconds, ptxas_log)``; seconds is 0.0 on a cache hit."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"ring_kernels_{tag}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, proc.stderr


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so, _, _ = build()
        L = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.rows_append.argtypes = [vp, vp, i64, vp, i32, i32, i32, vp]
        L.rows_append.restype = i32
        iarr = ctypes.POINTER(ctypes.c_int)
        L.window_select.argtypes = [
            vp, i64, i32, vp,          # wide, stride, S2, rowshift
            vp, vp, vp, vp,            # scal0, scal1, g0, g1
            vp, vp, vp, vp,            # e0, e1, f0, f1
            vp, vp,                    # part, out
            i32, i32, i32, i32,        # V, n, K, nb
            iarr, iarr,                # col0s, hcaps (host arrays)
            vp,                        # stream
        ]
        L.window_select.restype = i32
        _lib = L
    return _lib
