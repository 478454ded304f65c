"""Build and load the CUDA kernels of ``csrc/*.cu``.

Each source is compiled at first use with ``nvcc`` into its own shared
library with a plain C interface, under ``oddio_tpu_torch/_build/`` (listed
in ``.gitignore``), and loaded with ``ctypes``.  Every library's file name
carries one hash of ALL the ``csrc/`` sources and the flags, so a change to
any source rebuilds every library and a stale library is never loaded
beside a newer wrapper.  ``build()`` starts one ``nvcc`` per source, all
at once.  Nothing here runs at import time: the package imports on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "lib", "sources", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_iarr = ctypes.POINTER(ctypes.c_int)

#: C entry points of each library: name -> (argtypes, restype); every entry
#: point returns its launches' cudaError_t as an int
_SIGNATURES = {
    "ring_kernels": {
        # ring, slab, slab_stride, r0p, r1p (or null), r0, r1, V, RPV, nr,
        # vps, stream
        "rows_append": [_vp, _vp, _i64, _vp, _vp, _i32, _i32, _i32, _i32, _i32,
                        _i32, _vp],
        # ring, slab, slab_stride, start, FP, cap, M, V, RPV, nr, vps, stream
        "rows_append_cursor": [_vp, _vp, _i64, _vp, _i32, _i32, _i32, _i32, _i32,
                               _i32, _i32, _vp],
        "window_select": [
            _vp, _i64, _i32, _vp,          # wide, stride, S2, rowshift
            _vp, _vp, _vp, _vp,            # scal0, scal1, g0, g1
            _vp, _vp, _vp, _vp,            # e0, e1, f0, f1
            _vp, _vp,                      # part, out
            _i32, _i32, _i32, _i32, _i32,  # V, vps, n, K, nb
            _iarr, _iarr,                  # col0s, hcaps (host arrays)
            _vp,                           # stream
        ],
        "window_select_flat": [
            _vp, _i64, _i32,               # windows, stride, S
            _vp, _vp, _vp, _vp,            # scal0, scal1, g0, g1
            _vp, _vp,                      # e0, e1
            _vp, _vp,                      # part, out
            _i32, _i32, _i32,              # V, n, K
            _vp,                           # stream
        ],
    },
    "flat_kernels": {
        # ring, rowlen, samples, stride, p0p, p1p (or null), p0, p1, V, W,
        # stream
        "flat_append": [_vp, _i64, _vp, _i64, _vp, _vp, _i32, _i32, _i32, _i32,
                        _vp],
        "dma_window_select": [
            _vp, _i64, _vp,                # ring, rowlen, rstart
            _vp, _vp, _vp, _vp, _vp,       # scal0, scal1, g0, g1, maskf
            _vp, _vp,                      # e0, e1
            _vp, _vp,                      # part, out
            _i32, _i32, _i32,              # V, n, K
            _vp,                           # stream
        ],
    },
    "stream_kernels": {
        # ring, chunk, chunk_stride, wpos, wcount, rows, size_pad, mw, stream
        "ring_place": [_vp, _vp, _i64, _vp, _vp, _i32, _i32, _i32, _vp],
        # ring, t, ds_int, f_hi, f_lo, start, len, out, rows, size_pad, n,
        # stream
        "ring_resample": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                          _i32, _i32, _i32, _vp],
    },
    "agc_kernel": {
        # s, scal, gains, carry, V, n, stream
        "agc_gains": [_vp, _vp, _vp, _vp, _i32, _i32, _vp],
    },
    "select_kernel": {
        # ring, L, rrow, extra, scal, gain0, d_gain, maskf, part, out,
        # V, n, K, stream
        "strip_select": [_vp, _i32, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                         _i32, _i32, _i32, _vp],
    },
}

_libs = {}


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


def _tag():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode() + b"\0" + p.read_bytes())
    return h.hexdigest()[:16]


def sources():
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build(names=None):
    """Compile the given sources (default: every ``csrc/*.cu``) where no
    library for the current sources exists yet, one ``nvcc`` per source,
    all started together.  Returns ``{name: (path, seconds, ptxas_log)}``;
    seconds is 0.0 on a cache hit.  Raises if any build fails."""
    if names is None:
        names = sources()
    tag = _tag()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        so = BUILD_DIR / f"{name}_{tag}.so"
        if so.exists():
            out[name] = (so, 0.0, "")
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        p = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        procs[name] = (p, so, tmp, time.perf_counter())
    errors = []
    for name, (p, so, tmp, t0) in procs.items():
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc {name}.cu failed ({p.returncode}):\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, so)
        out[name] = (so, time.perf_counter() - t0, stderr)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def lib(name):
    """The loaded kernel library built from ``csrc/<name>.cu`` (built on
    first use)."""
    L = _libs.get(name)
    if L is None:
        so, _, _ = build((name,))[name]
        L = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(L, fn)
            f.argtypes = argtypes
            f.restype = _i32
        _libs[name] = L
    return L
