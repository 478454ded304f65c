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

_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

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
        "ring_select": [
            _vp, _i64, _i32,               # ring, rowlen, rows
            _vp, _vp,                      # ptrs, geo (host arrays)
            _vp, _vp,                      # sub_idx, sub_on (or null)
            _vp, _vp, _vp,                 # part, ticket (or null), out
            _i32, _i32, _i32, _i32, _i32,  # V, vps, n, R, K
            _i32, _i32, _i32, _i32, _i32,  # DMAX, FP, cap, wrap, nb
            _vp,                           # stream
        ],
        # windows, stride, ptrs, strides (host arrays), part, ticket (or
        # null), out, V, n, K, emax2, stream
        "window_select_flat": [_vp, _i64, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                               _vp],
    },
    "flat_kernels": {
        # ring, rowlen, samples, stride, p0p, p1p (or null), p0, p1, V, W,
        # stream
        "flat_append": [_vp, _i64, _vp, _i64, _vp, _vp, _i32, _i32, _i32, _i32,
                        _vp],
        # ring, rowlen, ptrs, strides (host arrays), part, ticket (or null),
        # out, V, n, K, emax2, stream
        "dma_window_select": [_vp, _i64, _vp, _vp, _vp, _vp, _vp, _i32, _i32, _i32, _i32,
                              _vp],
    },
    "stream_kernels": {
        # ring, chunk, chunk_stride, wrow, wadd (or null), row_mul, s_pos,
        # wcount, s_count, rows, size_pad, mw, C, G, stream
        "ring_place": [_vp, _vp, _i64, _vp, _vp, _i32, _i32, _vp, _i32, _i32,
                       _i32, _i32, _i32, _i32, _vp],
        "ring_resample": [
            _vp, _vp, _vp, _f32,           # ring, t, rate or ds, interval
            _vp, _vp, _vp, _i32,           # start, len, count (or null), its stride
            _vp, _vp, _vp, _vp,            # out, t', len', start' (or null)
            _i32, _i32, _i32,              # rows, size_pad, n
            _vp,                           # stream
        ],
        "arena_resample": [
            _vp, _i64,                     # arena, its length
            _vp, _vp, _vp,                 # xg, lo, hi
            _vp, _vp, _vp, _vp,            # o0, ds_int, f_hi, f_lo
            _vp, _i32, _i32,               # out, rows, n
            _vp,                           # stream
        ],
        "arena_step": [
            _vp, _i64, _f32, _i32,         # ptrs (host array), arena length, interval, count stride
            _i32, _i32,                    # cyc, form
            _i32, _i32, _i32, _i32,        # V, C, E, n
            _i32, _i32,                    # guard, row
            _vp,                           # stream
        ],
    },
    "agc_kernel": {
        "agc_step": [
            _vp, _vp, _vp, _vp,            # samples, out, avg0, tau
            _vp, _f32, _i32,               # interval column (or null), interval, stride
            _vp, _i32,                     # count, its stride
            _vp, _vp, _vp, _vp,            # low, high, max_gain, carry
            _i32, _i32, _i32,              # V, C, n
            _vp,                           # stream
        ],
    },
    "walk_kernel": {
        # ptrs (host array), scalars (host array), V, voices per rot_prev
        # row, per rot row, per nw entry, motion lanes, cap, stream
        "voice_walk": [_vp, _vp, _i32, _i32, _i32, _i32, _i32, _i32, _vp],
    },
    "select_kernel": {
        "strip_select": [
            _vp, _i32, _i32,               # ring, L, can_stage
            _vp, _i32, _vp, _i32,          # rrow, its stride, extra, its stride
            _vp, _i32,                     # scal, its stride
            _vp, _vp, _i32,                # gain0, d_gain, their stride
            _vp, _i32,                     # maskf, its stride
            _vp, _vp, _vp,                 # part, ticket (or null), out
            _i32, _i32, _i32, _i32,        # V, voices per scene, n, K
            _vp,                           # stream
        ],
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
