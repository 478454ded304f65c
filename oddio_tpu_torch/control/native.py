"""ctypes bindings for the native wait-free control plane (counterpart of
oddio_tpu/control/native.py).

Builds ``native/control_plane.cpp`` with ``g++`` on first use, into
``oddio_tpu_torch/_build/`` (listed in ``.gitignore``), and exposes the
reference's L1 primitives — the bounded SPSC ring (spsc.rs) and the
last-value-wins triple buffer (swap.rs) — for the real-time host
integration.  See native/control_plane.cpp for the memory model and
progress guarantees.

The library's file name carries a hash of the source and the flags, and a
build writes a temporary file that ``os.replace`` moves into place, so
processes that build at once (test workers) never load a half-written
library.  A failed build raises: there is no Python stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["SpscRing", "Swap", "load", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "control_plane.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libcontrol_plane_{h.hexdigest()[:16]}.so"


def _build(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {SRC.name} failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)


def load():
    """Build (if needed) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.oddio_ring_new.restype = ctypes.c_void_p
        lib.oddio_ring_new.argtypes = [ctypes.c_size_t]
        lib.oddio_ring_free.argtypes = [ctypes.c_void_p]
        lib.oddio_ring_write.restype = ctypes.c_size_t
        lib.oddio_ring_write.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ]
        lib.oddio_ring_read.restype = ctypes.c_size_t
        lib.oddio_ring_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t,
        ]
        lib.oddio_ring_readable.restype = ctypes.c_size_t
        lib.oddio_ring_readable.argtypes = [ctypes.c_void_p]
        lib.oddio_ring_writable.restype = ctypes.c_size_t
        lib.oddio_ring_writable.argtypes = [ctypes.c_void_p]
        lib.oddio_swap_new.restype = ctypes.c_void_p
        lib.oddio_swap_new.argtypes = [ctypes.c_size_t]
        lib.oddio_swap_free.argtypes = [ctypes.c_void_p]
        lib.oddio_swap_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.oddio_swap_refresh.restype = ctypes.c_int
        lib.oddio_swap_refresh.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class SpscRing:
    """Bounded wait-free SPSC float ring (spsc.rs semantics: partial writes
    return the count consumed)."""

    def __init__(self, capacity):
        self._lib = load()
        self._ptr = self._lib.oddio_ring_new(capacity)
        if not self._ptr:
            raise MemoryError("ring allocation failed")
        self.capacity = capacity

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.oddio_ring_free(self._ptr)
            self._ptr = None

    def write(self, samples):
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        return self._lib.oddio_ring_write(self._ptr, _fptr(samples), samples.size)

    def read(self, n):
        out = np.empty(n, np.float32)
        got = self._lib.oddio_ring_read(self._ptr, _fptr(out), n)
        return out[:got]

    def read_into(self, out):
        return self._lib.oddio_ring_read(self._ptr, _fptr(out), out.size)

    def readable(self):
        return self._lib.oddio_ring_readable(self._ptr)

    def writable(self):
        return self._lib.oddio_ring_writable(self._ptr)


class Swap:
    """Last-value-wins cross-thread cell for a fixed-dtype numpy payload
    (swap.rs semantics)."""

    def __init__(self, init):
        self._lib = load()
        init = np.ascontiguousarray(init)
        self._shape = init.shape
        self._dtype = init.dtype
        self._ptr = self._lib.oddio_swap_new(init.nbytes)
        if not self._ptr:
            raise MemoryError("swap allocation failed")
        self.publish(init)
        # receiver-side refresh so received() starts at init
        self.refresh()

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.oddio_swap_free(self._ptr)
            self._ptr = None

    def publish(self, value):
        value = np.ascontiguousarray(value, dtype=self._dtype)
        if value.shape != self._shape:
            raise ValueError(f"payload shape {value.shape}, expected {self._shape}")
        self._lib.oddio_swap_publish(self._ptr, value.ctypes.data_as(ctypes.c_void_p))

    def refresh(self):
        """Returns (fresh: bool, value)."""
        out = np.empty(self._shape, self._dtype)
        fresh = self._lib.oddio_swap_refresh(self._ptr, out.ctypes.data_as(ctypes.c_void_p))
        return bool(fresh), out
