"""Native host-side data pipeline: mmap .npy reader + threaded prefetcher
(port of :mod:`pigs_tpu.native`).

C++ implementation in ``npy_loader.cc`` (built lazily with g++ into
``build/pigs_tpu_torch/native/`` at the root of the checkout, never next to
the source); ctypes bindings here.  Falls back to a pure-numpy
implementation when no compiler is available, so the package never
hard-requires the native build.  This is host code: nothing here touches
the card.

Usage::

    from pigs_tpu_torch.native import NpyFile, RandomRowLoader
    f = NpyFile("ns_V1e-3_N50_T50.npy")      # zero-copy mmap view
    arr = f.array                             # numpy view, no read until touch
    loader = RandomRowLoader(f, rows_per_batch=8)
    batch, idx = loader.next()                # background-thread-filled batch
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "npy_loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "pigs_tpu_torch", "native")
_SO = os.path.join(BUILD_DIR, "libpigs_host.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> Optional[ctypes.CDLL]:
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # A temporary name of this process's own: several processes
            # (test workers) may build at once.
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.pigs_npy_open.restype = ctypes.c_void_p
    lib.pigs_npy_open.argtypes = [ctypes.c_char_p]
    lib.pigs_npy_error.restype = ctypes.c_char_p
    lib.pigs_npy_error.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_ndim.restype = ctypes.c_int
    lib.pigs_npy_ndim.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_shape.restype = ctypes.POINTER(ctypes.c_longlong)
    lib.pigs_npy_shape.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_dtype.restype = ctypes.c_char_p
    lib.pigs_npy_dtype.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_data.restype = ctypes.c_void_p
    lib.pigs_npy_data.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_nbytes.restype = ctypes.c_longlong
    lib.pigs_npy_nbytes.argtypes = [ctypes.c_void_p]
    lib.pigs_npy_close.argtypes = [ctypes.c_void_p]
    lib.pigs_prefetch_create.restype = ctypes.c_void_p
    lib.pigs_prefetch_create.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong]
    lib.pigs_prefetch_next.restype = ctypes.c_void_p
    lib.pigs_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int)]
    lib.pigs_prefetch_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pigs_prefetch_destroy.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _build() or False
    return _lib or None


class NpyFile:
    """Memory-mapped .npy array (native mmap when available, else np.load)."""

    def __init__(self, path: str):
        self.path = path
        self._handle = None
        lib = get_lib()
        if lib is not None:
            handle = lib.pigs_npy_open(path.encode())
            err = lib.pigs_npy_error(handle)
            if err:
                lib.pigs_npy_close(handle)
                # Headers the native reader rejects (fortran_order, exotic
                # dtypes) fall back to numpy, which handles them correctly;
                # np.load raises its own error for genuinely bad files.
                try:
                    self.array = np.load(path, mmap_mode="r")
                except Exception:
                    raise OSError(f"{path}: {err.decode()}") from None
                self.shape = self.array.shape
                self.dtype = self.array.dtype
                self.native = False
                return
            self._lib = lib
            self._handle = handle
            ndim = lib.pigs_npy_ndim(handle)
            shape_ptr = lib.pigs_npy_shape(handle)
            self.shape = tuple(shape_ptr[i] for i in range(ndim))
            self.dtype = np.dtype(lib.pigs_npy_dtype(handle).decode())
            nbytes = lib.pigs_npy_nbytes(handle)
            buf = (ctypes.c_char * nbytes).from_address(
                lib.pigs_npy_data(handle))
            self.array = np.frombuffer(buf, dtype=self.dtype).reshape(
                self.shape)
            self.native = True
        else:
            self.array = np.load(path, mmap_mode="r")
            self.shape = self.array.shape
            self.dtype = self.array.dtype
            self.native = False

    def close(self):
        if self._handle is not None:
            # The numpy view must not outlive the mapping; drop our reference.
            self.array = None
            self._lib.pigs_npy_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RandomRowLoader:
    """Background-threaded random-row batch loader over an :class:`NpyFile`.

    Each ``next()`` returns ``(batch, indices)`` where ``batch`` has shape
    ``(rows_per_batch, *row_shape)``.  The batch is an owned copy — the ring
    slot is recycled before ``next()`` returns, so batches stay valid
    indefinitely and slots can never leak.  ``release()`` is a no-op kept for
    API compatibility.
    """

    def __init__(self, f: NpyFile, rows_per_batch: int, depth: int = 4,
                 num_threads: int = 2, seed: int = 0):
        self.f = f
        self.rows_per_batch = rows_per_batch
        self.row_shape = f.shape[1:]
        lib = get_lib()
        if f.native and lib is not None:
            self._lib = lib
            self._p = lib.pigs_prefetch_create(
                f._handle, rows_per_batch, depth, num_threads, seed)
            self._idx_buf = (ctypes.c_longlong * rows_per_batch)()
            self.native = True
        else:
            self._rng = np.random.default_rng(seed)
            self.native = False

    def next(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.native:
            slot = ctypes.c_int()
            ptr = self._lib.pigs_prefetch_next(self._p, self._idx_buf,
                                               ctypes.byref(slot))
            if not ptr or slot.value < 0:
                raise RuntimeError("prefetcher stopped")
            nbytes = (self.rows_per_batch
                      * int(np.prod(self.row_shape, dtype=np.int64))
                      * self.f.dtype.itemsize)
            buf = (ctypes.c_char * nbytes).from_address(ptr)
            # Copy out of the ring slot, then recycle it immediately: a
            # zero-copy view would be silently overwritten once workers
            # refill the slot, and holding slots until the caller remembers
            # release() leaks them (the IO/shuffle work is what the ring
            # buys; this memcpy is noise next to it).
            batch = np.frombuffer(buf, dtype=self.f.dtype).reshape(
                (self.rows_per_batch,) + self.row_shape).copy()
            indices = np.asarray(self._idx_buf[:], dtype=np.int64)
            self._lib.pigs_prefetch_release(self._p, slot.value)
            return batch, indices
        idx = self._rng.integers(0, self.f.shape[0], self.rows_per_batch)
        return np.asarray(self.f.array[idx]), idx

    def release(self):
        """No-op (batches are owned copies); kept for API compatibility."""

    def close(self):
        if self.native and getattr(self, "_p", None):
            self._lib.pigs_prefetch_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
