"""ctypes bindings for the native streaming I/O runtime (native/io_runtime.cpp).

The port's own copy of ``real_time_sdr_tpu/utils/native_io.py`` (the port
imports nothing of the JAX package); it builds and loads the same
``native/librtsdr_io.so`` from the checkout's ``native/`` directory.

The native layer runs the pipe reads/writes on their own threads with ring
buffering, so a stalled source or sink never blocks device dispatch — the
C++-native counterpart of the reference's thread/queue design
(include/threadsafequeue.h). Falls back to synchronous Python file I/O when
the shared library is absent (``make -C native`` builds it).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "librtsdr_io.so")

_lib = None


def build(quiet: bool = True) -> bool:
    """Compile the native library in place. Returns True on success."""
    native_dir = os.path.dirname(_LIB_PATH)
    try:
        subprocess.run(["make", "-C", native_dir],
                       capture_output=quiet, check=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(os.path.dirname(_LIB_PATH), "io_runtime.cpp")
    stale = (os.path.exists(_LIB_PATH) and os.path.exists(src)
             and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if stale:
        # never load a stale binary: an ABI older than the ctypes
        # signatures below (e.g. a void push compiled before it returned
        # int) yields undefined return registers, not errors
        if not build():
            return None
    elif not os.path.exists(_LIB_PATH):
        if not build():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.rtsdr_reader_open.restype = ctypes.c_void_p
    lib.rtsdr_reader_open.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                      ctypes.c_size_t, ctypes.c_int]
    lib.rtsdr_reader_next.restype = ctypes.c_size_t
    lib.rtsdr_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.rtsdr_reader_dropped.restype = ctypes.c_uint64
    lib.rtsdr_reader_dropped.argtypes = [ctypes.c_void_p]
    lib.rtsdr_reader_close.argtypes = [ctypes.c_void_p]
    lib.rtsdr_writer_open.restype = ctypes.c_void_p
    lib.rtsdr_writer_open.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                      ctypes.c_size_t]
    lib.rtsdr_writer_push.restype = ctypes.c_int
    lib.rtsdr_writer_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_size_t]
    lib.rtsdr_writer_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class BlockReader:
    """Threaded ring-buffered block reader over an fd (native), or plain
    blocking reads (fallback)."""

    def __init__(self, fileobj, block_bytes: int, depth: int = 4,
                 drop_oldest: bool = False):
        self.block_bytes = block_bytes
        self._fileobj = fileobj
        lib = _load()
        self._native = None
        if lib is not None:
            try:
                fd = fileobj.fileno()
            except (OSError, AttributeError):
                fd = None
            if fd is not None:
                self._native = lib.rtsdr_reader_open(
                    fd, block_bytes, depth, int(drop_oldest))
                self._lib = lib
                self._buf = np.empty(block_bytes, dtype=np.uint8)

    @property
    def native(self) -> bool:
        """True while the native ring reads; False for the fallback, whose
        plain blocking reads ignore ``depth`` and ``drop_oldest``."""
        return self._native is not None

    def next(self) -> np.ndarray | None:
        """Next full block as uint8 array, or None at end of stream."""
        if self._native is not None:
            n = self._lib.rtsdr_reader_next(
                self._native, self._buf.ctypes.data_as(ctypes.c_void_p))
            if n == 0:
                return None
            return self._buf.copy()
        data = self._fileobj.read(self.block_bytes)
        if data is None or len(data) < self.block_bytes:
            return None
        return np.frombuffer(data, dtype=np.uint8)

    _dropped_final: int = 0

    @property
    def dropped(self) -> int:
        if self._native is not None:
            return int(self._lib.rtsdr_reader_dropped(self._native))
        return self._dropped_final  # latched by close()

    def close(self):
        if self._native is not None:
            self._dropped_final = int(
                self._lib.rtsdr_reader_dropped(self._native))
            self._lib.rtsdr_reader_close(self._native)
            self._native = None


class BlockWriter:
    """Threaded ring-buffered writer over an fd (native), or direct writes."""

    def __init__(self, fileobj, max_block_bytes: int, depth: int = 8):
        self._fileobj = fileobj
        self.max_block_bytes = max_block_bytes
        lib = _load()
        self._native = None
        if lib is not None:
            try:
                fd = fileobj.fileno()
            except (OSError, AttributeError):
                fd = None
            if fd is not None:
                self._native = lib.rtsdr_writer_open(fd, max_block_bytes,
                                                     depth)
                self._lib = lib

    def write(self, arr) -> None:
        data = np.ascontiguousarray(arr).view(np.uint8).ravel()
        if data.nbytes > self.max_block_bytes:
            raise ValueError(f"block of {data.nbytes} B exceeds writer "
                             f"capacity {self.max_block_bytes} B")
        if self._native is not None:
            rc = self._lib.rtsdr_writer_push(
                self._native, data.ctypes.data_as(ctypes.c_void_p),
                data.nbytes)
            if rc != 0:
                raise ValueError(
                    f"native writer rejected oversized block ({data.nbytes} "
                    f"B > {self.max_block_bytes} B)")
        else:
            self._fileobj.write(data.tobytes())
            # stream immediately: the advertised `| aplay` workflow must not
            # sit on stdio buffering when the native path is unavailable
            self._fileobj.flush()

    def close(self):
        if self._native is not None:
            self._lib.rtsdr_writer_close(self._native)  # drains
            self._native = None
        else:
            self._fileobj.flush()
