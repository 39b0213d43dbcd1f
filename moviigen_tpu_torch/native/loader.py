"""ctypes bindings for the native async cache reader
(``src/cache_loader.cpp``) and an ``.npy`` batch reader built on it.

The port's own copy of ``moviigen_tpu/native/loader.py``. The shared
library is built with ``g++`` at first use, never at import, into
``moviigen_tpu_torch/_build/`` under a name that carries a hash of its
source (an edited source is rebuilt), as ``kernels.py`` builds the CUDA
kernels. Where it cannot be built or loaded, ``native_available()`` says
so with a warning, and callers fall back to Python I/O.
"""

from __future__ import annotations

import ast
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "src" / "cache_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_CXX = "g++"
_lib = None
_lib_lock = threading.Lock()


def _target() -> Path:
    """The library's path, named by a hash of its source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"cache_loader-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            [_CXX, "-O2", "-shared", "-fPIC", "-pthread",
             "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logging.warning("native cache loader build failed: %s", e)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        out = _target()
        if not out.exists() and not _build(out):
            _lib = False
            return _lib
        try:
            lib = ctypes.CDLL(str(out))
            lib.clp_create.restype = ctypes.c_void_p
            lib.clp_create.argtypes = [ctypes.c_int]
            lib.clp_submit.restype = ctypes.c_int64
            lib.clp_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_uint64]
            lib.clp_wait.restype = ctypes.c_int64
            lib.clp_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.clp_destroy.restype = None
            lib.clp_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except OSError as e:
            logging.warning("native cache loader unavailable: %s", e)
            _lib = False
    return _lib


def native_available() -> bool:
    """Whether the reader pool can be used (builds it on first call)."""
    return bool(_load())


class NativeReaderPool:
    """Thread pool performing file reads outside the GIL."""

    def __init__(self, num_threads: int = 4):
        lib = _load()
        if not lib:
            raise RuntimeError("native cache loader unavailable")
        self._lib = lib
        self._pool = lib.clp_create(num_threads)

    def submit(self, path: str, dst: np.ndarray, offset: int = 0) -> int:
        """Async read of ``dst.nbytes`` bytes at ``offset`` into ``dst``
        (must be C-contiguous and kept alive until wait)."""
        if not dst.flags["C_CONTIGUOUS"]:
            raise ValueError("dst must be C-contiguous")
        ticket = self._lib.clp_submit(
            self._pool, path.encode(), dst.ctypes.data_as(ctypes.c_void_p),
            offset, dst.nbytes)
        if ticket < 0:
            raise RuntimeError(f"submit failed for {path}")
        return ticket

    def wait(self, ticket: int) -> int:
        n = self._lib.clp_wait(self._pool, ticket)
        if n < 0:
            raise IOError(f"native read failed (code {n})")
        return n

    def close(self):
        if self._pool:
            self._lib.clp_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _npy_header(path: str) -> Tuple[np.dtype, tuple, int, bool]:
    """Parse an .npy header: (dtype, shape, payload_offset, fortran)."""
    with open(path, "rb") as f:
        magic = f.read(6)
        if magic != b"\x93NUMPY":
            raise ValueError(f"not an npy file: {path}")
        major, _minor = f.read(2)
        if major == 1:
            hlen = int.from_bytes(f.read(2), "little")
        else:
            hlen = int.from_bytes(f.read(4), "little")
        d = ast.literal_eval(f.read(hlen).decode("latin1"))
        offset = f.tell()
    return (np.dtype(d["descr"]), tuple(d["shape"]), offset,
            d["fortran_order"])


def read_npy_batch(pool: NativeReaderPool,
                   paths: Sequence[str]) -> List[np.ndarray]:
    """Read many .npy files concurrently through the native pool: every
    header is checked, every read submitted, then each one waited for
    (all of them, also after a failed one: the pool's threads write into
    ``arrays`` until then)."""
    headers = [_npy_header(p) for p in paths]
    for p, (_, _, _, fortran) in zip(paths, headers):
        if fortran:
            raise ValueError(f"fortran-order npy unsupported: {p}")
    arrays = [np.empty(shape, dtype) for dtype, shape, _, _ in headers]
    tickets = [pool.submit(p, a, h[2])
               for p, a, h in zip(paths, arrays, headers)]
    errors = []
    for t, p, a in zip(tickets, paths, arrays):
        try:
            n = pool.wait(t)
        except IOError as e:
            errors.append(f"{e} for {p}")
            continue
        if n != a.nbytes:
            errors.append(f"short read {n}/{a.nbytes} for {p}")
    if errors:
        raise IOError("; ".join(errors))
    return arrays
