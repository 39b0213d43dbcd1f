"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` (named by
a hash of its source and the shared ``csrc/*.cuh`` headers, so an edited
source is rebuilt), then loaded with ``ctypes``. Builds happen at first
use, never at import. ``use`` points a kernel's wrappers at another source
with the same entry points (an earlier design kept as a yardstick), for
timing through the same wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every ``csrc/<name>.cu`` of the port
KERNELS = ("flash_fwd", "flash_bwd", "int8_gemm", "quantize_act",
           "flash_fwd_f32")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        if os.path.exists(os.path.join(home, "bin", "nvcc")):
            nvcc = os.path.join(home, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or in $CUDA_HOME/bin)")
    return nvcc


def _target(source: Path) -> Path:
    """The library's path, named by a hash of its source and of every
    shared header under ``csrc/``."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str],
          sources: Optional[Mapping[str, Path]] = None) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together: ``csrc/<name>.cu``, or ``sources[name]``
    where given. Returns the seconds each build took (0.0 for one already
    built). Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sources or {}
    procs = {}
    secs = {}
    for name in names:
        src = sources.get(name, CSRC / f"{name}.cu")
        out = _target(src)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    return secs


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, the
    line to keep beside every measurement (a card held under its maximum
    power runs slower under load)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = use(name)
    return lib


def use(name: str, source: Optional[Path] = None) -> ctypes.CDLL:
    """Build ``source`` (default ``csrc/<name>.cu``) and make it the
    library that ``load(name)``, and so every wrapper of that kernel, calls
    from now on. ``use(name)`` goes back to the kernel itself. The source
    must export the same entry points."""
    src = source or CSRC / f"{name}.cu"
    build([name], {name: src})
    lib = ctypes.CDLL(str(_target(src)))
    _LIBS[name] = lib
    return lib
