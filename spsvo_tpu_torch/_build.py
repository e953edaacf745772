"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library, cached by
the hash of its source in `.kernel_cache/` next to this file, and loaded
with ctypes. Nothing is built at import time: the CPU tests import every
module, and only a CUDA tensor reaches a kernel.

`launches` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
CACHE = os.path.join(_HERE, ".kernel_cache")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()
build_log: Dict[str, dict] = {}   # name -> {"seconds", "cached", "ptxas"}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built")
    return path


def load(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                    ).hexdigest()[:16]
        os.makedirs(CACHE, exist_ok=True)
        so = os.path.join(CACHE, f"{name}_{digest}.so")
        t0 = time.perf_counter()
        ptxas = ""
        cached = os.path.exists(so)
        if not cached:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=CACHE)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
                ptxas = proc.stderr
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(so)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "cached": cached, "ptxas": ptxas}
        _libs[name] = lib
        return lib


def check_status(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
