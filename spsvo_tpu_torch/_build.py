"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library, cached by
the hash of its source in `.kernel_cache/` next to this file, and loaded
with ctypes. Nothing is built at import time: the CPU tests import every
module, and only a CUDA tensor reaches a kernel.

`launches` counts the kernel launches that ran on the card. A wrapper calls
`count_launch` where it launches its kernel and nowhere else: that adds one
to `launches`, or, while the stream is being captured into a CUDA graph
(nothing runs then), one to `captured`. The owner of a graph keeps what its
capture added to `captured` (`captured_since`) and hands it to
`count_replay` at every replay, which is when those launches run. `shapes`
holds the shape of each wrapper's last call.
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

launches: collections.Counter = collections.Counter()   # ran on the card
captured: collections.Counter = collections.Counter()   # recorded in graphs
shapes: Dict[str, tuple] = {}    # name -> shape of the last call
build_log: Dict[str, dict] = {}   # name -> {"seconds", "cached", "ptxas"}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()          # guards _locks
_locks: Dict[str, threading.Lock] = {}   # one per kernel: builds overlap


def reset_launches() -> None:
    launches.clear()
    captured.clear()
    shapes.clear()


def count_launch(name: str, shape: tuple) -> None:
    """One call of the wrapper `name` that launched (or, under capture,
    recorded) its kernel at `shape`."""
    import torch
    shapes[name] = shape
    if torch.cuda.is_current_stream_capturing():
        captured[name] += 1
    else:
        launches[name] += 1


def captured_since(before: collections.Counter) -> collections.Counter:
    """What a capture recorded: `captured` less its copy `before`."""
    return captured - before


def count_replay(recorded: collections.Counter) -> None:
    """A graph holding the `recorded` launches was replayed once."""
    launches.update(recorded)


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


def load(name: str, src: str = "") -> ctypes.CDLL:
    """Compile (if needed) and load `csrc/<name>.cu`, or the source file
    `src` under the name `name` (an instrumented copy, for example)."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _libs:
            return _libs[name]
        src = src or os.path.join(CSRC, f"{name}.cu")
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


def load_all(names) -> None:
    """Build and load several kernels, their `nvcc` runs side by side. The
    first build that failed is raised once all have ended."""
    errors: Dict[str, BaseException] = {}

    def one(name: str) -> None:
        try:
            load(name)
        except BaseException as e:   # carried to the caller's thread
            errors[name] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in names:
        if n in errors:
            raise errors[n]


def check_status(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned after a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
