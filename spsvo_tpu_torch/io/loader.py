"""Asynchronous stereo frame loading.

Mirrors `spsvo_tpu.io.loader`: order-preserving prefetching iterators over
stereo PNG pairs that decode and preprocess ahead of the consumer.
`NativeStereoLoader` is a C++ worker pool (`native/loader.cpp`: OpenCV
decode, crop and INTER_LINEAR resize of the uint8 image), built with `g++`
against OpenCV at first use into `.kernel_cache/` next to this package;
`PythonStereoLoader` decodes with the package's own PNG reader on a worker
thread and resizes with the device preprocessing's float taps.
`make_loader` returns the native loader where it builds (a compiler and the
OpenCV headers and libraries are there), else the Python one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import queue
import subprocess
import tempfile
import threading
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from spsvo_tpu_torch import _build
from spsvo_tpu_torch.io import png
from spsvo_tpu_torch.ops.image import preprocess_image_np

NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "loader.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17",
             "-I/usr/include/opencv4"]
GXX_LIBS = ["-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core",
            "-lpthread"]


def _build_native() -> str:
    """The native loader's shared library, compiled once per source and
    flags into `_build.CACHE` (the name carries their hash). Raises where
    it does not build."""
    with open(NATIVE_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS + GXX_LIBS)
                                .encode()).hexdigest()[:16]
    so = os.path.join(_build.CACHE, f"libspsvo_loader_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_build.CACHE, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build.CACHE)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, NATIVE_SRC, *GXX_LIBS,
                               "-o", tmp], capture_output=True, text=True,
                              timeout=180)
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[:400])
        os.replace(tmp, so)
        return so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def _native_lib() -> Optional[ctypes.CDLL]:
    """The native loader's library, built and loaded with its signatures
    declared; None, with a warning, where it does not build or load (no
    compiler, no OpenCV, a library built against an OpenCV this machine
    lacks). One attempt per process."""
    try:
        lib = ctypes.CDLL(_build_native())
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"native loader unavailable, using the Python loader: "
                      f"{e}")
        return None
    lib.spsvo_loader_create.restype = ctypes.c_void_p
    lib.spsvo_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.spsvo_loader_next.restype = ctypes.c_int64
    lib.spsvo_loader_next.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_float)]
    lib.spsvo_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeStereoLoader:
    """Yields (frame_idx, frames (2, H, W) float32, in [0, 1] when
    `normalize`), in order, decoded and preprocessed ahead by
    `num_threads` C++ workers into a ring of `queue_capacity` frames. A
    frame whose image cannot be decoded raises ValueError at that frame.
    Raises RuntimeError where the library does not build or load."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 dst_h: int, dst_w: int, queue_capacity: int = 8,
                 num_threads: int = 4, normalize: bool = True):
        if len(left_paths) != len(right_paths):
            raise ValueError("left_paths and right_paths differ in length")
        lib = self._lib = _native_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._paths = list(zip(left_paths, right_paths))
        n = len(self._paths)
        lp = (ctypes.c_char_p * n)(*[p.encode() for p in left_paths])
        rp = (ctypes.c_char_p * n)(*[p.encode() for p in right_paths])
        self._handle = lib.spsvo_loader_create(
            lp, rp, n, dst_h, dst_w, queue_capacity, num_threads,
            1 if normalize else 0)
        self._shape = (2, dst_h, dst_w)
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        buf = np.empty(self._shape, np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        try:
            for _ in self._paths:
                idx = self._lib.spsvo_loader_next(self._handle, ptr)
                if idx == -1:
                    break
                if idx < -1:
                    raise ValueError(
                        f"frame {-idx - 2}: {self._paths[-idx - 2]}: not a "
                        "PNG (or other image) that OpenCV decodes")
                yield int(idx), buf.copy()
        finally:
            self.close()

    def close(self) -> None:
        if not self._closed:
            self._lib.spsvo_loader_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PythonStereoLoader:
    """Yields (frame_idx, frames (2, H, W) float32, in [0, 1] when
    `normalize`), in order, decoded ahead on a worker thread into a queue
    of `queue_capacity` frames. A decode error is raised to the consumer at
    the frame where it happened. `close()` stops the worker early."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 dst_h: int, dst_w: int, queue_capacity: int = 8,
                 num_threads: int = 2, normalize: bool = True):
        if len(left_paths) != len(right_paths):
            raise ValueError("left_paths and right_paths differ in length")
        del num_threads    # one worker keeps the order; kept for the signature
        self._paths = list(zip(left_paths, right_paths))
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_capacity)
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for i, (lp, rp) in enumerate(self._paths):
                    frames = np.stack([
                        preprocess_image_np(png.read_gray8(p), dst_h, dst_w,
                                            normalize) for p in (lp, rp)])
                    if not put((i, frames)):
                        return
                put(None)
            except Exception as e:   # handed to the consumer, which raises it
                put(e)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def make_loader(left_paths: List[str], right_paths: List[str], dst_h: int,
                dst_w: int, **kw):
    """The frame loader for a list of stereo PNG pairs: the native one
    where it builds, else the Python one."""
    try:
        return NativeStereoLoader(left_paths, right_paths, dst_h, dst_w, **kw)
    except RuntimeError:
        return PythonStereoLoader(left_paths, right_paths, dst_h, dst_w, **kw)
