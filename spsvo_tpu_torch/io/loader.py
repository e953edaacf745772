"""Asynchronous stereo frame loading.

Mirrors `spsvo_tpu.io.loader`: an order-preserving prefetching iterator
over stereo PNG pairs that decodes and preprocesses on a worker thread. The
JAX package's native C++ loader needs OpenCV and is not ported; `make_loader`
returns the Python loader.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from spsvo_tpu_torch.io import png
from spsvo_tpu_torch.ops.image import preprocess_image_np


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
                dst_w: int, **kw) -> PythonStereoLoader:
    """The frame loader for a list of stereo PNG pairs."""
    return PythonStereoLoader(left_paths, right_paths, dst_h, dst_w, **kw)
