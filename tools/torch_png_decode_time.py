#!/usr/bin/env python3
"""Host time of the port's PNG decoder (`spsvo_tpu_torch/io/png.py`) per row
filter, on one rendered 375x1242 corridor frame.

    python3 tools/torch_png_decode_time.py

Builds one PNG per filter type (None, Sub, Up, Average, Paeth, and the
per-row minimum-sum-of-absolute-differences choice that PNG encoders make)
with the forward filters of the PNG specification, checks that each decodes
back to the frame, and prints the median decode time of 5 runs. Pure host
work: numpy and zlib, no device.
"""
import json
import os
import struct
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spsvo_tpu_torch.eval.synthetic import synthetic_corridor  # noqa: E402
from spsvo_tpu_torch.io import png  # noqa: E402


def filtered_rows(img: np.ndarray) -> np.ndarray:
    """(5, H, W) uint8: every row of `img` under each of the 5 filters."""
    x = img.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) // 2, paeth]
    return np.stack([((x - q) & 255).astype(np.uint8) for q in preds])


def encode(rows: np.ndarray, filters: np.ndarray) -> bytes:
    h, w = rows.shape[1:]
    body = np.concatenate(
        [filters.astype(np.uint8)[:, None],
         rows[filters, np.arange(h)]], axis=1).tobytes()

    def chunk(t, data):
        return (struct.pack(">I", len(data)) + t + data
                + struct.pack(">I", zlib.crc32(t + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body, 6)) + chunk(b"IEND", b""))


def main() -> None:
    frames, _, _, _ = synthetic_corridor(np.random.default_rng(42),
                                         n_frames=1, h=375, w=1242)
    img = frames[0][0]
    rows = filtered_rows(img)
    h = img.shape[0]
    # the encoders' heuristic: per row, the filter whose output read as
    # signed bytes has the least sum of absolute values
    cost = np.abs(rows.astype(np.int8).astype(np.int32)).sum(axis=2)
    choices = {"none": np.zeros(h, int), "sub": np.full(h, 1),
               "up": np.full(h, 2), "average": np.full(h, 3),
               "paeth": np.full(h, 4), "adaptive": np.argmin(cost, axis=0)}
    out = {}
    for name, ft in choices.items():
        data = encode(rows, ft)
        if not np.array_equal(png.decode_gray8(data), img):
            raise SystemExit(f"decode of the {name} file differs")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            png.decode_gray8(data)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"decode_ms": float(np.median(times)),
                     "bytes": len(data),
                     "filters_used": np.bincount(ft, minlength=5).tolist()}
    print(json.dumps({"image": list(img.shape), "by_filter": out}))


if __name__ == "__main__":
    main()
