#!/usr/bin/env python3
"""Time versions of the bf16 convolution kernel (`csrc/conv_bf16.cu`) on
superpoint_pretrained's convs, as the bf16 graph runs them, in one process.

    python3 tools/torch_conv_ab.py SOURCE.cu [SOURCE.cu ...]

Builds each source under its own name and times, through the port's
wrapper (`ops.conv_cuda.conv2d_bf16`) with that library in place of the
repository's, every conv of superpoint_pretrained at 120x392 (B=64 and 2)
and 360x1176 (B=16), each layer's input held as the graph holds it (made
before the clock starts) and its output written as the graph writes it
(bf16 NHWC, pooled where fused, or fp32). Device ms per call from CUDA
graphs (`chip_smoke.graph_ms`), the sources in turns A, B, ..., B, A; per
layer the smaller of the two readings. Inputs are the corridor's first 8
frames preprocessed on the card, so every source sees the same data.
Prints one JSON line per shape. Needs a CUDA device.
"""

import ctypes
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.models import zoo
    from spsvo_tpu_torch.ops import conv_cuda
    from spsvo_tpu_torch.ops import image as image_ops
    sources = sys.argv[1:]
    if not sources or not torch.cuda.is_available():
        sys.exit("usage: torch_conv_ab.py SOURCE.cu [...] (on a CUDA device)")
    names = [f"conv_ab{i}" for i in range(len(sources))]
    for name, src in zip(names, sources):
        _build.load(name, os.path.abspath(src))

    def library(name):
        def lib(fn_name, n_int):
            fn = getattr(_build.load(name), fn_name)
            if fn.argtypes is None:
                fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * n_int
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            return fn
        return lib

    dev = torch.device("cuda", 0)
    frames = cs.render_corridor(8)[0]
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    model = zoo.load_model("superpoint_pretrained", torch.bfloat16, dev)
    repo_lib = conv_cuda._lib
    order = list(range(len(names))) + list(reversed(range(len(names))))
    for h, w, n_img in ((120, 392, 64), (120, 392, 2), (360, 1176, 16)):
        x = image_ops.preprocess_image(raw, h, w).reshape(-1, h, w)[..., None]
        x = x.repeat(4, 1, 1, 1)[:n_img]
        runs = {src: {} for src in sources}
        for i in order:
            conv_cuda._lib = library(names[i])
            for (layer, xx, ww, bb, strides, pads, dil, groups, relu,
                 store) in cs.conv_layers(dev, model, x):
                geo = (strides, pads, dil, groups)
                xs = conv_cuda.to_bf16_nhwc(xx) if store["in_bf16"] else xx
                kw = {"relu": relu, "out_bf16": store["out_bf16"],
                      "pool": store["pool"]}
                with torch.no_grad():
                    ms = cs.graph_ms(lambda: conv_cuda.conv2d_bf16(
                        xs, ww, bb, *geo, **kw), 5 if n_img > 2 else 20)
                runs[sources[i]].setdefault(layer, []).append(ms)
        conv_cuda._lib = repo_lib
        best = {src: {k: min(v) for k, v in r.items()}
                for src, r in runs.items()}
        print(json.dumps({"hw": [h, w], "B": n_img,
                          "device": torch.cuda.get_device_name(0),
                          "sum_ms": {s: sum(b.values())
                                     for s, b in best.items()},
                          "layers_ms": best}), flush=True)


if __name__ == "__main__":
    main()
