"""Where the int8 trunk's time goes on the card, beside the bf16 trunk.

superpoint_pretrained at the flagship's 120x392 over the online hybrid's
batch of 64 images (32 stereo frames of the smoke test's corridor), three
trunks: bf16, int8 with dynamic activation scales, int8 with static scales
calibrated at the 99.9 |x| percentile on the corridor's frames [::8] (the
smoke test's phase 9b model). For each: the device time of one call from a
CUDA graph, and a torch.profiler table of device time by kernel over 3
eager calls. Then conv1b (the widest conv: 64 -> 64 channels at full
resolution) in its stages, each from a CUDA graph: the quantize of its
input, an int8 im2col built from nine tap views joined by `torch.cat`
("im2col_int8", a reference route), the `torch._int_mm` GEMM,
`quantize.conv_int32` whole (the package's im2col and GEMM), the
dequantize epilogue, `quantize.int8_conv` whole; and cuDNN's
bf16-semantics fp32 conv of the same layer.

    python tools/torch_int8_profile.py [--top 12]

One JSON object per line; the last line is the card's name and power limit.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(fn, iters: int = 3, reps: int = 5) -> float:
    """Device time per call of `fn`: a CUDA graph of `iters` calls, replayed
    `reps` times between CUDA events."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.no_grad():
        with torch.cuda.stream(stream):
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def kernel_table(fn, top: int):
    """Device time per call by kernel name, over 3 profiled calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.device_type.name == "CUDA":
            rows.append((t / 3e3, ev.count // 3, ev.key[:90]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return total, [{"ms": r[0], "launches": r[1], "kernel": r[2]}
                   for r in rows[:top]]


def main() -> None:
    import torch
    import torch.nn.functional as F

    from spsvo_tpu_torch.eval.synthetic import synthetic_corridor
    from spsvo_tpu_torch.models import quantize, zoo
    from spsvo_tpu_torch.ops import image as image_ops
    from spsvo_tpu_torch.presets import flagship_tpu

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    dev = torch.device("cuda")
    n = 32
    twists = [(np.array([0.0, (0.003 if i < n // 2 else -0.003), 0.0]),
               np.array([0.0, 0.0, 0.35])) for i in range(n - 1)]
    frames, _, _, _ = synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242, twists=twists)
    cfg = dataclasses.replace(flagship_tpu(),
                              model_name_prefix="superpoint_pretrained")
    raw = torch.as_tensor(np.stack([[il, ir] for il, ir in frames])).to(dev)
    imgs = image_ops.preprocess_image(raw, cfg.image_height, cfg.image_width)
    x = imgs.reshape(-1, cfg.image_height, cfg.image_width)[..., None]
    cal = imgs[::8].reshape(-1, cfg.image_height, cfg.image_width)[..., None]
    prefix = cfg.model_name_prefix
    models = {
        "bf16": zoo.load_model(prefix, torch.bfloat16, dev),
        "int8_dynamic": zoo.load_model(prefix, device=dev, int8=True),
        "int8_static": zoo.load_model(prefix, device=dev, int8=True,
                                      int8_calibration=cal,
                                      int8_percentile=99.9),
    }
    for name, model in models.items():
        total, table = kernel_table(lambda: model(x), args.top)
        print(json.dumps({"trunk": name, "images": x.shape[0],
                          "graph_ms": graph_ms(lambda: model(x)),
                          "profiled_device_ms": total, "kernels": table}),
              flush=True)

    # conv1b in stages, on the static model's own input activation
    m = models["int8_static"]
    with torch.no_grad():
        a1 = F.relu(F.conv2d(x.permute(0, 3, 1, 2), models["bf16"].get_buffer(
            "conv1a.weight"), models["bf16"].get_buffer("conv1a.bias"),
            padding=1))
    w = m.get_buffer("conv1b.weight")
    ws, asc = m.get_buffer("conv1b.weight#scale"), m.get_buffer(
        "conv1b.weight#ascale")
    xq = quantize.quantize_activation(a1, asc)
    acc = quantize.conv_int32(xq, w, (1, 1), (1, 1, 1, 1), (1, 1), 1)
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
    h, wd = a1.shape[2:]
    taps = [xp[:, i:i + h, j:j + wd, :] for i in range(3) for j in range(3)]
    cols = torch.cat(taps, dim=-1).reshape(-1, 576)
    w2d = w.permute(0, 2, 3, 1).reshape(64, 576).contiguous()
    wf = models["bf16"].get_buffer("conv1b.weight")
    a1b = a1.to(torch.bfloat16).float()
    wfb = wf.to(torch.bfloat16).float()
    stages = {
        "quantize_input": lambda: quantize.quantize_activation(a1, asc),
        "im2col_int8": lambda: torch.cat(taps, dim=-1).reshape(-1, 576),
        "int_mm": lambda: torch._int_mm(cols, w2d.t()),
        "conv_int32_total": lambda: quantize.conv_int32(
            xq, w, (1, 1), (1, 1, 1, 1), (1, 1), 1),
        "dequantize_epilogue": lambda: acc.float() * (asc * ws)[
            None, :, None, None],
        "int8_conv_total": lambda: quantize.int8_conv(
            a1, w, ws, (1, 1), (1, 1, 1, 1), (1, 1), 1, asc),
        "cudnn_fp32_conv_bf16_operands": lambda: F.conv2d(a1b, wfb,
                                                          padding=1),
    }
    gemm_ops = 2 * cols.shape[0] * 576 * 64
    print(json.dumps({"conv1b": {k: graph_ms(f) for k, f in stages.items()},
                      "M": cols.shape[0], "K": 576, "N": 64,
                      "int_mm_tera_ops": gemm_ops / 1e12,
                      "activation_gb_fp32": a1.numel() * 4 / 1e9,
                      "im2col_gb": cols.numel() / 1e9}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
