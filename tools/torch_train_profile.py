"""Where a training step's time goes on the card.

The two training paths of `chip_smoke.py` phase 10, step by step on random
frames from a seed (the timing does not depend on the pictures):
- a distillation step (`distill.build_distill_step`: sp_resnet18 student,
  superpoint_pretrained teacher, clean_prob 0.25) at each of
  `distill.DEFAULT_RESOLUTIONS` (120x392 batch 16, 240x784 batch 6,
  360x1176 batch 2);
- a homographic fine-tune step (`training.train_step` on
  `io.homography.make_homographic_batch`: superpoint_pretrained at 120x392,
  batch 8).
For each: the median time of a whole step (host clock around steps that
end in `torch.cuda.synchronize()`) beside its convolutions' least time at
the card's fp32 peak (`conv_bound_ms`), the same step cut into stages, each
ended by a synchronize (augment or batch, teacher forward, student
forward and loss, backward, Adam update), the peak memory, a
torch.profiler table of device time by kernel over 3 steps, and the
device's busy share: that device time over the median step's wall time.
Then the widest conv alone (64 -> 64, 3x3, 16 images at 120x392) forward,
with and without autograd, and the distillation step at 120x392 once more
with `torch.backends.cudnn.benchmark` on (cuDNN times its algorithms and
keeps the fastest; the package leaves it off).

    python tools/torch_train_profile.py [--steps 8] [--top 10]

One JSON object per line; the last line is the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync():
    import torch
    torch.cuda.synchronize()


def timed(fn):
    """(result, host ms) of `fn` ended by a synchronize."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, 1e3 * (time.perf_counter() - t0)


def kernel_table(step, top: int):
    """Device time per step by kernel name over 3 profiled steps (the
    profiler's own overhead lengthens their wall time, printed beside)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        sync()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 3
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.device_type.name == "CUDA":
            rows.append((t / 3e3, ev.count // 3, ev.key[:90]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"device_ms_per_step": busy,
            "profiled_wall_ms_per_step": wall_ms,
            "kernels": [{"ms": r[0], "launches": r[1], "kernel": r[2]}
                        for r in rows[:top]]}


def conv_macs(prefix: str, h: int, w: int) -> int:
    """Multiply-adds of one image's forward through `prefix`'s convs at
    h x w (stride-1 convs keep the size, 2x2 max-pools halve it)."""
    from spsvo_tpu_torch.models import zoo
    builder = zoo._BUILDERS[prefix]()
    graph = builder.build()
    size = {graph.input_names[0]: (h, w)}
    macs = 0
    for node in graph.nodes:
        hh, ww = size[node.inputs[0]]
        if node.op == "MaxPool":
            hh, ww = hh // 2, ww // 2
        elif node.op == "Conv":
            kh, kw, cin, cout = builder.shapes[node.inputs[1]]
            macs += hh * ww * kh * kw * cin * cout
        for out in node.outputs:
            size[out] = (hh, ww)
    return macs


def bound_ms(student_images: int, teacher_images: int, student: str,
             teacher: str, h: int, w: int) -> float:
    """The least time of a step's convolutions at the card's fp32 peak (67
    TFLOP/s; TF32 stays off): the student's forward, input-gradient and
    weight-gradient passes (3 forwards' worth) and the teacher's forward."""
    flops = 2 * (3 * student_images * conv_macs(student, h, w)
                 + teacher_images * conv_macs(teacher, h, w))
    return flops / 67e12 * 1e3


def distill_step_parts(dev, frames, h, w, b, gen):
    """(whole step, staged step) closures for one resolution."""
    import torch

    from spsvo_tpu_torch import distill as td
    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.models import zoo
    student = zoo.init_student("sp_resnet18", 0, device=dev)
    teacher = zoo.load_model("superpoint_pretrained", device=dev)
    s_fn, t_fn = zoo.apply_fn(student), zoo.apply_fn(teacher)
    t_params = dict(teacher.state_dict())
    params = {k: v.clone() for k, v in student.state_dict().items()}
    tx = tt.Adam(tt.cosine_decay_schedule(1e-3, 60, alpha=0.05))
    carry = [(params, tx.init(params), {k: v.clone()
                                        for k, v in params.items()})]
    step = td.build_distill_step(s_fn, t_fn, t_params, frames, b, h, w,
                                 tx.lr, clean_prob=0.25)

    def whole():
        carry[0], aux = step(carry[0], generator=gen)
        return float(aux["loss"])

    def staged():
        p, opt, _ = carry[0]
        ms = {}
        images, ms["augment"] = timed(lambda: td.augment_batch(
            frames, b, h, w, 0.25, generator=gen))

        def teach():
            with torch.no_grad():
                return t_fn(t_params, images)
        t_out, ms["teacher_forward"] = timed(teach)
        names = tt.trainable(p)
        leaves = {k: (v.detach().requires_grad_() if k in names
                      else v.detach()) for k, v in p.items()}
        with torch.enable_grad():
            (loss, _), ms["student_forward_and_loss"] = timed(
                lambda: td.distill_loss(s_fn, leaves, t_out["output_det"],
                                        t_out["output_desc"], images))
            grads, ms["backward"] = timed(lambda: dict(zip(
                names, torch.autograd.grad(loss, [leaves[k]
                                                  for k in names]))))
        _, ms["adam"] = timed(lambda: tx.update(grads, opt, p))
        return ms

    return whole, staged


def finetune_step_parts(dev, gen):
    import torch

    from spsvo_tpu_torch import training as tt
    from spsvo_tpu_torch.io.homography import make_homographic_batch
    from spsvo_tpu_torch.models import zoo
    model = zoo.load_model("superpoint_pretrained", device=dev)
    apply_fn = zoo.apply_fn(model)
    state = [tt.init_train_state(apply_fn, dict(model.state_dict()), 1e-4)]
    x = torch.rand((8, 120, 392, 1), generator=gen, device=dev)
    xy = torch.rand((8, 512, 2), generator=gen, device=dev) * torch.tensor(
        [392.0, 120.0], device=dev)
    valid = torch.rand((8, 512), generator=gen, device=dev) < 0.6

    def whole():
        batch = make_homographic_batch(x, xy, valid, generator=gen)
        state[0], m = tt.train_step(state[0], batch, apply_fn=apply_fn,
                                    lr=1e-4)
        return float(m["loss"])

    def staged():
        ms = {}
        batch, ms["homographic_batch"] = timed(
            lambda: make_homographic_batch(x, xy, valid, generator=gen))
        p = state[0].params
        names = tt.trainable(p)
        leaves = {k: (v.detach().requires_grad_() if k in names
                      else v.detach()) for k, v in p.items()}
        with torch.enable_grad():
            (loss, _), ms["forward_and_loss"] = timed(
                lambda: tt.total_loss(apply_fn, leaves, batch))
            grads, ms["backward"] = timed(lambda: dict(zip(
                names, torch.autograd.grad(loss, [leaves[k]
                                                  for k in names]))))
        _, ms["adam"] = timed(lambda: tt.make_optimizer(1e-4).update(
            grads, state[0].opt_state, p))
        return ms

    return whole, staged


def report(name, whole, staged, steps, top, bound):
    import torch
    for _ in range(2):
        whole()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ms = [timed(whole)[1] for _ in range(steps)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stages = [staged() for _ in range(steps)]
    split = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
    table = kernel_table(whole, top)
    median = statistics.median(ms)
    # busy share: device time of a step over an unprofiled step's wall time
    print(json.dumps({"path": name, "median_ms_per_step": median,
                      "conv_bound_ms": bound,
                      "share_of_bound": bound / median,
                      "ms_per_step": ms, "stage_ms": split,
                      "stage_sum_ms": sum(split.values()),
                      "peak_memory_gb": peak_gb,
                      "device_busy_share":
                          table["device_ms_per_step"] / median,
                      **table}), flush=True)


def conv_probe(dev, reps: int = 5):
    """The widest conv of both trunks, 64 -> 64 channels 3x3 at 120x392 on
    16 images (VGG conv1b, ResNet layer1), forward alone: device ms per call
    without and with autograd recording it, and with an input in the
    channels-last layout, and the kernels cuDNN ran."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    x = torch.rand((16, 64, 120, 392), device=dev)
    w = torch.randn((64, 64, 3, 3), device=dev) * 0.06
    out = {}
    for name, grad, layout in (
            ("no_grad", False, torch.contiguous_format),
            ("autograd", True, torch.contiguous_format),
            ("autograd_channels_last", True, torch.channels_last)):
        xi = x.clone(memory_format=layout).requires_grad_(grad)
        wi = w.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            for _ in range(2):
                F.conv2d(xi, wi, None, 1, 1)
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                F.conv2d(xi, wi, None, 1, 1)
            end.record()
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                F.conv2d(xi, wi, None, 1, 1)
                sync()
        out[name] = {"ms": start.elapsed_time(end) / reps,
                     "kernels": sorted({ev.key[:60] for ev in
                                        prof.key_averages()
                                        if ev.device_type.name == "CUDA"})}
    return out


def main() -> None:
    import torch

    from spsvo_tpu_torch import distill as td
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    frames = torch.as_tensor(np.random.default_rng(0).random(
        (28, 375, 1242), np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for h, w, b in td.DEFAULT_RESOLUTIONS:
        report(f"distill_{h}x{w}_b{b}",
               *distill_step_parts(dev, frames, h, w, b, gen), args.steps,
               args.top, bound_ms(b, b, "sp_resnet18",
                                  "superpoint_pretrained", h, w))
    # the fine-tune's batch holds 8 images and their 8 warps
    report("finetune_120x392_b8", *finetune_step_parts(dev, gen), args.steps,
           args.top, bound_ms(16, 0, "superpoint_pretrained",
                              "superpoint_pretrained", 120, 392))
    print(json.dumps({"path": "conv1b_forward_16x64x120x392",
                      **conv_probe(dev)}), flush=True)
    torch.backends.cudnn.benchmark = True
    whole, _ = distill_step_parts(dev, frames, 120, 392, 16, gen)
    for _ in range(3):
        whole()
    ms = [timed(whole)[1] for _ in range(args.steps)]
    print(json.dumps({"path": "distill_120x392_b16_cudnn_benchmark",
                      "median_ms_per_step": statistics.median(ms),
                      "ms_per_step": ms}), flush=True)
    torch.backends.cudnn.benchmark = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
