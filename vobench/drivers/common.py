"""What the drivers share: the drive's frames and noise from the seed, the
observations a traced window hands the per-layer readers, and the
reference for a run's configuration."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from vobench import compare, flops, render, spec


def drive(run, mix: Dict, n_frames: int, stream: int):
    """A corridor drive of `n_frames` from the run's seed and `stream`:
    (frames (N, 2, H, W) uint8 on the device, ground truth, P_l, P_r)."""
    return render.corridor(
        run.torch_seed(stream), n_frames, mix["height"], mix["width"],
        mix["forward_m"], mix["yaw_rad"], mix["tex_px"], mix["blob_sigma"],
        mix["tex_scale"], run.device)


def rendered(run) -> None:
    """The drive is on the host: the device memory its rendering took is
    released and the peak is counted from here, so `memory_peak_bytes` is
    the program's (with the noise and the harness's few buffers)."""
    if run.cuda:
        torch.cuda.synchronize(run.device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(U)) on the generator's device."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def median(xs: Sequence[float]) -> float:
    return float(np.median(np.asarray(xs, np.float64)))


def deciles(xs: Sequence[float]) -> List[float]:
    """The minimum, the nine deciles and the maximum of `xs`."""
    if not xs:
        return []
    return np.quantile(np.asarray(xs, np.float64),
                       np.linspace(0.0, 1.0, 11)).tolist()


def accuracy(worlds: List[np.ndarray], gt: List[np.ndarray]) -> Dict:
    out = compare.accuracy(worlds, gt) if len(worlds) >= 2 else {}
    return dict(out, frames=len(worlds))


def trunk_precision(cfg: Dict) -> str:
    return {"BF16": "bf16", "FP32": "fp32"}[cfg["vo_config"]["precision"]]


def observed(traced: Dict, steps: int, frames: int, cfg: Dict,
             images_per_step: int) -> Dict:
    """What the per-layer readers read from a traced window of `steps`
    steps (frames or segments) and `frames` frames: the trace, and the
    trunk's work per step counted from its layer shapes."""
    vc = cfg["vo_config"]
    prec = trunk_precision(cfg)
    h, w = vc["image_height"], vc["image_width"]
    return {"trace": traced, "steps": steps, "frames": frames,
            "precision": prec,
            "conv_least_s": flops.least_ms(cfg["arch"], h, w,
                                           images_per_step, prec) / 1e3,
            "model_flops_per_frame": flops.total_ops(cfg["arch"], h, w, 2),
            "peak_flops": flops.peaks()[f"{prec}_flops_per_s"]}


def reference(run, precision: str = ""):
    """The reference for the run's configuration on its device, its trunk
    in the configuration's precision unless `precision` says another."""
    from vobench.reference import config as rc
    from vobench.reference.models import load_weights
    from vobench.reference.vo import Reference
    kinds = {"detector_type": rc.DetectorType,
             "descriptor_type": rc.DescriptorType,
             "matcher_type": rc.MatcherType, "selector_type": rc.SelectorType,
             "precision": rc.Precision}
    fields = {k: kinds[k](v) if k in kinds else v
              for k, v in run.cfg["vo_config"].items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights = load_weights(os.path.join(spec.ROOT, run.cfg["weights"]),
                           run.device)
    return Reference(rc.VOConfig(**fields), run.cfg["arch"], weights,
                     run.device, precision or run.cfg["reference_precision"])
