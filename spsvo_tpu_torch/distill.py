"""Dense distillation: train a SuperPoint family to reproduce a frozen
teacher, the counterpart of `spsvo_tpu.distill`.

The JAX package gave the families whose weights it lacked (the
hand-defined `superpoint_pretrained`, `sp_sparse`, `sp_resnet18`) real
weights this way: a student distilled from the imported `sp_mbv1` teacher on
real frames, diversified by random crops, homographies and photometric
jitter on the device. `distill()` keeps that recipe and its default teacher
(`sp_mbv1`, whose ONNX file `models.zoo.load_model` needs); any family can
teach, e.g. the committed `superpoint_pretrained`.

Distillation losses (per augmented image, student vs frozen teacher):
  * detector: KL(teacher cell-softmax || student log-softmax) over the 65
    channels, weighted toward the teacher's keypoint-bearing cells;
  * descriptor: 1 - cosine between the L2-normalised 256-d cell
    descriptors;
  * optional L1 weight sparsity (the `sp_sparse` family).

Random draws are inputs (`AugmentDraws`), made from an explicit
`torch.Generator` or given, so a test can inject the JAX package's.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spsvo_tpu_torch.io.homography import (HomographyDraws, draw_homographies,
                                           homography_from_draws, warp_image)
from spsvo_tpu_torch.models import zoo
from spsvo_tpu_torch.training import (Adam, cosine_decay_schedule,
                                      value_and_grad)

DEFAULT_RESOLUTIONS = ((120, 392, 16), (240, 784, 6), (360, 1176, 2))


def load_sample_frames(img_dir: str, normalize: bool = True) -> np.ndarray:
    """All frames in a directory as (N, H, W) float32, in [0, 1] when
    `normalize`. Reads 8-bit grayscale PNGs with the port's decoder
    (`io/png.py`); a JPEG (which the JAX package reads through OpenCV)
    raises."""
    from spsvo_tpu_torch.io.png import read_gray8
    files = sorted(f for f in os.listdir(img_dir)
                   if f.endswith((".png", ".jpg")))
    jpgs = [f for f in files if f.endswith(".jpg")]
    if jpgs:
        raise ValueError(f"{img_dir}: {len(jpgs)} JPEG files ({jpgs[0]}, "
                         "...): the port decodes 8-bit grayscale PNG only")
    arr = np.stack([read_gray8(os.path.join(img_dir, f))
                    for f in files]).astype(np.float32)
    return arr / 255.0 if normalize else arr


def _area_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's INTER_AREA table of one axis (`computeResizeAreaTab`):
    (dst, taps) source indices and float32 weights, in OpenCV's order
    (left partial pixel, whole pixels, right partial pixel); unused taps
    have weight 0."""
    scale = src / dst
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    n = max(len(t) for t in rows)
    idx = np.zeros((dst, n), np.int64)
    wgt = np.zeros((dst, n), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wgt[d, j] = s, np.float32(a)
    return idx, wgt


def resize_area(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    """A float32 (H, W) image shrunk to (dst_h, dst_w) by pixel-area
    weights, as `cv2.resize(..., interpolation=cv2.INTER_AREA)` does: every
    destination pixel averages the source area it covers, partial pixels
    weighted by the fraction covered (separable: rows of the horizontal
    sums, in OpenCV's order of taps). `F.interpolate(mode="area")` is
    adaptive average pooling, which differs at non-integer ratios.
    Shrinking only: OpenCV's INTER_AREA interpolates when it enlarges."""
    h, w = img.shape
    if dst_h > h or dst_w > w:
        raise ValueError(f"resize_area shrinks only: ({h}, {w}) -> "
                         f"({dst_h}, {dst_w})")
    img = img.astype(np.float32)
    xi, xw = _area_taps(w, dst_w)
    yi, yw = _area_taps(h, dst_h)
    buf = np.zeros((h, dst_w), np.float32)
    for j in range(xi.shape[1]):
        buf += img[:, xi[:, j]] * xw[:, j]
    out = buf[yi[:, 0]] * yw[:, :1]
    for j in range(1, yi.shape[1]):
        out += buf[yi[:, j]] * yw[:, j:j + 1]
    return out


def synthetic_training_frames(seed: int = 0, n_corridor: int = 24,
                              n_drive: int = 12, h: int = 375,
                              w: int = 1242,
                              cache_dir: Optional[str] = None) -> np.ndarray:
    """Extra distillation imagery from the port's synthetic renderers
    (`eval/synthetic.py`, no OpenCV): corridor and plane drives with varied
    texture scales, blob sizes and trajectories, (N, h, w) float32 in
    [0, 1], the JAX package's recipe draw for draw. Cached as an .npz under
    `cache_dir` (default `spsvo_tpu_torch/.data_cache/`): ray casting takes
    seconds per frame on a CPU."""
    from spsvo_tpu_torch.eval.synthetic import (synthetic_corridor,
                                                synthetic_drive)
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".data_cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(
        cache_dir,
        f"torch_distill_synth_v2_{seed}_{n_corridor}_{n_drive}_{h}x{w}.npz")
    if os.path.exists(cache):
        with np.load(cache) as data:
            return data["frames"]
    out = []
    rng = np.random.default_rng(seed)
    per = 4
    for _ in range(0, n_corridor, per):
        frames, _, _, _ = synthetic_corridor(
            rng, n_frames=per, h=h, w=w,
            forward_per_frame=rng.uniform(1.0, 3.0),
            yaw_rate=rng.uniform(-0.02, 0.02),
            tex_scale=rng.uniform(24.0, 96.0),
            blob_sigma=rng.uniform(4.0, 12.0))
        out += [f[0] for f in frames]
    for _ in range(0, n_drive, per):
        frames, _, _, _ = synthetic_drive(
            rng, n_frames=per, h=h, w=w, depth=rng.uniform(8.0, 40.0),
            forward_per_frame=0.3, yaw_rate=rng.uniform(-0.01, 0.01))
        out += [f[0] for f in frames]
    arr = np.stack(out).astype(np.float32) / 255.0
    np.savez_compressed(cache, frames=arr)
    return arr


class AugmentDraws(NamedTuple):
    """The random draws of one `augment_batch` call, B samples: source
    frame `fidx`, crop corner (`y0`, `x0`), homography, contrast in
    [0.6, 1.4], brightness in [-0.15, 0.15], standard-normal `noise`
    (B, h, w, 1; scaled by 0.02) and the `clean` flags (B,)."""
    fidx: torch.Tensor
    y0: torch.Tensor
    x0: torch.Tensor
    homography: HomographyDraws
    contrast: torch.Tensor
    brightness: torch.Tensor
    noise: torch.Tensor
    clean: torch.Tensor


def draw_augment(n_frames: int, frame_h: int, frame_w: int, batch: int,
                 h: int, w: int, generator: torch.Generator,
                 clean_prob: float = 0.0, device=None) -> AugmentDraws:
    """One call's draws, made on the generator's device and moved to
    `device` (default: the generator's)."""
    device = generator.device if device is None else device
    gdev = generator.device

    def randint(high):
        return torch.randint(0, high, (batch,), generator=generator,
                             device=gdev).to(device)

    def uniform(lo, hi):
        u = torch.rand((batch,), generator=generator, device=gdev)
        return (lo + (hi - lo) * u).to(device)

    fidx = randint(n_frames)
    y0 = randint(max(frame_h - h, 0) + 1)
    x0 = randint(max(frame_w - w, 0) + 1)
    hom = draw_homographies(batch, h, w, generator, max_scale=0.3,
                            max_translation=0.1, max_rotation=0.25,
                            max_perspective=0.001, device=device)
    contrast = uniform(0.6, 1.4)
    brightness = uniform(-0.15, 0.15)
    noise = torch.randn((batch, h, w, 1), generator=generator,
                        device=gdev).to(device)
    clean = (torch.rand((batch,), generator=generator, device=gdev)
             < clean_prob).to(device)
    return AugmentDraws(fidx, y0, x0, hom, contrast, brightness, noise, clean)


def augment_batch(frames: torch.Tensor, batch: int, h: int, w: int,
                  clean_prob: float = 0.0, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[AugmentDraws] = None) -> torch.Tensor:
    """(B, h, w, 1) augmented crops of full-resolution frames (N, H, W).

    Per sample: a random source frame, a random crop, a random homography
    warp (scale / rotation / translation / perspective), brightness and
    contrast jitter, additive noise; a `clean` sample (probability
    `clean_prob`) is the plain crop, as the held-out agreement metric scores
    clean frames. The draws are `draws`, else drawn from `generator`."""
    n, H, W = frames.shape
    if draws is None:
        draws = draw_augment(n, H, W, batch, h, w, generator, clean_prob,
                             device=frames.device)
    dev = frames.device
    rows = draws.y0[:, None] + torch.arange(h, device=dev)
    cols = draws.x0[:, None] + torch.arange(w, device=dev)
    crops = frames[draws.fidx[:, None, None], rows[:, :, None],
                   cols[:, None, :]]                              # (B, h, w)
    Hs = homography_from_draws(draws.homography, h, w)
    warped = warp_image(crops[..., None], Hs)                 # (B, h, w, 1)
    bc = draws.contrast[:, None, None, None]
    br = draws.brightness[:, None, None, None]
    out = torch.clamp(warped * bc + br + 0.02 * draws.noise, 0.0, 1.0)
    return torch.where(draws.clean[:, None, None, None], crops[..., None],
                       out)


def distill_loss(student_fn, s_params, teacher_det: torch.Tensor,
                 teacher_desc: torch.Tensor, images: torch.Tensor,
                 sparsity: float = 0.0, peak_weight: float = 4.0,
                 temperature: float = 1.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = student_fn(s_params, images)
    # detector: KL(teacher || student) over the 65-way cell distribution,
    # weighted toward keypoint-bearing cells (weight = 1 + pw * P(not
    # dustbin) under the teacher at T=1, whatever the KD temperature)
    t_prob = torch.softmax(teacher_det, dim=-1)
    if temperature != 1.0:
        # KD softening: KL between T-scaled distributions, times T^2 so the
        # gradient's size stays comparable across temperatures
        t_prob_T = torch.softmax(teacher_det / temperature, dim=-1)
        s_logp = torch.log_softmax(out["output_det"] / temperature, dim=-1)
        kl = (temperature ** 2) * torch.sum(
            t_prob_T * (torch.log(t_prob_T + 1e-9) - s_logp), dim=-1)
    else:
        s_logp = torch.log_softmax(out["output_det"], dim=-1)
        kl = torch.sum(t_prob * (torch.log(t_prob + 1e-9) - s_logp), dim=-1)
    wcell = 1.0 + peak_weight * (1.0 - t_prob[..., -1])
    l_det = torch.sum(kl * wcell) / torch.sum(wcell)
    # descriptor: cosine distance between unit vectors
    l_desc = torch.mean(1.0 - torch.sum(out["output_desc"] * teacher_desc,
                                        dim=-1))
    loss = l_det + l_desc
    if sparsity > 0.0:
        # sorted names: the order in which the JAX package sums them
        convs = [s_params[k] for k in sorted(s_params)
                 if k.endswith(".weight") and s_params[k].ndim == 4]
        l1 = sum(torch.sum(torch.abs(v)) for v in convs)
        loss = loss + sparsity * l1 / sum(v.numel() for v in convs)
    return loss, {"det_kl": l_det, "desc_cos": l_desc}


def build_distill_step(student_fn, teacher_fn, t_params,
                       frames: torch.Tensor, batch: int, h: int, w: int,
                       lr, sparsity: float = 0.0, ema: float = 0.0,
                       clean_prob: float = 0.0, peak_weight: float = 4.0,
                       temperature: float = 1.0):
    """One distillation step: augment -> teacher forward (frozen) ->
    student update. Returns `step(carry, *, generator=None, draws=None) ->
    (carry, aux)` with carry = (params, opt_state, ema_params).

    `ema > 0` keeps an exponential moving average of the student's weights
    in the carry (validated and exported instead of the raw weights);
    `ema = 0` makes ema_params a copy of the params."""
    tx = Adam(lr)

    def step(carry, *, generator=None, draws=None):
        params, opt_state, ema_params = carry
        images = augment_batch(frames, batch, h, w, clean_prob,
                               generator=generator, draws=draws)
        with torch.no_grad():
            t_out = teacher_fn(t_params, images)
        (loss, aux), grads = value_and_grad(
            lambda p: distill_loss(student_fn, p, t_out["output_det"],
                                   t_out["output_desc"], images, sparsity,
                                   peak_weight=peak_weight,
                                   temperature=temperature), params)
        params, opt_state = tx.update(grads, opt_state, params)
        ema_params = {k: ema * ema_params[k] + (1.0 - ema) * v
                      for k, v in params.items()}
        aux["loss"] = loss
        return (params, opt_state, ema_params), aux

    return step


def keypoint_agreement(student_fn, s_params, teacher_fn, t_params,
                       frames: np.ndarray, h: int, w: int, k: int = 512,
                       conf_thresh: float = 0.015, radius: float = 2.0
                       ) -> Dict[str, float]:
    """Held-out validation: the fraction of student keypoints within
    `radius` px of a teacher keypoint (precision) and vice versa (recall),
    plus the mean count, through the pipeline's postprocess. Runs on the
    device of the student's parameters."""
    from spsvo_tpu_torch.ops.image import preprocess_image_np
    from spsvo_tpu_torch.ops.postprocess import extract_keypoints

    dev = next(iter(s_params.values())).device
    pre = np.stack([preprocess_image_np((f * 255).astype(np.uint8), h, w)
                    for f in frames])
    x = torch.as_tensor(pre, device=dev)[..., None]

    def kps(fn, params):
        with torch.no_grad():
            out = fn(params, x)
            kp = extract_keypoints(out["output_det"], out["output_desc"], k=k,
                                   conf_thresh=conf_thresh, nms_radius=4,
                                   border=4)
        return kp.xy.cpu().numpy(), kp.valid.cpu().numpy()

    s_xy, s_valid = kps(student_fn, s_params)
    t_xy, t_valid = kps(teacher_fn, t_params)
    precs, recs, counts = [], [], []
    for i in range(len(frames)):
        sxy = s_xy[i][s_valid[i]]
        txy = t_xy[i][t_valid[i]]
        counts.append(len(sxy))
        if len(sxy) == 0 or len(txy) == 0:
            precs.append(0.0)
            recs.append(0.0)
            continue
        d = np.linalg.norm(sxy[:, None] - txy[None], axis=-1)
        precs.append(float((d.min(axis=1) <= radius).mean()))
        recs.append(float((d.min(axis=0) <= radius).mean()))
    return {"precision": float(np.mean(precs)),
            "recall": float(np.mean(recs)),
            "mean_keypoints": float(np.mean(counts))}


def distill(student_prefix: str, *, teacher_prefix: str = "sp_mbv1",
            img_dir: Optional[str] = None, steps: int = 3000,
            batch: int = 16, h: int = 120, w: int = 392, lr: float = 1e-3,
            seed: int = 0, holdout: int = 4, log_every: int = 100,
            frames: Optional[np.ndarray] = None, resolutions=None,
            use_synthetic: bool = True, ema: float = 0.0,
            clean_prob: float = 0.0, peak_weight: float = 4.0,
            temperature: float = 1.0, select_best: bool = True, log=print,
            device="cuda") -> Tuple[Dict[str, torch.Tensor], List[Dict]]:
    """Distill `student_prefix` (fresh weights, `zoo.init_student(seed)`)
    from the frozen fp32 `teacher_prefix`, on `device`.

    Frames: `frames` ((N, H, W) float32 in [0, 1]), else every PNG of
    `img_dir` (`load_sample_frames`); the last `holdout` are the held-out
    validation frames. `resolutions`: (h, w, batch) triples cycled step by
    step (`DEFAULT_RESOLUTIONS`: students must fit the teacher at all three
    of the reference's engine resolutions); None trains at (h, w, batch).
    `use_synthetic` adds `synthetic_training_frames` to the training pool
    (shrunk to the pool's frame size by `resize_area` if it differs). The
    learning rate follows optax's cosine decay to 5% over `steps`.

    `clean_prob`, `peak_weight`, `temperature` tune the augmentation and the
    KD loss (`augment_batch`, `distill_loss`); `sp_sparse` adds L1 sparsity
    1e-4. Every 10 * `log_every` steps and at the last, the held-out
    keypoint agreement at 120x392 (`keypoint_agreement`) of the weights that
    would be exported (the EMA's); `select_best` returns the checkpoint of
    highest min(precision, recall) instead of the final weights.

    Returns (student params, history): a row per `log_every` steps with the
    step, the losses, the agreement where it was measured and `elapsed_s`
    (seconds since the first step began, read after the row's losses and
    agreement reach the host, so a validated row's time includes its
    validation, as in the JAX package; not rounded); the last row records
    `best_step` / `best_score` under `select_best`. Random draws come from a
    generator on `device` seeded with `seed + 1`."""
    sparsity = 1e-4 if student_prefix == "sp_sparse" else 0.0
    teacher = zoo.load_model(teacher_prefix, device=device)
    teacher_fn = zoo.apply_fn(teacher)
    t_params = dict(teacher.state_dict())
    student = zoo.init_student(student_prefix, seed, device)
    student_fn = zoo.apply_fn(student)
    s_params = {k: v.clone() for k, v in student.state_dict().items()}

    if frames is None:
        if img_dir is None:
            raise ValueError("distill needs frames= or img_dir=")
        frames = load_sample_frames(img_dir)
    train_pool = frames[:-holdout] if holdout else frames
    val_frames = frames[-holdout:] if holdout else frames[-2:]
    if use_synthetic:
        synth = synthetic_training_frames(seed=seed)
        if synth.shape[1:] != train_pool.shape[1:]:
            ph, pw = train_pool.shape[1:3]
            synth = np.stack([resize_area(f, ph, pw) for f in synth])
        train_pool = np.concatenate([train_pool, synth.astype(np.float32)])
    train_frames = torch.as_tensor(np.asarray(train_pool, np.float32),
                                   device=device)

    res_list = [(h, w, batch)] if resolutions is None else list(resolutions)
    lr_sched = cosine_decay_schedule(lr, max(steps, 1), alpha=0.05)
    opt_state = Adam(lr_sched).init(s_params)
    step_fns = [build_distill_step(student_fn, teacher_fn, t_params,
                                   train_frames, b_, h_, w_, lr_sched,
                                   sparsity, ema=ema, clean_prob=clean_prob,
                                   peak_weight=peak_weight,
                                   temperature=temperature)
                for (h_, w_, b_) in res_list]

    history: List[Dict] = []
    carry = (s_params, opt_state, {k: v.clone() for k, v in s_params.items()})
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    t0 = time.perf_counter()
    best_score, best_step, best_params = -1.0, -1, None
    for i in range(steps):
        carry, aux = step_fns[i % len(step_fns)](carry, generator=gen)
        if i % log_every == 0 or i == steps - 1:
            row = {"step": i, **{k: float(v) for k, v in aux.items()}}
            if i % (10 * log_every) == 0 or i == steps - 1:
                # validated at the flagship 120x392 on the held-out frames:
                # the weights that would be exported, the EMA's
                row.update(keypoint_agreement(
                    student_fn, carry[2], teacher_fn, t_params, val_frames,
                    120, 392))
                score = min(row["precision"], row["recall"])
                if select_best and score > best_score:
                    best_score, best_step = score, i
                    best_params = {k: v.clone() for k, v in carry[2].items()}
            row["elapsed_s"] = time.perf_counter() - t0
            history.append(row)
            log(f"[{student_prefix}] " + " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items()))
    if select_best and best_params is not None:
        history[-1]["best_step"] = best_step
        history[-1]["best_score"] = best_score
        return best_params, history
    return carry[2], history
