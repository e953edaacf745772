"""Command-line entry point.

    python -m spsvo_tpu_torch.run --preset superpoint_jetson \
        --kitti-root /data/kitti_odometry --eval-id 5 --description myrun

    python -m spsvo_tpu_torch.run --preset superpoint_jetson --device cpu ...
    python -m spsvo_tpu_torch.run --compile-sweep --filter superpoint

    torchrun --nproc-per-node 4 -m spsvo_tpu_torch.run --mode hybrid \
        --kitti-root /data/kitti_odometry --eval-id 5

    python -m spsvo_tpu_torch.run --preset classic_orb --mode classic \
        --device cpu --kitti-root /data/kitti_odometry --eval-id 0
    python -m spsvo_tpu_torch.run --preset superpoint_jetson --device cpu \
        --kitti-root /data/kitti_odometry --max-frames 8 --viz-dir viz/

Artefacts land in kitti_results/<description>/NN_pred.txt and
kitti_latency_csvs/<machine>/, as the JAX package's `spsvo_tpu.run` writes
them. Runs on the CUDA device unless `--device cpu` is given. The JAX CLI
shards the whole-sequence modes over the devices its runtime has; this one
over the ranks its launcher started: under `torchrun` the hybrid, batch
and orb modes run frame-sharded, one rank per GPU (`cuda:LOCAL_RANK`, NCCL;
gloo with `--device cpu`), and rank 0 writes the pose file. The host
classic route (`--mode classic`, a classic preset without device_classic in
frame mode) and `--viz-dir` need OpenCV (cv2).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _build_vo(cfg, device):
    if cfg.is_classic:
        from spsvo_tpu_torch.frontend_classic import ClassicVisualOdometry
        return ClassicVisualOdometry(cfg, device=device)
    from spsvo_tpu_torch.pipeline import VisualOdometry
    return VisualOdometry(cfg, device=device)


def cmd_eval(args) -> int:
    from spsvo_tpu_torch.eval import harness
    from spsvo_tpu_torch.presets import PRESETS
    cfg = PRESETS[args.preset]()
    if args.model:
        cfg = dataclasses.replace(cfg, model_name_prefix=args.model)
    if args.landmark_fusion:
        cfg = dataclasses.replace(cfg, landmark_fusion=True)
    if not args.sample_images and args.kitti_root is None:
        print("need --kitti-root or --sample-images", file=sys.stderr)
        return 2
    if args.mode == "orb":
        # the device-resident classic mode: any preset opts in. Detector
        # and descriptor are set unless the preset already picked a
        # device-supported classic detector (SHI_TOMASI keeps GFTT)
        from spsvo_tpu_torch.config import DescriptorType, DetectorType
        det = (cfg.detector_type
               if cfg.is_classic and cfg.detector_type in
               (DetectorType.ORB, DetectorType.SHI_TOMASI)
               else DetectorType.ORB)
        cfg = dataclasses.replace(
            cfg, is_classic=True, device_classic=True, detector_type=det,
            descriptor_type=DescriptorType.ORB)
    if cfg.is_classic and args.mode not in ("frame", "classic", "orb"):
        print("classic configs run --mode frame, --mode classic "
              "(host-detect-all + fused device geometry) or --mode orb "
              "(fully device-resident ORB)", file=sys.stderr)
        return 2
    if not cfg.is_classic and args.mode == "classic":
        print("--mode classic is for classic configs; CNN configs use "
              "--mode hybrid/batch", file=sys.stderr)
        return 2
    if args.instrument and args.mode != "frame":
        print("--instrument times the per-frame stage-split programs: use "
              "--mode frame", file=sys.stderr)
        return 2
    if cfg.landmark_fusion and args.mode not in ("frame", "hybrid", "orb"):
        print("--landmark-fusion needs the sequential prior chain: use "
              "--mode frame or --mode hybrid (the batch/classic modes "
              "solve frames independently and would silently ignore it)",
              file=sys.stderr)
        return 2
    if args.sample_images:
        print("--sample-images reads the reference project's bundled "
              "sample frames with OpenCV; neither ships with this package: "
              "use --kitti-root", file=sys.stderr)
        return 2
    if args.viz_dir is not None and args.mode != "frame":
        print("--viz-dir streams per-frame image topics: use --mode frame",
              file=sys.stderr)
        return 2
    # fused modes build their own device program from cfg
    vo = _build_vo(cfg, args.device) if args.mode == "frame" else cfg
    res = harness.run_eval_id(
        vo, args.kitti_root, args.eval_id, results_dir=args.results_dir,
        latency_dir=args.latency_dir, description=args.description,
        max_frames=args.max_frames, mode=args.mode, viz_dir=args.viz_dir,
        instrument_stages=args.instrument, device=args.device)
    print(f"seq {args.eval_id}: {len(res.poses)} frames, "
          f"{res.fps:.1f} FPS")
    if args.ground_truth:
        scores = harness.score_against_ground_truth(res.poses,
                                                    args.ground_truth)
        print(json.dumps(scores, indent=1))
    return 0


def cmd_compile_sweep(args) -> int:
    """Build both CUDA kernels (on a CUDA device) and run the sequence scan
    on two zero frames for every config of the 72-config grid: each config's
    program is built and exercised once, the engine-generation role. A
    config whose model cannot load (an ONNX family without its file) counts
    as failed."""
    import torch

    from spsvo_tpu_torch.config import sweep_configs
    from spsvo_tpu_torch.parallel.sharding import build_sequence_scan
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from spsvo_tpu_torch import _build
        for name in ("match_nn", "fused_solve"):
            _build.load(name)
    ok, failed = 0, 0
    P = torch.tensor([[718.0, 0, 300.0, 0], [0, 718.0, 90.0, 0],
                      [0, 0, 1.0, 0]])
    P_r = P.clone()
    P_r[0, 3] = -386.0
    for cfg in sweep_configs():
        if args.filter and args.filter not in cfg.config_string:
            continue
        try:
            scan = build_sequence_scan(cfg, device=dev)
            images = torch.zeros((2, 2, cfg.image_height, cfg.image_width),
                                 device=dev)
            world, _ = scan(images, P, P_r,
                            generator=torch.Generator(dev).manual_seed(0))
            world.cpu()
            ok += 1
            print(f"compiled {cfg.config_string}")
        except Exception as e:   # count and go on with the grid
            failed += 1
            print(f"FAILED {cfg.config_string}: {e}", file=sys.stderr)
    print(f"{ok} compiled, {failed} failed")
    return 1 if failed else 0


def main(argv=None) -> int:
    from spsvo_tpu_torch.presets import PRESETS
    p = argparse.ArgumentParser(prog="spsvo_tpu_torch.run",
                                description=__doc__)
    p.add_argument("--preset", default="flagship_tpu",
                   choices=sorted(PRESETS),
                   help="config preset (see spsvo_tpu_torch.presets)")
    p.add_argument("--model", default=None, help="override model prefix")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--kitti-root", default=None)
    p.add_argument("--eval-id", type=int, default=0,
                   help="kitti_eval_id 0..13")
    p.add_argument("--description", default="default")
    p.add_argument("--results-dir", default="kitti_results")
    p.add_argument("--latency-dir", default="kitti_latency_csvs")
    p.add_argument("--ground-truth", default=None,
                   help="KITTI gt pose file to score against")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--instrument", action="store_true",
                   help="per-frame mode: time detect/match/solve as "
                        "separate stages so the latency CSV columns are "
                        "real; slower (one synchronisation per stage)")
    p.add_argument("--viz-dir", default=None,
                   help="write per-frame match/inlier PNGs here (frame mode "
                        "only; needs OpenCV)")
    p.add_argument("--mode", default="frame",
                   choices=("frame", "hybrid", "batch", "classic", "orb"),
                   help="execution mode: per-frame online API (per-frame "
                        "latency CSV), 'hybrid' = whole-sequence on-device "
                        "with exact online semantics, 'batch' = offline "
                        "throughput mode, 'classic' = OpenCV detection of "
                        "every frame on the host, then the feature hybrid "
                        "on the device (classic configs; needs OpenCV), "
                        "'orb' = the hybrid with the device-resident ORB "
                        "front end")
    p.add_argument("--landmark-fusion", action="store_true",
                   help="carry fused 3D landmarks across frames instead of "
                        "re-triangulating every frame")
    p.add_argument("--sample-images", action="store_true",
                   help="the bundled reference frames (unavailable here)")
    p.add_argument("--compile-sweep", action="store_true",
                   help="build the kernels and run every grid config once")
    p.add_argument("--filter", default="",
                   help="substring filter for --compile-sweep")
    args = p.parse_args(argv)
    if args.compile_sweep:
        return cmd_compile_sweep(args)
    return cmd_eval(args)


if __name__ == "__main__":
    raise SystemExit(main())
