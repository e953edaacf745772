"""Where the device-resident classic front end's time goes, stage by stage.

Times each stage of `ops/orb.py` (and the AKAZE scale space) alone, on one
chunk of `--images` 375x1242 corridor images at every pyramid level the ORB
front end visits (8 levels, scale 1.2), with the keypoints the detector
itself finds there; then the whole front ends, and Hamming matching at the
hybrid's 2N-1 = 63 entries. Each time is device time per call from a CUDA
graph of repeated calls (CUDA events), so the host's launch cost is not in
it; "eager_ms" beside a whole front end is the host clock around one eager
call ending in a synchronise.

    python tools/torch_classic_profile.py [--images 16]

One JSON object per line; the last line is the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def graph_ms(fn, iters: int = 5) -> float:
    """Device time per call of `fn` from a CUDA graph of `iters` calls."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.no_grad():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def main() -> None:
    import torch

    from spsvo_tpu_torch.eval.synthetic import synthetic_corridor
    from spsvo_tpu_torch.ops import akaze, matching, orb
    from spsvo_tpu_torch.ops.image import bilinear_resize

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=16)
    args = ap.parse_args()
    dev = torch.device("cuda")
    m = args.images
    frames, _, _, _ = synthetic_corridor(
        np.random.default_rng(42), n_frames=(m + 1) // 2, h=375, w=1242)
    imgs = torch.as_tensor(np.stack(
        [im for pair in frames for im in pair][:m])).to(dev).float() / 255.0
    h, w = imgs.shape[-2:]
    k, levels, border = 512, 8, 31
    quotas = orb.level_quotas(h, w, k, levels, 1.2, border)
    shapes = orb._level_shapes(h, w, levels, 1.2)

    totals: dict = {}
    level_img = torch.round(imgs * 255.0)
    for lvl in range(levels):
        if lvl > 0:
            prev = level_img
            level_img = bilinear_resize(prev, *shapes[lvl])
            resize = graph_ms(lambda: bilinear_resize(prev, *shapes[lvl]))
        else:
            resize = 0.0
        img = level_img
        rounded = torch.round(img)
        score = orb.fast_score_map(rounded, 20)
        xy, _, _ = orb.top_keypoints(score, quotas[lvl])
        cos, sin = orb.ic_orientation(img, xy)
        blur = orb.gaussian_blur7(img)
        row = {
            "resize": resize,
            "fast_score_map": graph_ms(
                lambda: orb.fast_score_map(rounded, 20)),
            "top_keypoints": graph_ms(
                lambda: orb.top_keypoints(score, quotas[lvl])),
            "ic_orientation": graph_ms(lambda: orb.ic_orientation(img, xy)),
            "gaussian_blur7": graph_ms(lambda: orb.gaussian_blur7(img)),
            "brief_descriptors": graph_ms(
                lambda: orb.brief_descriptors(blur, xy, cos, sin)),
            "brisk_descriptors": graph_ms(
                lambda: orb.brisk_descriptors(img, xy))}
        for name, ms in row.items():
            totals[name] = totals.get(name, 0.0) + ms
        print(json.dumps({"level": lvl, "shape": list(shapes[lvl]),
                          "quota": quotas[lvl], "images": m, "ms": row}),
              flush=True)
    print(json.dumps({"all_levels_ms": totals, "images": m,
                      "orb_brief_sum_ms": sum(
                          v for n, v in totals.items()
                          if n != "brisk_descriptors"),
                      "orb_brisk_sum_ms": sum(
                          v for n, v in totals.items() if n not in (
                              "ic_orientation", "gaussian_blur7",
                              "brief_descriptors"))}), flush=True)

    whole = {}
    for det, desc in (("orb", "brief"), ("orb", "brisk"),
                      ("shi_tomasi", "brief"), ("akaze", "mldb")):
        kw = dict(k=k, n_levels=levels, border=border, detector=det,
                  descriptor=desc)
        orb.orb_frontend_batch(imgs, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orb.orb_frontend_batch(imgs, **kw)
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        whole[f"{det}/{desc}"] = {
            "ms": graph_ms(lambda: orb.orb_frontend_batch(imgs, **kw), 2),
            "eager_ms": eager,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    scale_space = graph_ms(lambda: akaze.nonlinear_scale_space(imgs), 2)
    print(json.dumps({"front_end_ms": whole, "images": m,
                      "akaze_scale_space_ms": scale_space}), flush=True)

    # Hamming matching at the 32-frame hybrid's 63 entries, per bit width
    rng = np.random.default_rng(0)
    for bits in (256, 488, 512):
        q = torch.as_tensor(rng.random((63, k, bits)) < 0.5).to(dev).float()
        t = torch.as_tensor(rng.random((63, k, bits)) < 0.5).to(dev).float()
        v = torch.ones((63, k), dtype=torch.bool, device=dev)
        dist = matching.hamming_distance(q, t)
        print(json.dumps({
            "hamming_bits": bits, "entries": 63, "k": k,
            "distance_ms": graph_ms(lambda: matching.hamming_distance(q, t)),
            "select_nn_crosscheck_ms": graph_ms(
                lambda: matching.select_matches(dist, v, v, squared=False)),
        }), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
