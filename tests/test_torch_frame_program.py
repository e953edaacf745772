"""The per-frame programs behind `process` and `process_instrumented`
(`pipeline.OnlineVO`, one `StepProgram` per raw input shape) on the CPU,
where they run op by op: against the op-by-op step with explicit
preprocessing, bit for bit; the noise drawn ahead of the step against the
noise drawn inside the solve; the carried state across `process`,
`process_instrumented`, `process_stream` and `reset`; the output's copy;
and `process` against the JAX package's on its injected noise. The `gpu`
cases hold the captured graphs against the eager step on the card.

Sizes as in tests/test_torch_stream_modes.py: fp32, superpoint_pretrained,
96x320, K=256, 64 hypotheses, 64 solver lanes, 188x620 corridor frames,
seed 12; the device ORB route as in tests/test_torch_classic.py (K=256, 2
pyramid levels), its 150x496 frames resized on the device to 120x400.
One torch thread; about 40 s in one process."""
import dataclasses
import functools
import zlib

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import frontend_classic as tfc
from spsvo_tpu_torch import presets as tpresets
from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet,
                                    Precision as TPrecision,
                                    VOConfig as TCfg)
from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.geometry import se3
from spsvo_tpu_torch.ops import image as image_ops
from spsvo_tpu_torch.ops import pnp, solver as tsolver
from spsvo_tpu_torch.pipeline import (VisualOdometry, clone_output,
                                      init_state, state_leaves, vo_step)

SEED = 12
SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
ORB_SMALL = dict(is_classic=True, device_classic=True, image_height=120,
                 image_width=400, max_keypoints=256, orb_n_levels=2,
                 orb_edge_threshold=16, ransac_iterations=128,
                 solve_slots=128)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
ROUTES = {"flagship": {}, "landmark_refine": dict(landmark_refine=True),
          "reference_solve": dict(ransac_chunk=16, lm_unroll=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops per frame: with the suite's worker processes side
    by side, torch's default of one thread per core in each of them spends
    its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(**kw):
    return dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32, **kw)


def _orb_cfg():
    return TCfg(detector_type=TDet.ORB, descriptor_type=TDesc.ORB,
                **ORB_SMALL)


@functools.lru_cache(maxsize=None)
def _corridor(n, h=188, w=620):
    """(raw uint8 frames, P_l, P_r, gt)."""
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=h, w=w, tex_px=1024,
        twists=[TWIST] * (n - 1))
    return frames, P_l, P_r, gt


@functools.lru_cache(maxsize=None)
def _model():
    return VisualOdometry(_tcfg(), device="cpu").model


def _noise(cfg, n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return [pnp.gumbel_noise(tsolver.gumbel_shape(cfg), g, "cpu").numpy()
            for _ in range(n)]


def _raw(il, ir, P_l, P_r):
    return (torch.as_tensor(il), torch.as_tensor(ir),
            torch.as_tensor(np.asarray(P_l), dtype=torch.float32),
            torch.as_tensor(np.asarray(P_r), dtype=torch.float32))


def _eager_cnn(cfg, frames, P_l, P_r, noise=None, generator=None):
    """The eager reference: explicit preprocessing, then
    `vo_step` from the carried state; the noise given per frame or drawn
    inside the solve from `generator`. Returns (outputs, final state)."""
    state, outs = init_state(cfg, "cpu"), []
    with torch.no_grad():
        for f, (il, ir) in enumerate(frames):
            imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
                *_raw(il, ir, P_l, P_r), dst_h=cfg.image_height,
                dst_w=cfg.image_width)
            g = None if noise is None else torch.as_tensor(noise[f])
            state, out = vo_step(_model(), state, imgs, Pl2, Pr2, cfg=cfg,
                                 gumbel=g, generator=generator)
            outs.append(out)
    return outs, state


def _eager_orb(cfg, frames, P_l, P_r, noise):
    """The device ORB route's eager reference: the pair
    cropped and resized unnormalised, rounded to whole grey levels, then
    `classic_step`."""
    state = tfc.init_state_with_dim(cfg, 256, "cpu")
    outs = []
    with torch.no_grad():
        for f, (il, ir) in enumerate(frames):
            imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
                *_raw(il, ir, P_l, P_r), dst_h=cfg.image_height,
                dst_w=cfg.image_width, normalize=False)
            imgs = torch.round(imgs) / 255.0
            state, out = tfc.classic_step(state, imgs, Pl2, Pr2, cfg=cfg,
                                          gumbel=torch.as_tensor(noise[f]))
            outs.append(out)
    return outs, state


def _assert_outputs_equal(got, want, tag=""):
    assert torch.equal(got.T_curr_prev, want.T_curr_prev), tag
    for a, b in zip((*got.keypoints_left, *got.keypoints_right,
                     got.stereo_map, got.interframe_map, got.chain_valid,
                     got.inliers),
                    (*want.keypoints_left, *want.keypoints_right,
                     want.stereo_map, want.interframe_map, want.chain_valid,
                     want.inliers)):
        assert torch.equal(a, b), tag
    assert got.diagnostics.keys() == want.diagnostics.keys()
    for k, v in want.diagnostics.items():
        assert torch.equal(got.diagnostics[k], v), (tag, k)


def _assert_states_equal(a, b):
    for x, y in zip(state_leaves(a), state_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("route", ["flagship", "device_orb"])
def test_frame_program_equals_the_eager_step(route):
    """The op-by-op run of the per-frame program (preprocessing inside it)
    equals the eager step with explicit preprocessing bit for bit:
    poses, keypoints, match maps, masks, diagnostics (read in one host
    read as the same numbers) and the carried state; the device ORB route
    with its pair resized on the device."""
    if route == "flagship":
        cfg = _tcfg()
        frames, P_l, P_r, _ = _corridor(3)
        vo = VisualOdometry(cfg, device="cpu", model=_model())
        noise = _noise(cfg, 3)
        want, state = _eager_cnn(cfg, frames, P_l, P_r, noise)
    else:
        cfg = _orb_cfg()
        frames, P_l, P_r, _ = _corridor(3, 150, 496)
        vo = tfc.ClassicVisualOdometry(cfg, device="cpu")
        noise = _noise(cfg, 3)
        want, state = _eager_orb(cfg, frames, P_l, P_r, noise)
    for f, (il, ir) in enumerate(frames):
        T, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=noise[f])
        _assert_outputs_equal(info["output"], want[f], f)
        np.testing.assert_array_equal(
            T, want[f].T_curr_prev.numpy().astype(np.float64))
        for k, v in want[f].diagnostics.items():
            assert info[k] == v.item() and type(info[k]) is type(v.item()), k
    assert len(vo._frame_programs) == 1
    _assert_states_equal(vo.state, state)
    if route == "flagship":
        assert want[-1].diagnostics["num_inliers"] > 30


@pytest.mark.parametrize("route", list(ROUTES))
def test_noise_drawn_ahead_equals_the_draw_in_the_solve(route):
    """`process(gumbel=None)` draws one `gumbel_shape` slab per frame from
    the seeded generator before the step: the same numbers as the draw
    inside the solve (`vo_step` with `generator=`: one slab of that shape,
    one `torch.rand`), and as `process` given slabs drawn ahead from a
    generator with the same seed, on the flagship, with `landmark_refine`,
    and with the reference-parity solve (chunked RANSAC, while-loop LM)."""
    cfg = _tcfg(**ROUTES[route])
    frames, P_l, P_r, _ = _corridor(3)
    vo = VisualOdometry(cfg, device="cpu", seed=5, model=_model())
    drawn = [vo.process(il, ir, P_l, P_r, want_diagnostics=True)[1]["output"]
             for il, ir in frames]
    inside, _ = _eager_cnn(cfg, frames, P_l, P_r,
                           generator=torch.Generator().manual_seed(5))
    ahead = VisualOdometry(cfg, device="cpu", model=_model())
    noise = _noise(cfg, 3, seed=5)
    for f, (il, ir) in enumerate(frames):
        out = ahead.process(il, ir, P_l, P_r, want_diagnostics=True,
                            gumbel=noise[f])[1]["output"]
        _assert_outputs_equal(drawn[f], inside[f], f)
        _assert_outputs_equal(out, drawn[f], f)
    vo.reset()
    again = vo.process(*frames[0], P_l, P_r, want_diagnostics=True)
    _assert_outputs_equal(again[1]["output"], drawn[0], "after reset")


def test_entry_points_mixed_on_one_instance_give_the_process_poses():
    """`process`, `process_instrumented`, `process_stream` (frames
    preprocessed by the same function) and `reset`, mixed on one instance
    with equal noise, give the poses of `process` alone; `state` is a
    valid `VOState` between the calls."""
    cfg = _tcfg()
    frames, P_l, P_r, _ = _corridor(5)
    noise = _noise(cfg, 5)
    ref = VisualOdometry(cfg, device="cpu", model=_model())
    for f, (il, ir) in enumerate(frames):
        ref.process(il, ir, P_l, P_r, gumbel=noise[f])
    pre = []
    for il, ir in frames[2:4]:
        imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
            *_raw(il, ir, P_l, P_r), dst_h=96, dst_w=320)
        pre.append(imgs.numpy())
    vo = VisualOdometry(cfg, device="cpu", model=_model())
    vo.process(*frames[0], P_l, P_r, gumbel=noise[0])
    vo.reset()                          # back to the start mid-drive
    vo.process(*frames[0], P_l, P_r, gumbel=noise[0])
    assert int(vo.state.frame_count) == 1
    vo.process_instrumented(*frames[1], P_l, P_r, gumbel=noise[1])
    assert int(vo.state.frame_count) == 2 and vo.state.initialized
    out = list(vo.process_stream(iter(pre), Pl2.numpy(), Pr2.numpy(),
                                 chunk=2, gumbel=iter([np.stack(noise[2:4])])))
    assert [i for i, _ in out] == [0, 1]
    vo.process(*frames[4], P_l, P_r, gumbel=noise[4])
    assert len(vo.trajectory) == len(ref.trajectory) == 5
    for a, b in zip(vo.trajectory, ref.trajectory):
        np.testing.assert_array_equal(a, b)
    _assert_states_equal(vo.state, ref.state)


def test_output_copy_state_and_input_checks():
    """`info["output"]` of one call is a copy the next call leaves as it
    is; the state read between calls is the program's; a noise slab of
    another shape and a pair of two shapes are refused, the state left as
    it was."""
    cfg = _tcfg()
    frames, P_l, P_r, _ = _corridor(3)
    noise = _noise(cfg, 3)
    vo = VisualOdometry(cfg, device="cpu", model=_model())
    _, info0 = vo.process(*frames[0], P_l, P_r, want_diagnostics=True,
                          gumbel=noise[0])
    out0 = info0["output"]
    snap = clone_output(out0)
    state1 = vo.state
    vo.process(*frames[1], P_l, P_r, want_diagnostics=True, gumbel=noise[1])
    _assert_outputs_equal(out0, snap)
    assert int(state1.frame_count) == 1 and int(vo.state.frame_count) == 2
    before = vo.state
    with pytest.raises(ValueError, match="gumbel noise must be"):
        vo.process(*frames[2], P_l, P_r, gumbel=noise[2][:, :10])
    with pytest.raises(ValueError, match="one shape and dtype"):
        vo.process(frames[2][0], frames[2][1][:, :600], P_l, P_r)
    _assert_states_equal(vo.state, before)


def test_process_through_the_program_matches_jax():
    """JAX's `process` against the port's, which runs through the
    per-frame program, on JAX's per-frame noise: the drive, recipe and
    bounds of tests/test_torch_pipeline.py::
    test_slice_matches_jax_trajectory (equal keypoint counts, T within
    1e-3 m and 1e-4 rad, inliers within 3). (On this file's own drive a
    lane of frame 1 sits on the inlier threshold with JAX's key 0, and the
    packages part by 3.8e-3 m there, in the eager step as well.)"""
    jax = pytest.importorskip("jax")
    from scipy.spatial.transform import Rotation

    from spsvo_tpu import presets as jpresets
    from spsvo_tpu.config import Precision as JPrecision
    from spsvo_tpu.pipeline import VisualOdometry as JVO
    seed = zlib.crc32(b"tests/test_torch_pipeline.py::"
                      b"test_slice_matches_jax_trajectory")
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(seed), n_frames=4, h=188, w=620, tex_px=1024,
        twists=[TWIST] * 3)
    jvo = JVO(dataclasses.replace(jpresets.flagship_tpu(), **SMALL,
                                  precision=JPrecision.FP32), seed=0)
    tvo = VisualOdometry(_tcfg(), device="cpu", model=_model())
    for f, (il, ir) in enumerate(frames):
        key = jax.random.fold_in(jax.random.PRNGKey(0), f)
        g = np.asarray(jax.random.gumbel(jax.random.split(key)[0], (64, 64)))
        Tj, ij = jvo.process(il, ir, P_l, P_r, want_diagnostics=True)
        Tt, it = tvo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=g)
        assert it["num_keypoints_left"] == ij["num_keypoints_left"]
        assert it["num_keypoints_right"] == ij["num_keypoints_right"]
        assert abs(it["num_inliers"] - ij["num_inliers"]) <= 3
        assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= 1e-3, f
        assert Rotation.from_matrix(
            Tt[:3, :3].T @ Tj[:3, :3]).magnitude() <= 1e-4, f
        if f > 0:
            assert ij["num_inliers"] > 30 and ij["pnp_success"]
    np.testing.assert_allclose(tvo.current_pose(), jvo.current_pose(),
                               atol=2e-3)


def _spans_by_request(spans):
    """{(root span's name, request): [(name, parent's name), ...]} in the
    order they opened."""
    out = {}
    for r in spans:
        parent = None if r["parent"] is None else spans[r["parent"]]["name"]
        root = r
        while root["parent"] is not None:
            root = spans[root["parent"]]
        assert root["request"] == r["request"]
        out.setdefault((root["name"], r["request"]), []).append(
            (r["name"], parent))
    return out


def _segment(frames, P_l, P_r, cfg):
    """The drive's frames preprocessed as `OnlineHybrid` takes them."""
    imgs = []
    for il, ir in frames:
        pair, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
            *_raw(il, ir, P_l, P_r), dst_h=cfg.image_height,
            dst_w=cfg.image_width)
        imgs.append(pair)
    return torch.stack(imgs), Pl2, Pr2


def test_traced_entry_points_record_their_spans():
    """With tracing on, a CPU `process` (with diagnostics) and
    `process_instrumented` record the frame's spans under the frame's
    request id, and an `OnlineHybrid` call the segment's under the call's;
    the poses and the world are those of an untraced run. The CPU records
    no stamps, and of the counters only the routes: the hybrid's scan pairs
    (its two pairs stepped, none fused) and the frames' landmark solves
    (both stepped, none through kernel 2's frame entry)."""
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    from spsvo_tpu_torch.utils import profiling
    cfg = _tcfg()
    frames, P_l, P_r, _ = _corridor(3)
    noise = _noise(cfg, 3)
    plain = VisualOdometry(cfg, device="cpu", model=_model())
    want = [plain.process(*frames[f], P_l, P_r, gumbel=noise[f])[0]
            for f in range(2)]
    imgs, Pl2, Pr2 = _segment(frames, P_l, P_r, cfg)
    g = torch.as_tensor(np.stack(noise[:2]))
    hybrid = build_online_hybrid(cfg, device="cpu", model=_model())
    world = hybrid(imgs, Pl2, Pr2, gumbel=g)[0]
    vo = VisualOdometry(cfg, device="cpu", model=_model())
    profiling.snapshot()
    profiling.enable()
    try:
        T0, _ = vo.process(*frames[0], P_l, P_r, want_diagnostics=True,
                           gumbel=noise[0])
        T1, _ = vo.process_instrumented(*frames[1], P_l, P_r,
                                        gumbel=noise[1])
        traced = hybrid(imgs, Pl2, Pr2, gumbel=g)[0]
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    np.testing.assert_array_equal(T0, want[0])
    np.testing.assert_array_equal(T1, want[1])
    assert torch.equal(traced, world)
    frame = [("spsvo.frame", None), ("spsvo.frame.feed", "spsvo.frame"),
             ("spsvo.frame.launch", "spsvo.frame")]
    read = ("spsvo.frame.read", "spsvo.frame")
    tail = [("spsvo.frame.pose", "spsvo.frame"),
            ("spsvo.frame.diagnostics", "spsvo.frame")]
    launch = ("spsvo.frame.launch", "spsvo.frame")
    assert _spans_by_request(snap["spans"]) == {
        ("spsvo.frame", 1): frame + [read] + tail,
        ("spsvo.frame", 2): frame + [read, launch, read, launch, read] + tail,
        ("spsvo.segment", 2): [("spsvo.segment", None),
                       ("spsvo.segment.feed", "spsvo.segment"),
                       ("spsvo.segment.launch", "spsvo.segment")]}
    assert hybrid.calls == 2 and vo.frames == 2
    assert snap["stamps"] == [] and snap["counters"] == {
        "scan_pairs.fused": 0, "scan_pairs.stepped": 2,
        "frame_solves.fused": 0, "frame_solves.stepped": 2}


# ---- on the card ----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


class _Replays:
    """Counts `CUDAGraph.replay` calls while in use."""

    def __init__(self, monkeypatch):
        self.n = 0
        replay = torch.cuda.CUDAGraph.replay

        def counted(graph):
            self.n += 1
            return replay(graph)
        monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", counted)


# the fused kernel's parity tolerances against its plain version
# (tests/test_torch_solver.py)
Q_ATOL, T_ATOL = 1e-4, 1e-3

FRAME_CASES = {
    "flagship": dict(),
    "reference_solve": dict(ransac_chunk=16, lm_unroll=0),
    "laptop": None,
}


def _frame_case(case):
    """The configuration of a `gpu` frame case: the flagship composition
    on superpoint_pretrained, with the reference solve's adaptive loops, or
    superpoint_laptop (fp32 sp_resnet18 at 360x1176, kernel 4, 500
    hypotheses in chunks of 64, the while-loop LM)."""
    if FRAME_CASES[case] is None:
        return tpresets.superpoint_laptop()
    return dataclasses.replace(
        tpresets.flagship_tpu(), model_name_prefix="superpoint_pretrained",
        **FRAME_CASES[case])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FRAME_CASES))
def test_cuda_frame_graph_equals_eager(case, monkeypatch):
    """On the card, from a raw 375x1242 pair: the captured per-frame
    program (preprocessing inside it; the adaptive loops' iterations after
    the first each under a conditional node that skips them once every
    lane has stopped) equals the eager step on device-preprocessed frames
    bit for bit, `n_ransac_hypotheses` and the carried state included, one
    replay per frame after the first; a replayed frame counts the kernel
    launches of its eager step (the flagship: kernels 1 and 2 once each,
    kernel 3 once per conv; the reference-parity solve: kernel 1 alone);
    `process_instrumented` replays three graphs and equals `process`. A
    capture with tracing on holds one conditional node per guarded
    iteration (none in the flagship's fused composition), its results
    those of the untraced one, and its replays run fewer LM bodies than
    it holds. The flagship's landmark solve, substitution to scatter with
    the GLS pass, is one launch of kernel 2's frame entry, weighted, and no
    launch of its per-frame entry: once per replay, at most 700 kernel
    nodes in the frame's graph, its pose within the kernel's tolerances of
    the fused solver's plain version from the same state and inputs; every
    traced call counts its solve as fused."""
    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.utils import profiling
    dev = _cuda()
    n = 4
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242)
    cfg = _frame_case(case)
    vo = VisualOdometry(cfg, device=dev)
    noise = [pnp.gumbel_noise(tsolver.gumbel_shape(cfg),
                              torch.Generator(dev).manual_seed(f), dev
                              ).cpu().numpy() for f in range(n)]
    replays = _Replays(monkeypatch)
    outs, launched = [], []
    for f, (il, ir) in enumerate(frames):
        torch.cuda.synchronize()
        _build.reset_launches()
        before = replays.n
        _, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=noise[f])
        torch.cuda.synchronize()
        assert replays.n - before == (f > 0)
        launched.append(dict(_build.launches))
        outs.append(info["output"])
    if case != "laptop":
        fused = tsolver.fused_composition(cfg)
        assert launched[-1] == {"match_nn": 1, "conv_bf16": 12,
                                **({"fused_frame": 1} if fused else {})}
    state = init_state(cfg, dev)
    with torch.no_grad():
        for f, (il, ir) in enumerate(frames):
            imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
                *(t.to(dev) for t in _raw(il, ir, P_l, P_r)),
                dst_h=cfg.image_height, dst_w=cfg.image_width)
            g = torch.as_tensor(noise[f]).to(dev)
            if case == "flagship":
                with monkeypatch.context() as m:
                    m.setattr(tsolver, "pallas_solver_eligible",
                              lambda *_: False)
                    _build.reset_launches()
                    plain = vo_step(vo.model, state, imgs, Pl2, Pr2,
                                    cfg=cfg, gumbel=g)[1]
                    assert "fused_solve" not in _build.launches
                    assert "fused_frame" not in _build.launches
            _build.reset_launches()
            state, out = vo_step(vo.model, state, imgs, Pl2, Pr2, cfg=cfg,
                                 gumbel=g)
            assert dict(_build.launches) == launched[f], f
            _assert_outputs_equal(outs[f], out, f)
            if case == "flagship":
                assert _build.shapes["fused_frame"][2] == 1  # weighted LM
                T_k, T_p = (se3.invert_transform(o.T_curr_prev)
                            for o in (out, plain))
                torch.testing.assert_close(
                    se3.matrix_to_quat(T_k[:3, :3]),
                    se3.matrix_to_quat(T_p[:3, :3]), atol=Q_ATOL, rtol=0)
                torch.testing.assert_close(T_k[:3, 3], T_p[:3, 3],
                                           atol=T_ATOL, rtol=0)
    _assert_states_equal(vo.state, state)
    inst = VisualOdometry(cfg, device=dev, model=vo.model)
    for f, (il, ir) in enumerate(frames):
        before = replays.n
        _, info = inst.process_instrumented(il, ir, P_l, P_r,
                                            gumbel=noise[f])
        assert replays.n - before == (3 if f else 0)
        _assert_outputs_equal(info["output"], outs[f], f)
    profiling.snapshot()
    profiling.enable()
    try:
        traced = VisualOdometry(cfg, device=dev, model=vo.model)
        for f, (il, ir) in enumerate(frames):
            _, info = traced.process(il, ir, P_l, P_r, gumbel=noise[f],
                                     want_diagnostics=True)
            _assert_outputs_equal(info["output"], outs[f], f)
            if f == 0:
                _build.reset_launches()     # the replays' launches alone
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    c = snap["counters"]
    bodies = {loop: c.get(f"loop_bodies_captured.whole.{loop}", 0)
              for loop in profiling.LOOPS}
    if case == "flagship":
        assert c["graph_conditional_nodes.whole"] == 0
        assert bodies == {"ransac": 0, "polish": 0, "lm": 0}
        assert c["graph_kernel_nodes.whole"] <= 700
        assert snap["launches"]["fused_frame"] == c["replays.whole"] == n - 1
        assert "fused_solve" not in snap["launches"]
        assert c["frame_solves.fused"] == n and c["frame_solves.stepped"] == 0
        return
    assert c["frame_solves.fused"] == 0 and c["frame_solves.stepped"] == n
    # the LM: the solve's, and the GLS pass's where landmarks are fused
    n_chunks = pnp.chunking(cfg.ransac_chunk, cfg.ransac_iterations)[1]
    n_lm = 2 if cfg.landmark_fusion and cfg.landmark_weighted_lm else 1
    assert bodies == {"ransac": n_chunks, "polish": 9,
                      "lm": n_lm * (cfg.lm_max_iterations - 1)}
    assert c["graph_conditional_nodes.whole"] == sum(bodies.values())
    assert c["graph_body_kernel_nodes.whole"] > c["graph_kernel_nodes.whole"]
    ran = {loop: c[f"loop_bodies_run.whole.{loop}"]
           for loop in profiling.LOOPS}
    assert c["replays.whole"] == n - 1
    assert all(ran[k] <= bodies[k] * (n - 1) for k in bodies)
    assert ran["lm"] < bodies["lm"] * (n - 1)


@pytest.mark.gpu
def test_cuda_frame_entry_equals_the_op_by_op_composition(monkeypatch):
    """On the card, on the frame test's drive (the flagship, eager steps
    from device-preprocessed frames): each frame's landmark solve through
    kernel 2's frame entry against the composition it replaced (the
    hypotheses by PyTorch ops on the substituted prep, the per-frame
    entry, fusion and the scatter by PyTorch ops). The hypotheses, the
    winner (first best inlier count over both sets), the inlier row, the
    counts and the landmarks are equal; the pose within the kernel's
    tolerances. Prints the largest hypothesis difference."""
    from spsvo_tpu_torch import _build
    from spsvo_tpu_torch.ops import solver_cuda
    dev = _cuda()
    n = 4
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242)
    cfg = _frame_case("flagship")
    vo = VisualOdometry(cfg, device=dev)
    calls = []
    entry = solver_cuda.fused_frame

    def recorded(prep, lms, *args, **kw):
        calls.append((prep, tsolver.LandmarkState(*(x.clone() for x in lms)),
                      args, kw))
        return entry(prep, lms, *args, **kw)
    monkeypatch.setattr(solver_cuda, "fused_frame", recorded)
    state = init_state(cfg, dev)
    with torch.no_grad():
        for f, (il, ir) in enumerate(frames):
            imgs, Pl2, Pr2 = image_ops.preprocess_stereo_pair(
                *(t.to(dev) for t in _raw(il, ir, P_l, P_r)),
                dst_h=cfg.image_height, dst_w=cfg.image_width)
            g = pnp.gumbel_noise(tsolver.gumbel_shape(cfg),
                                 torch.Generator(dev).manual_seed(f), dev)
            state = vo_step(vo.model, state, imgs, Pl2, Pr2, cfg=cfg,
                            gumbel=g)[0]
    assert len(calls) == n
    worst = 0.0
    for prep, lms, args, kw in calls:
        P_l2, P_r2, q0, t0, fc, _, k = args
        scal = solver_cuda.pack_scalars(q0, t0, fc, P_l2, P_r2).contiguous()
        _build.reset_launches()
        out, inl, hyp, got = solver_cuda.fused_frame_packed(
            solver_cuda.pack_points(prep), prep.inter_sel, prep.sel,
            kw["gumbel"], lms, scal, cfg, k)
        assert dict(_build.launches) == {"fused_frame": 1}
        prep2, _ = tsolver.substitute_landmarks(prep, lms)
        hyp_c = solver_cuda.precompute_hypotheses(prep2, cfg,
                                                  gumbel=kw["gumbel"])
        with monkeypatch.context() as m:
            m.setattr(tsolver, "fused_frame_route", lambda *_: False)
            _build.reset_launches()
            want, want_lms = tsolver.solve_with_landmarks(
                prep, lms, P_l2, P_r2, q0, t0, fc, cfg, k_capacity=k,
                gumbel=kw["gumbel"])
            assert dict(_build.launches) == {"fused_solve": 1}
        torch.cuda.synchronize()
        worst = max(worst, (hyp - hyp_c).abs().max().item())
        winner = [int(torch.argmax(pnp._score_mask(
            h[:, :9].reshape(-1, 3, 3), h[:, 9:], prep.pts3d_curr,
            prep.uv_prev_l, prep.chain, P_l2,
            cfg.ransac_reproj_threshold ** 2).sum(-1))) for h in (hyp, hyp_c)]
        assert winner[0] == winner[1]
        res = tsolver._masks_to_slots(
            solver_cuda.solve_result(out, inl, prep, cfg), prep.sel, k)
        for name in ("inliers", "chain_valid", "num_inliers", "num_chain",
                     "pnp_success", "accel_anomaly", "prior_winner"):
            assert torch.equal(getattr(res, name), getattr(want, name)), name
        torch.testing.assert_close(res.q, want.q, atol=Q_ATOL, rtol=0)
        torch.testing.assert_close(res.t, want.t, atol=T_ATOL, rtol=0)
        assert torch.equal(got.length, want_lms.length)
        assert torch.equal(got.pts3d, want_lms.pts3d)
        assert torch.equal(hyp, hyp_c)
    print(f"largest hypothesis difference: {worst}")


@pytest.mark.gpu
def test_cuda_classic_frame_graph_equals_eager(monkeypatch):
    """On the card, the device ORB route behind the flagship solve at the
    native 375x1242 (chip_smoke.py's `classic_cfg`): the captured per-frame
    program equals the eager step bit for bit, one replay per frame after
    the first, kernel 2's frame entry once per frame and kernel 1
    never."""
    from spsvo_tpu_torch import _build
    dev = _cuda()
    n = 3
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242)
    cfg = dataclasses.replace(
        tpresets.flagship_tpu(), is_classic=True, device_classic=True,
        detector_type=TDet.ORB, descriptor_type=TDesc.ORB, image_height=375,
        image_width=1242, orb_edge_threshold=31)
    vo = tfc.ClassicVisualOdometry(cfg, device=dev)
    noise = [pnp.gumbel_noise(tsolver.gumbel_shape(vo.cfg),
                              torch.Generator(dev).manual_seed(f), dev
                              ).cpu().numpy() for f in range(n)]
    replays = _Replays(monkeypatch)
    state = tfc.init_state_with_dim(vo.cfg, vo.desc_dim, dev)
    for f, (il, ir) in enumerate(frames):
        torch.cuda.synchronize()
        _build.reset_launches()
        before = replays.n
        _, info = vo.process(il, ir, P_l, P_r, want_diagnostics=True,
                             gumbel=noise[f])
        torch.cuda.synchronize()
        assert replays.n - before == (f > 0)
        assert _build.launches == {"fused_frame": 1}
        with torch.no_grad():
            imgs, Pl2, Pr2 = tfc.device_prepare(
                torch.stack([torch.as_tensor(il), torch.as_tensor(ir)]
                            ).to(dev),
                *(t.to(dev) for t in _raw(il, ir, P_l, P_r)[2:]),
                cfg=vo.cfg)
            state, out = tfc.classic_step(
                state, imgs, Pl2, Pr2, cfg=vo.cfg,
                gumbel=torch.as_tensor(noise[f]).to(dev))
        _assert_outputs_equal(info["output"], out, f)


@pytest.mark.gpu
def test_cuda_traced_capture_holds_stamps_and_equals_untraced(monkeypatch):
    """On the card, the flagship's per-frame program and its online hybrid
    captured with tracing on: results bit for bit those of programs
    captured with tracing off; one device stamp per boundary ("start",
    the three stages; the hybrid's seven steps) read once per replay (the
    hybrid's first call replays after its capture, the per-frame
    program's does not), the stages adding up to at most the frame's host
    latency; the traced
    graphs' nodes are the untraced graphs' (kept to count them) plus one
    event-record node per boundary, the untraced ones holding none."""
    from spsvo_tpu_torch.parallel.sharding import build_online_hybrid
    from spsvo_tpu_torch.utils import capture, profiling
    dev = _cuda()
    n = 4
    frames, _, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(42), n_frames=n, h=375, w=1242)
    cfg = dataclasses.replace(tpresets.flagship_tpu(),
                              model_name_prefix="superpoint_pretrained")
    noise = [pnp.gumbel_noise(tsolver.gumbel_shape(cfg),
                              torch.Generator(dev).manual_seed(f), dev
                              ).cpu().numpy() for f in range(n)]
    kept = []
    monkeypatch.setattr(capture, "new_graph", lambda keep: kept.append(
        torch.cuda.CUDAGraph(keep_graph=True)) or kept[-1])
    plain = VisualOdometry(cfg, device=dev)
    want = [plain.process(il, ir, P_l, P_r, gumbel=noise[f],
                          want_diagnostics=True)[1]["output"]
            for f, (il, ir) in enumerate(frames)]
    untraced = capture.graph_nodes(kept[0])
    imgs = torch.stack([image_ops.preprocess_stereo_pair(
        *(t.to(dev) for t in _raw(il, ir, P_l, P_r)),
        dst_h=cfg.image_height, dst_w=cfg.image_width)[0]
        for il, ir in frames])
    Pl2, Pr2 = image_ops.preprocess_stereo_pair(
        *(t.to(dev) for t in _raw(*frames[0], P_l, P_r)),
        dst_h=cfg.image_height, dst_w=cfg.image_width)[1:]
    g = torch.stack([torch.as_tensor(x) for x in noise[1:]]).to(dev)
    hybrid = build_online_hybrid(cfg, device=dev, model=plain.model)
    world = hybrid(imgs, Pl2, Pr2, gumbel=g)[0]
    untraced_hybrid = capture.graph_nodes(kept[-1])
    assert untraced["events"] == untraced_hybrid["events"] == 0
    monkeypatch.undo()
    profiling.snapshot()
    profiling.enable()
    try:
        vo = VisualOdometry(cfg, device=dev, model=plain.model)
        lat = []
        for f, (il, ir) in enumerate(frames):
            _, info = vo.process(il, ir, P_l, P_r, gumbel=noise[f],
                                 want_diagnostics=True)
            _assert_outputs_equal(info["output"], want[f], f)
            lat.append(info["latency_s"] * 1e3)
        traced = build_online_hybrid(cfg, device=dev, model=plain.model)
        for _ in range(3):
            got = traced(imgs, Pl2, Pr2, gumbel=g)[0]
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    assert torch.equal(got, world)
    frame = [s for s in snap["stamps"] if s["program"] == "whole"]
    assert [s["request"] for s in frame] == [2, 3, 4]
    for s, ms in zip(frame, lat[1:]):
        assert set(s["ms"]) == {"detect", "match", "solve"}
        assert all(v > 0 for v in s["ms"].values())
        assert sum(s["ms"].values()) <= ms
    seg = [s for s in snap["stamps"] if s["program"] == "hybrid"]
    assert [s["request"] for s in seg] == [1, 2, 3]     # capture, replays
    assert set(seg[0]["ms"]) == {"frontend", "halo_kp", "match", "halo_st",
                                 "prepare", "gather", "scan"}
    c = snap["counters"]
    assert c["replays.whole"] == 3 and c["replays.hybrid"] == 3
    assert c["graph_event_nodes.whole"] == 4
    assert c["graph_kernel_nodes.whole"] == untraced["kernels"]
    assert c["graph_nodes.whole"] == untraced["nodes"] + 4
    assert c["graph_event_nodes.hybrid"] == 8
    assert c["graph_kernel_nodes.hybrid"] == untraced_hybrid["kernels"]
    assert c["graph_nodes.hybrid"] == untraced_hybrid["nodes"] + 8
    assert [r["args"]["form"] for r in snap["spans"]
            if r["name"] == "spsvo.capture"] == ["whole", "hybrid"]
