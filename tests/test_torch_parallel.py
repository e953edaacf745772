"""Frame sharding over a device mesh on the CPU: `parallel.mesh`, the
sharded paths of `parallel.sharding` (the online hybrid with the CNN, the
feature input and the ORB front end, and the batch mode),
`training.build_sharded_train_step`, and the harness and CLI under several
ranks. Every rank is a process started by `mesh.spawn` (gloo, one torch
thread each, a timeout that kills the group); each world size runs all its
cases in one group (`_world_runs`), the tests read the results.

What is held, and to what:
- the sharded hybrid's world poses and diagnostics equal the unsharded
  port's bit for bit from the same keypoints (the feature-input form fed
  the unsharded front end's keypoints), in the flagship composition with
  landmark fusion on and off (the fused solver's plain version on the CPU),
  at world 2 and 4, on 8 frames and on a ragged 7 (world 2) or 9 (world 4);
- on the CPU the trunk is batch-invariant (each image's outputs are the
  same bits at batch 2N and at a rank's 2N/w), so the CNN hybrid end to
  end, the batch mode and the ORB hybrid equal the unsharded runs bit for
  bit as well;
- the sharded train step at world 2 and 4 against one `train_step` on the
  whole batch: loss rtol 1e-5, parameters atol 1e-4 (the JAX package's
  tests/test_parallel.py tolerances), BatchNorm statistics bit-unchanged;
  at world 2 against the JAX package's `build_sharded_train_step` on the
  conftest's virtual mesh by tests/test_torch_training.py's rule;
- the speculative branch (the sampled winners hoisted per rank, carried by
  the one gather) from the same keypoints at world 2, on 8 and 7 frames,
  bit for bit;
- the cheapest hybrid (no landmark fusion, no fused solver, 4 frames) at
  world 2 against the JAX package's `build_online_hybrid(mesh=make_mesh(2))`
  with the same noise, at tests/test_torch_hybrid.py's WORLD_ATOL;
- the harness and the CLI at world 2: the padded sequence, rank 0 alone
  writing the pose file.
Adds ~60 s of one xdist worker (two spawned groups and the references).
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from spsvo_tpu_torch import presets as tpresets, training as tt
from spsvo_tpu_torch.config import (DescriptorType as TDesc,
                                    DetectorType as TDet,
                                    Precision as TPrecision, VOConfig as TCfg)
from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.models import zoo as tzoo
from spsvo_tpu_torch.models.graph import conv_weight_names
from spsvo_tpu_torch.ops.image import (preprocess_image_np,
                                       update_projection_matrix_np)
from spsvo_tpu_torch.ops.postprocess import Keypoints
from spsvo_tpu_torch.parallel import mesh as tmesh, sharding as tsh

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_harness_cli import _drive, tree  # noqa: E402,F401

SEED = 12
SMALL = dict(model_name_prefix="superpoint_pretrained", image_height=96,
             image_width=320, max_keypoints=256, ransac_iterations=64,
             solve_slots=64, matcher_bf16=False)
ORB = dict(is_classic=True, device_classic=True, image_height=150,
           image_width=496, max_keypoints=256, orb_n_levels=2,
           orb_edge_threshold=16, ransac_iterations=128, solve_slots=128,
           use_pallas_solver=True, ransac_chunk=0, lm_unroll=6)
TWIST = (np.array([0.0, 0.003, 0.0]), np.array([0.0, 0.0, 0.35]))
N_MAX = 9
RAGGED = {2: 7, 4: 9}
LR = 1e-3
TRAIN = dict(prefix="sp_resnet18", batch=8, h=48, w=64)
TIMEOUT_S = 600


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(landmark_fusion: bool, **kw):
    return dataclasses.replace(tpresets.flagship_tpu(), **SMALL,
                               precision=TPrecision.FP32,
                               landmark_fusion=landmark_fusion, **kw)


def _orb_cfg():
    return TCfg(detector_type=TDet.ORB, descriptor_type=TDesc.ORB, **ORB)


def _corridor(n, h, w, out_h=None, out_w=None):
    frames, gt, P_l, P_r = tsyn.synthetic_corridor(
        np.random.default_rng(SEED), n_frames=n, h=h, w=w, tex_px=1024,
        twists=[TWIST] * (n - 1))
    if out_h is None:
        imgs = np.stack([np.stack(f) for f in frames]) / np.float32(255)
        return (imgs.astype(np.float32), P_l.astype(np.float32),
                P_r.astype(np.float32))
    imgs = np.stack([[preprocess_image_np(il, out_h, out_w),
                      preprocess_image_np(ir, out_h, out_w)]
                     for il, ir in frames]).astype(np.float32)
    up = functools.partial(update_projection_matrix_np, src_h=h, src_w=w,
                           dst_h=out_h, dst_w=out_w)
    return imgs, up(P_l).astype(np.float32), up(P_r).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _data():
    """Inputs of every case, as numpy: the CNN corridor (N_MAX frames at
    96x320) with its noise and the unsharded front end's keypoint stack,
    the ORB corridor (6 frames at 150x496) with its noise, and a training
    batch."""
    imgs, P_l, P_r = _corridor(N_MAX, 188, 620, 96, 320)
    hyb = tsh.build_online_hybrid(_cfg(True), device="cpu")
    gumbel = hyb.draw_gumbel(N_MAX, torch.Generator().manual_seed(0))
    with torch.no_grad():
        kp_l, kp_r = hyb.frontend(torch.as_tensor(imgs))
    kp = [torch.stack([a, b], 1).numpy() for a, b in zip(kp_l, kp_r)]
    orb_imgs, orb_P_l, orb_P_r = _corridor(6, 150, 496)
    orb = tsh.build_orb_hybrid(_orb_cfg(), device="cpu")
    orb_gumbel = orb.draw_gumbel(6, torch.Generator().manual_seed(1))
    batch = tt.synthetic_batch(TRAIN["batch"], TRAIN["h"], TRAIN["w"],
                               device="cpu",
                               generator=torch.Generator().manual_seed(0))
    return dict(imgs=imgs, P_l=P_l, P_r=P_r, gumbel=gumbel.numpy(), kp=kp,
                orb_imgs=orb_imgs, orb_P_l=orb_P_l, orb_P_r=orb_P_r,
                orb_gumbel=orb_gumbel.numpy(),
                batch={k: v.numpy() for k, v in batch.items()})


def _run_case(case: str, d: dict, mesh=None):
    """One case on `mesh` (None: the unsharded port) -> (world, diag), or
    for a train case (loss, parameters after one step)."""
    t = torch.as_tensor
    kind, _, arg = case.rpartition("_")
    n = int(arg) if arg.isdigit() else 0
    if kind in ("feature_lm", "feature_plain"):
        hyb = tsh.build_online_hybrid(_cfg(kind == "feature_lm"),
                                      device="cpu", feature_input=True,
                                      mesh=mesh)
        assert hyb.branch == (tsh.LANDMARK_KERNEL if kind == "feature_lm"
                              else tsh.KERNEL)
        return hyb(Keypoints(*(t(a[:n]) for a in d["kp"])), t(d["P_l"]),
                   t(d["P_r"]), gumbel=t(d["gumbel"][:n - 1]))
    if kind == "feature_spec":
        hyb = tsh.build_online_hybrid(
            _cfg(False, use_pallas_solver=False, speculative_solve=True),
            device="cpu", feature_input=True, mesh=mesh)
        assert hyb.branch == tsh.SPECULATIVE
        return hyb(Keypoints(*(t(a[:n]) for a in d["kp"])), t(d["P_l"]),
                   t(d["P_r"]), gumbel=t(d["gumbel"][:n - 1]))
    if kind in ("cnn_lm", "batch"):
        build = (tsh.build_batch_vo if kind == "batch"
                 else tsh.build_online_hybrid)
        fn = build(_cfg(kind == "cnn_lm"), device="cpu", mesh=mesh)
        return fn(t(d["imgs"][:n]), t(d["P_l"]), t(d["P_r"]),
                  gumbel=t(d["gumbel"][:n - 1]))
    if kind == "orb":
        fn = tsh.build_orb_hybrid(_orb_cfg(), device="cpu", mesh=mesh)
        return fn(t(d["orb_imgs"][:n]), t(d["orb_P_l"]), t(d["orb_P_r"]),
                  gumbel=t(d["orb_gumbel"][:n - 1]))
    if kind == "jax_plain":
        hyb = tsh.build_online_hybrid(
            _cfg(False, use_pallas_solver=False), device="cpu", mesh=mesh)
        assert hyb.branch == tsh.PLAIN
        return hyb(t(d["jax_imgs"]), t(d["jax_P_l"]), t(d["jax_P_r"]),
                   gumbel=t(d["jax_gumbel"]))
    if case in ("train", "train_jax"):
        batch = {k: t(v) for k, v in d["batch" if case == "train"
                                       else "jax_batch"].items()}
        model = tzoo.load_model(TRAIN["prefix"], device="cpu")
        apply_fn = tzoo.apply_fn(model)
        params = dict(model.state_dict())
        if mesh is None:
            state = tt.init_train_state(apply_fn, params, LR)
            state, metrics = tt.train_step(state, batch, apply_fn=apply_fn,
                                           lr=LR)
            return float(metrics["loss"]), state.params
        if mesh.rank:         # rank 0's state is broadcast at the first step
            params = {k: (v + 1 if v.is_floating_point() else v)
                      for k, v in params.items()}
        state = tt.init_train_state(apply_fn, params, LR)
        step = tt.build_sharded_train_step(apply_fn, mesh, LR)
        state, metrics = step(state, batch)
        return float(metrics["loss"]), state.params
    raise ValueError(case)


def _collectives(mesh):
    """Each collective once, on tensors that say which rank made them."""
    r, w = mesh.rank, mesh.size
    counts = [2 if i == w - 1 else 3 for i in range(w)]
    rows = counts[r]
    gathered = mesh.gather_frames(
        [torch.full((rows, 2), r, dtype=torch.int32),
         torch.arange(rows, dtype=torch.bfloat16) + 10 * r,
         torch.full((rows,), r % 2 == 0)], counts)
    halo = mesh.halo_next([torch.tensor([r, 7 * r], dtype=torch.int64),
                           torch.full((3,), r + 0.5)])
    mean = mesh.all_reduce_mean([torch.full((2,), float(r))],
                                weight=r + 1)[0]
    bcast = mesh.broadcast([torch.full((4,), float(r)),
                            torch.tensor(r == 0)])
    return dict(rank=r, size=w, backend=mesh.backend, device=str(mesh.device),
                tf32=(torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32),
                gathered=gathered, halo=halo, mean=mean, bcast=bcast)


def _rank_cases(mesh, d, cases):
    out = {"collectives": _collectives(mesh)}
    for case in cases:
        with torch.no_grad() if not case.startswith("train") else \
                torch.enable_grad():
            out[case] = _run_case(case, d, mesh)
    return out


def _cases(world):
    n, r = 8, RAGGED[world]
    cases = [f"feature_lm_{n}", f"feature_lm_{r}", f"feature_plain_{n}",
             f"feature_plain_{r}", f"cnn_lm_{n}", f"batch_{n}",
             f"batch_{r}", "train"]
    if world == 2:
        cases += ["orb_6", "jax_plain_4", "train_jax", f"feature_spec_{n}",
                  f"feature_spec_{r}"]
    return cases


@functools.lru_cache(maxsize=None)
def _jax_data():
    """The JAX package's side of the world-2 comparisons: its mesh hybrid
    on 4 frames with its noise, and its sharded train step on its batch
    (numpy)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu import training as jt
    from spsvo_tpu.eval import synthetic as jsyn
    from spsvo_tpu.models import zoo as jzoo
    from spsvo_tpu.parallel import sharding as jsh
    from test_torch_hybrid import _cfgs, _corridor as h_corridor, \
        _jax_model, _pair_gumbel
    n = 4
    jcfg, _ = _cfgs(use_pallas_solver=False, landmark_fusion=False)
    imgs, P_l, P_r, gt = h_corridor(n, jsyn)
    apply_fn, params = _jax_model()
    jw, jd = jsh.build_online_hybrid(apply_fn, jcfg, mesh=jsh.make_mesh(2))(
        params, jnp.asarray(imgs), jnp.asarray(P_l), jnp.asarray(P_r),
        jax.random.PRNGKey(SEED))
    apply_t, params_t = jzoo.load_model(TRAIN["prefix"])
    batch = jt.synthetic_batch(jax.random.PRNGKey(0), batch=4,
                               h=TRAIN["h"], w=TRAIN["w"])
    state = jt.init_train_state(apply_t, params_t, lr=LR)
    state1, metrics = jt.build_sharded_train_step(
        apply_t, jsh.make_mesh(2), LR)(state, batch)
    (_, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jt.total_loss(apply_t, p, b), has_aux=True))(
            params_t, batch)
    return dict(
        jax_imgs=imgs, jax_P_l=P_l, jax_P_r=P_r,
        jax_gumbel=_pair_gumbel(SEED, n), jax_gt=gt,
        jax_world=np.asarray(jw), jax_diag={k: np.asarray(v)
                                            for k, v in jd.items()},
        jax_batch={k: np.asarray(v) for k, v in batch.items()},
        jax_loss=float(metrics["loss"]),
        jax_params={k: np.asarray(v) for k, v in state1.params.items()},
        jax_grads={k: np.asarray(v) for k, v in grads.items()})


def _inputs(world):
    d = dict(_data())
    if world == 2:
        d.update({k: v for k, v in _jax_data().items()
                  if k in ("jax_imgs", "jax_P_l", "jax_P_r", "jax_gumbel",
                           "jax_batch")})
    return d


@functools.lru_cache(maxsize=None)
def _world_runs(world):
    """Every case of `world` in one spawned group: per rank, {case:
    result}."""
    return tmesh.spawn(_rank_cases, world, "cpu",
                       args=(_inputs(world), _cases(world)),
                       timeout_s=TIMEOUT_S, threads=1)


@functools.lru_cache(maxsize=None)
def _reference(case):
    d = _inputs(2 if case in ("orb_6", "jax_plain_4", "train_jax") else 4)
    with torch.no_grad() if not case.startswith("train") else \
            torch.enable_grad():
        return _run_case(case, d)


def _assert_equal(got, ref, case):
    world, diag = got
    w_ref, d_ref = ref
    assert torch.equal(world, w_ref), (case, (world - w_ref).abs().max())
    assert set(diag) == set(d_ref), case
    for k, v in d_ref.items():
        assert torch.equal(diag[k], v), (case, k)


# ---- the mesh -------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_mesh_and_collectives(world):
    """`make_mesh` in spawned ranks (file store, gloo on the CPU) and each
    collective, on ragged row counts and mixed dtypes, bit for bit; TF32
    stays off in every rank."""
    if world == 1:
        res = tmesh.spawn(_collectives, 1, "cpu", timeout_s=TIMEOUT_S,
                          threads=1)
    else:
        res = [r["collectives"] for r in _world_runs(world)]
    counts = [2 if i == world - 1 else 3 for i in range(world)]
    want_rows = torch.cat([torch.full((c, 2), i, dtype=torch.int32)
                           for i, c in enumerate(counts)])
    want_bf = torch.cat([torch.arange(c, dtype=torch.bfloat16) + 10 * i
                         for i, c in enumerate(counts)])
    want_bool = torch.cat([torch.full((c,), i % 2 == 0)
                           for i, c in enumerate(counts)])
    wsum = sum(i + 1 for i in range(world))
    for r, got in enumerate(res):
        assert (got["rank"], got["size"], got["backend"], got["device"]) == \
            (r, world, "gloo", "cpu")
        assert got["tf32"] == (False, False)
        rows, bf, flags = got["gathered"]
        assert torch.equal(rows, want_rows) and torch.equal(bf, want_bf)
        assert torch.equal(flags, want_bool)
        if r == world - 1:
            assert got["halo"] is None
        else:
            assert torch.equal(got["halo"][0], torch.tensor([r + 1,
                                                             7 * (r + 1)]))
            assert torch.equal(got["halo"][1], torch.full((3,), r + 1.5))
        want_mean = sum(i * (i + 1) for i in range(world)) / wsum
        assert torch.allclose(got["mean"], torch.full((2,), want_mean))
        assert torch.equal(got["bcast"][0], torch.zeros(4))
        assert bool(got["bcast"][1])


def test_shard_layout():
    assert tmesh.shard_bounds(8, 2) == [(0, 4), (4, 8)]
    assert tmesh.shard_bounds(9, 4) == [(0, 2), (2, 4), (4, 6), (6, 9)]
    assert tmesh.pair_counts(8, 2) == [4, 3]
    assert tmesh.pair_counts(9, 4) == [2, 2, 2, 2]
    assert sum(tmesh.pair_counts(7, 2)) == 6


def test_make_mesh_alone_makes_no_process_group(monkeypatch):
    """A process alone gets a mesh of one without a process group, and the
    hybrid and batch mode without a mesh run on such a mesh: nothing is
    left initialised in `torch.distributed`."""
    import torch.distributed as dist
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = tmesh.make_mesh(1, device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == \
        (None, 0, 1, "gloo")
    assert mesh.halo_next([torch.zeros(2)]) is None
    x = torch.arange(3.0)
    assert mesh.gather_frames([x], [3])[0] is x
    for build in (tsh.build_online_hybrid, tsh.build_batch_vo):
        fn = build(_cfg(False), device="cpu")
        assert (fn.mesh.group, fn.mesh.size) == (None, 1)
    assert not dist.is_initialized()


def test_make_mesh_refusals():
    """NCCL on the CPU, an unknown backend, and a device count that is not
    the job's are refused; the JAX package's mesh is not a mesh here."""
    with pytest.raises(ValueError, match="NCCL"):
        tmesh.make_mesh(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        tmesh.make_mesh(device="cpu", backend="mpi")
    with pytest.raises(TypeError, match="Mesh"):
        tsh.build_online_hybrid(_cfg(True), device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tt.build_sharded_train_step(None, object())


def test_spawn_fails_a_rank_that_raises_or_hangs():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tmesh.spawn(_raise_on_rank_1, 2, "cpu", timeout_s=60, threads=1)
    with pytest.raises(TimeoutError):
        tmesh.spawn(_hang_on_rank_1, 2, "cpu", timeout_s=15, threads=1)


def _raise_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 says no")
    mesh.barrier()


def _hang_on_rank_1(mesh):
    if mesh.rank == 1:
        import time
        time.sleep(120)
    return mesh.rank


# ---- the sharded hybrid and batch mode -------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["feature_lm", "feature_plain"])
@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_sharded_hybrid_equals_unsharded_from_the_keypoints(world, kind,
                                                            ragged):
    n = RAGGED[world] if ragged else 8
    case = f"{kind}_{n}"
    ref = _reference(case)
    for rank_out in _world_runs(world):
        _assert_equal(rank_out[case], ref, case)
    world_poses, diag = ref
    assert world_poses.shape == (n, 4, 4)
    assert (diag["num_inliers"] > 30).all(), diag["num_inliers"]


@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_sharded_speculative_hybrid_equals_unsharded(ragged):
    """The speculative branch on a 2-rank mesh: each rank hoists the
    sampled winners of its own pairs, the one gather carries them to the
    replicated scan, and the result equals the unsharded run's bit for
    bit (the same per-pair work, batched differently)."""
    n = RAGGED[2] if ragged else 8
    case = f"feature_spec_{n}"
    ref = _reference(case)
    for rank_out in _world_runs(2):
        _assert_equal(rank_out[case], ref, case)
    assert "prior_winner" in ref[1]
    assert (ref[1]["num_inliers"] > 30).all(), ref[1]["num_inliers"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["cnn_lm", "batch"])
def test_sharded_cnn_hybrid_and_batch_equal_unsharded(world, kind):
    """The CNN front end on each rank's frames (batch-invariant on the
    CPU: each image's trunk outputs are the same bits at any batch), so the
    whole program equals the unsharded one; the batch mode at the ragged
    size too."""
    cases = [f"{kind}_8"] + ([f"batch_{RAGGED[world]}"] if kind == "batch"
                             else [])
    for case in cases:
        ref = _reference(case)
        for rank_out in _world_runs(world):
            _assert_equal(rank_out[case], ref, case)
        if kind == "batch":
            assert "gated" in ref[1]


def test_sharded_orb_hybrid_equals_unsharded():
    ref = _reference("orb_6")
    for rank_out in _world_runs(2):
        _assert_equal(rank_out["orb_6"], ref, "orb_6")
    assert (ref[1]["num_inliers"] > 10).all()


def _assert_frontend_batch_invariant(model, x):
    """`frontend_batch`'s Keypoints for the 16 images at batch 16 against
    the images in the shards of a world-2 and a world-4 mesh: xy, score,
    valid and desc bit for bit."""
    cfg = _cfg(True)
    with torch.no_grad():
        whole = tsh.frontend_batch(model, x, cfg)
        for world in (2, 4):
            parts = [tsh.frontend_batch(model, x[a:b], cfg)
                     for a, b in tmesh.shard_bounds(16, world)]
            for name, got in zip(whole._fields, zip(*parts)):
                assert torch.equal(torch.cat(got), getattr(whole, name)), (
                    world, name)
    assert whole.valid.sum() > 100


def _frontend_model(precision, device, imgs):
    """superpoint_pretrained with the fp32 trunk, the bf16 trunk or the
    int8 one with static scales calibrated on `imgs`."""
    if precision == "fp32":
        return tzoo.load_model("superpoint_pretrained", device=device)
    if precision == "bf16":
        return tzoo.load_model("superpoint_pretrained", torch.bfloat16,
                               device=device)
    return tzoo.load_model("superpoint_pretrained", device=device, int8=True,
                           int8_calibration=imgs[::2, ..., None])


def test_trunk_is_batch_invariant_on_the_cpu():
    """What the CNN cases above rest on: the trunk gives a rank's images
    the same bits at batch 2N/w as the unsharded run at 2N, and so does the
    whole front end (`frontend_batch`'s Keypoints)."""
    model = tzoo.load_model("superpoint_pretrained", device="cpu")
    x = torch.as_tensor(_data()["imgs"][:8].reshape(16, 96, 320, 1))
    with torch.no_grad():
        whole = model(x)
        parts = [model(x[a:b]) for a, b in tmesh.shard_bounds(16, 4)]
    for k, v in whole.items():
        assert torch.equal(v, torch.cat([p[k] for p in parts])), k
    _assert_frontend_batch_invariant(model, x[..., 0])


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8_static"])
def test_frontend_is_batch_invariant_on_the_cpu(precision):
    """The front end of the fp32 trunk (its convs one image per library
    call), the bf16 trunk and the int8 trunk with static scales (dynamic
    scales take the batch's maximum, in the JAX package too)."""
    x = torch.as_tensor(_data()["imgs"][:8].reshape(16, 96, 320))
    _assert_frontend_batch_invariant(_frontend_model(precision, "cpu", x), x)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8_static"])
def test_frontend_is_batch_invariant_on_the_card(precision):
    """On the card: the fp32 convolutions run kernel 4 and the bf16 ones
    kernel 3, whose sums do not depend on the batch, and the postprocess
    sums in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv kernel has no CPU mode")
    imgs, _, _ = _corridor(8, 188, 620, 96, 320)
    x = torch.as_tensor(imgs.reshape(16, 96, 320)).cuda()
    _assert_frontend_batch_invariant(_frontend_model(precision, "cuda", x),
                                     x)


def test_sharded_plain_hybrid_matches_the_jax_mesh_hybrid():
    """The cheapest hybrid (no landmark fusion, no fused solver) at world 2
    against the JAX package's on `make_mesh(2)` of the virtual CPU devices,
    with its noise: tests/test_torch_hybrid.py's counts and WORLD_ATOL."""
    from test_torch_hybrid import _assert_hybrid_matches
    j = _jax_data()
    ref = _reference("jax_plain_4")
    for rank_out in _world_runs(2):
        tw, td = rank_out["jax_plain_4"]
        _assert_equal((tw, td), ref, "jax_plain_4")
        _assert_hybrid_matches(j["jax_world"], j["jax_diag"], tw.numpy(),
                               {k: v.numpy() for k, v in td.items()},
                               j["jax_gt"])


# ---- the sharded train step -------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_train_step_matches_one_train_step(world):
    loss, params = _reference("train")
    p0 = dict(tzoo.load_model(TRAIN["prefix"], device="cpu").state_dict())
    for rank_out in _world_runs(world):
        got_loss, got = rank_out["train"]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        assert set(got) == set(params)
        for k, v in params.items():
            if tt._is_buffer(k):
                assert torch.equal(got[k], p0[k]), k
            else:
                assert float((got[k] - v).abs().max()) <= 1e-4, k
    assert any(tt._is_buffer(k) for k in params)


def test_sharded_train_step_matches_the_jax_sharded_step():
    """Against the JAX package's `build_sharded_train_step` on the virtual
    mesh of 2, same weights and batch: test_torch_training.py's loss
    tolerance and parameter rule (sp_resnet18: no element may move apart
    where the gradients agree)."""
    from test_torch_training import assert_step_close
    j = _jax_data()
    model = tzoo.load_model(TRAIN["prefix"], device="cpu")
    conv = conv_weight_names(model.graph)
    apply_fn = tzoo.apply_fn(model)
    batch = {k: torch.as_tensor(v) for k, v in j["jax_batch"].items()}
    _, grads = tt.value_and_grad(
        lambda p: tt.total_loss(apply_fn, p, batch),
        dict(model.state_dict()))
    g_ref = {k: v for k, v in tzoo.params_from_jax(j["jax_grads"],
                                                   conv).items()
             if not tt._is_buffer(k)}
    new_ref = tzoo.params_from_jax(j["jax_params"], conv)
    for rank_out in _world_runs(2):
        loss, params = rank_out["train_jax"]
        assert abs(loss - j["jax_loss"]) <= 1e-6 * abs(j["jax_loss"])
        assert_step_close(params, new_ref, g_ref, grads, 0.0)


# ---- the harness and the CLI under several ranks ---------------------------

def _harness_rank(mesh, root, out, mode, n):
    from spsvo_tpu_torch import run as trun
    from spsvo_tpu_torch.eval import harness
    cfg = _cfg(mode == "hybrid")
    res = harness.run_eval_id(cfg, root, 0, results_dir=os.path.join(
        out, "results"), description="h", max_frames=n, mode=mode,
        device="cpu")
    rc = 0
    if mode == "hybrid":    # the CLI's flagship preset fuses landmarks
        rc = trun.main(["--mode", mode, "--device", "cpu", "--kitti-root",
                        root, "--max-frames", str(n), "--results-dir",
                        os.path.join(out, "cli"), "--description", "c",
                        "--model", "superpoint_pretrained"])
    return np.stack(res.poses), len(res.diagnostics), rc


@pytest.mark.parametrize("mode,n", [("hybrid", 3), ("batch", 4)])
def test_harness_and_cli_under_two_ranks(tree, tmp_path, mode, n):
    """`run_eval_id` in two ranks, and in hybrid mode `run.main` as
    `torchrun` would start it: 3 frames padded to 4 (the hybrid) or 4
    (batch), poses equal on both ranks and to the one-rank harness, only
    rank 0's pose files."""
    from spsvo_tpu_torch.eval import harness
    root, _ = tree
    gt = [T[:3, 3] for T in _drive()[1]]
    outs = [str(tmp_path / f"r{r}") for r in range(2)]
    res = tmesh.spawn(_harness_rank_dir, 2, "cpu", args=(root, outs, mode, n),
                      timeout_s=TIMEOUT_S, threads=1)
    (p0, n_diag, rc0), (p1, _, rc1) = res
    assert rc0 == rc1 == 0 and n_diag == n - 1
    assert p0.shape == (n, 4, 4) and np.array_equal(p0, p1)
    assert np.abs(p0[:, :3, 3] - np.stack(gt[:n])).max() < 0.25
    one = harness.run_eval_id(_cfg(mode == "hybrid"), root, 0, max_frames=n,
                              mode=mode, device="cpu",
                              results_dir=str(tmp_path / "one"))
    # the padded run's noise begins with the unpadded run's (one CPU
    # generator, seed 0) and a pose never depends on later frames
    np.testing.assert_array_equal(p0, np.stack(one.poses))
    # the harness alone, batch mode included, leaves no process group
    import torch.distributed as dist
    assert not dist.is_initialized()
    subs = ["results/h/00_pred.txt"] + (["cli/c/00_pred.txt"]
                                        if mode == "hybrid" else [])
    for sub in subs:
        assert os.path.exists(os.path.join(outs[0], sub))
        assert not os.path.exists(os.path.join(outs[1], sub))


def _harness_rank_dir(mesh, root, outs, mode, n):
    return _harness_rank(mesh, root, outs[mesh.rank], mode, n)
