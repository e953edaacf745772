"""The adaptive loops in their two forms, on the CPU: `pnp.ransac_pose`'s
chunked RANSAC (with `refit_polish`'s while-loop polish after it) and
`lm.refine_pose`'s while-loop LM. The early exit (the host reads each
iteration's stop test and ends the loop there; a CUDA graph's conditional
nodes skip the same iterations on the card) against the full-length form
(`host_may_read` answering False, so every iteration runs, masked to the
pairs not yet stopped): bit for bit, over inlier shares, and with a
leading pair dimension whose pairs stop at different iterations.

superpoint_laptop's solve sizes: 500 hypotheses in chunks of 64, 256
solver lanes, at most 10 polish and 40 LM iterations. One torch thread."""
import numpy as np
import pytest
import torch

from spsvo_tpu_torch.eval.synthetic import (DEFAULT_BASELINE_FX, DEFAULT_P_L,
                                            solver_frame)
from spsvo_tpu_torch.ops import lm, pnp
from spsvo_tpu_torch.utils import capture

P_L = torch.as_tensor(DEFAULT_P_L, dtype=torch.float32)
P_R = P_L.clone()
P_R[0, 3] = DEFAULT_BASELINE_FX
LANES, ITERATIONS, CHUNK = 256, 500, 64
SHARES = [0.9, 0.7, 0.5, 0.3]
NAMES = ("pts3d_curr", "pts3d_prev", "uv_prev_l", "uv_prev_r", "uv_curr_l",
         "uv_curr_r", "valid")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(shares, seed=0):
    """Solver inputs of 200 points with the given inlier shares, stacked
    along a leading pair dimension, by name; and the true motions."""
    rng = np.random.default_rng(seed)
    got = [solver_frame(rng, n=200, outlier_frac=1.0 - s, k_pad=LANES)
           for s in shares]
    data = {k: torch.as_tensor(np.stack([d[k] for d, _, _ in got]))
            for k in NAMES}
    return data, [(R, t) for _, R, t in got]


def _both(fn, monkeypatch):
    """fn() early-exiting, then full length: (early, full, the loop bodies
    each ran through `capture.iterate`)."""
    iterate = capture.iterate
    ran = []

    def counted(go, body, loop):
        def counted_body():
            ran[-1] += 1
            body()
        return iterate(go, counted_body, loop)
    monkeypatch.setattr(capture, "iterate", counted)
    ran.append(0)
    early = fn()
    monkeypatch.setattr(capture, "host_may_read", lambda x: False)
    ran.append(0)
    full = fn()
    return early, full, ran


def _ransac(data, pair_dims):
    sl = (slice(None),) if pair_dims else (0,)
    size, n_chunks = pnp.chunking(CHUNK, ITERATIONS)
    gumbel = pnp.gumbel_noise(
        data["valid"][sl].shape[:-1] + (size * n_chunks, LANES),
        torch.Generator().manual_seed(7), "cpu")
    return lambda: pnp.ransac_pose(
        data["pts3d_curr"][sl], data["pts3d_prev"][sl], data["uv_prev_l"][sl],
        data["valid"][sl], P_L, torch.tensor([0.0, 0.0, 0.0, 1.0]),
        torch.zeros(3), iterations=ITERATIONS, chunk=CHUNK, gumbel=gumbel)


def _assert_ransac_equal(early, full):
    for k in ("q", "t", "inliers", "num_inliers", "success", "n_hypotheses"):
        assert torch.equal(getattr(early, k), getattr(full, k)), k


@pytest.mark.parametrize("share", SHARES)
def test_ransac_early_exit_equals_full_length(share, monkeypatch):
    data, _ = _frames([share])
    early, full, ran = _both(_ransac(data, False), monkeypatch)
    _assert_ransac_equal(early, full)
    # full length: 8 chunks and 10 polish iterations, the first unguarded
    assert ran[1] == 8 + 9
    assert ran[0] <= ran[1]
    n_chunks = int(early.n_hypotheses + CHUNK - 1) // CHUNK
    assert ran[0] >= n_chunks


def _lm_start(data, motions, rng):
    """The true poses as xyzw quaternions, perturbed, and inlier masks."""
    from scipy.spatial.transform import Rotation
    q = np.stack([Rotation.from_matrix(R).as_quat() for R, _ in motions])
    t = np.stack([t for _, t in motions])
    q0 = torch.as_tensor((q + 0.01 * rng.normal(size=q.shape)
                          ).astype(np.float32))
    t0 = torch.as_tensor((t + 0.05 * rng.normal(size=t.shape)
                          ).astype(np.float32))
    inl = data["valid"] & torch.as_tensor(rng.random(data["valid"].shape)
                                          > 0.05)
    return q0, t0, inl


def _refine(data, motions, pair_dims, degree=4):
    q0, t0, inl = _lm_start(data, motions, np.random.default_rng(3))
    sl = (slice(None),) if pair_dims else (0,)
    return lambda: lm.refine_pose(
        q0[sl], t0[sl], *(data[k][sl] for k in NAMES[:6]), inl[sl], P_L,
        P_R, refinement_degree=degree, max_iterations=40, unroll=0)


def _assert_lm_equal(early, full):
    for k in ("q", "t", "initial_cost", "final_cost", "improved"):
        assert torch.equal(getattr(early, k), getattr(full, k)), k


@pytest.mark.parametrize("share", SHARES)
def test_lm_early_exit_equals_full_length(share, monkeypatch):
    data, motions = _frames([share])
    early, full, ran = _both(_refine(data, motions, False), monkeypatch)
    _assert_lm_equal(early, full)
    assert ran[1] == 39 and ran[0] < ran[1]


def test_pairs_stopping_apart_equal_full_length(monkeypatch):
    """Two pairs in one call, 90% and 30% inliers: the RANSAC of the
    first stops five chunks before the second's, which runs the whole
    budget; the early exit runs until the last pair stops, the pair
    already stopped frozen, bit for bit the full length; so does the LM
    of the two."""
    data, motions = _frames([0.9, 0.3], seed=1)
    early, full, ran = _both(_ransac(data, True), monkeypatch)
    _assert_ransac_equal(early, full)
    assert early.n_hypotheses.tolist() == [3 * CHUNK, ITERATIONS]
    assert ran[0] <= ran[1]
    monkeypatch.undo()
    early, full, ran = _both(_refine(data, motions, True), monkeypatch)
    _assert_lm_equal(early, full)
    assert ran[0] < ran[1]
