"""Port parity of the fused solver (kernel 2): its plain PyTorch version
against the JAX package's TPU kernel itself (`solver_pallas.fused_solve`,
Pallas interpret mode) on the same hypotheses, in both winner branches, the
gate fallback and the GLS (weighted LM) pass, at the main-path lane count
(CPU). The `gpu` test holds the CUDA kernel against the plain version on the
card."""
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_solver import (MAX_LANES, P_L, P_R, Q_ATOL, T_ATOL,  # noqa: E402
                               _cfgs, _jax_gumbel, _jprep, _t)

from spsvo_tpu_torch.eval.synthetic import (prepared_from_frame,  # noqa: E402
                                            solver_frame)
from spsvo_tpu_torch.ops import solver_cuda  # noqa: E402


# the GLS case compiles a second interpreted kernel: it runs from its own
# file (test_torch_solver_gls.py) so each file stays well inside its budget
_FUSED_CASES = ["sampled_wins", "prior_wins", "gate_fallback"]
ALL_CASES = _FUSED_CASES + ["weighted_lm"]


def _fused_case(rng, case):
    from scipy.spatial.transform import Rotation
    data, R, t = solver_frame(rng, n=110, outlier_frac=0.15, k_pad=128)
    q0 = np.array([0, 0, 0, 1.0], np.float32)
    t0 = np.zeros(3, np.float32)
    weights = None
    if case == "prior_wins":
        q0 = Rotation.from_matrix(R).as_quat().astype(np.float32)
        t0 = t.astype(np.float32)
    elif case == "gate_fallback":
        data["uv_prev_l"] = data["uv_prev_l"] + 500.0
        q0 = np.array([0.1, 0.0, 0.0, 0.99], np.float32)
        q0 /= np.linalg.norm(q0)
        t0 = np.array([0.3, 0.0, -1.0], np.float32)
    elif case == "weighted_lm":
        weights = rng.integers(1, 12, 128).astype(np.float32)
    return data, q0, t0, weights


@functools.lru_cache(maxsize=None)
def _pallas_fused(weighted: bool):
    """One jitted interpret-mode TPU kernel per static configuration (the
    interpreter compiles the whole unrolled kernel; eager calls would
    recompile it per case)."""
    import jax

    from spsvo_tpu.ops import solver_pallas
    jcfg, _ = _cfgs(ransac_iterations=256, lm_unroll=3)

    def run(hyp, prep, P_l, P_r, q0, t0, weights):
        return solver_pallas.fused_solve(
            solver_pallas.FusedHypotheses(hyp), prep, P_l, P_r, q0, t0, 5,
            jcfg, interpret=True, lane_weights=weights if weighted else None)
    return jax.jit(run)


@pytest.mark.parametrize("case", _FUSED_CASES)
def test_fused_solve_plain_matches_pallas_interpret(rng, case):
    """The kernel's plain version against the TPU kernel itself on the same
    hypotheses, at the main-path shapes (S=256, L=128; 3 unrolled LM
    iterations to keep the interpreter's compile short)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import solver_pallas
    jcfg, tcfg = _cfgs(ransac_iterations=256, lm_unroll=3)
    data, q0, t0, weights = _fused_case(rng, case)
    jprep = _jprep(data)
    hyp = solver_pallas.precompute_hypotheses(jax.random.PRNGKey(3), jprep,
                                              jcfg)
    w = np.ones(128, np.float32) if weights is None else weights
    ref = _pallas_fused(weights is not None)(
        hyp.hyp, jprep, jnp.asarray(P_L), jnp.asarray(P_R), jnp.asarray(q0),
        jnp.asarray(t0), jnp.asarray(w))
    got = solver_cuda.fused_solve(
        _t(hyp.hyp), prepared_from_frame(data),
        _t(P_L), _t(P_R), _t(q0), _t(t0), 5, tcfg,
        lane_weights=None if weights is None else _t(weights))
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=Q_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=T_ATOL)
    np.testing.assert_allclose(got.q_pred.numpy(), np.asarray(ref.q_pred),
                               atol=Q_ATOL)
    np.testing.assert_allclose(got.t_pred.numpy(), np.asarray(ref.t_pred),
                               atol=T_ATOL)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= MAX_LANES
    assert bool(got.pnp_success) == bool(ref.pnp_success)
    assert bool(got.accel_anomaly) == bool(ref.accel_anomaly)
    assert int(got.num_chain) == int(ref.num_chain)
    assert bool(got.prior_winner) == bool(ref.prior_winner)
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= MAX_LANES
    assert bool(got.prior_winner) == (case == "prior_wins")
    if case == "gate_fallback":
        assert not bool(got.pnp_success)
        np.testing.assert_allclose(got.q.numpy(), q0, atol=1e-6)
        np.testing.assert_allclose(got.t.numpy(), t0, atol=1e-6)


def test_precompute_hypotheses_injected_noise(rng):
    jax = pytest.importorskip("jax")

    from spsvo_tpu.ops import solver_pallas
    jcfg, tcfg = _cfgs(ransac_iterations=256)
    data, _, _ = solver_frame(rng, n=110, outlier_frac=0.15, k_pad=128)
    key = jax.random.PRNGKey(9)
    ref = solver_pallas.precompute_hypotheses(key, _jprep(data), jcfg)
    got = solver_cuda.precompute_hypotheses(
        prepared_from_frame(data), tcfg, gumbel=_t(_jax_gumbel(key, (256, 128))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.hyp), atol=1e-4)




@pytest.mark.gpu
@pytest.mark.parametrize("case", ALL_CASES)
def test_cuda_fused_solve_matches_plain(rng, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from spsvo_tpu_torch.presets import flagship_tpu
    dev = torch.device("cuda")
    cfg = flagship_tpu()
    data, q0, t0, weights = _fused_case(rng, case)
    prep = prepared_from_frame(data, dev)
    hyp = solver_cuda.precompute_hypotheses(
        prep, cfg, generator=torch.Generator(dev).manual_seed(0))
    p = solver_cuda.solve_params(cfg, weighted_lm=weights is not None)
    pts = solver_cuda.pack_points(
        prep, None if weights is None else _t(weights).to(dev))[None]
    scal = solver_cuda.pack_scalars(_t(q0).to(dev), _t(t0).to(dev), 5,
                                    _t(P_L).to(dev), _t(P_R).to(dev))[None]
    h = hyp[None].contiguous()
    out_k, inl_k = solver_cuda.fused_solve_packed(pts, h, scal, p)
    out_p, inl_p = solver_cuda.fused_solve_plain(pts, h, scal, p)
    torch.cuda.synchronize()
    ok, op = out_k[0].cpu(), out_p[0].cpu()
    torch.testing.assert_close(ok[0:4], op[0:4], atol=Q_ATOL, rtol=0)
    torch.testing.assert_close(ok[4:7], op[4:7], atol=T_ATOL, rtol=0)
    torch.testing.assert_close(ok[7:11], op[7:11], atol=Q_ATOL, rtol=0)
    torch.testing.assert_close(ok[11:14], op[11:14], atol=T_ATOL, rtol=0)
    assert abs(ok[14] - op[14]) <= MAX_LANES
    assert torch.equal(ok[15:17], op[15:17]) and ok[19] == op[19]
    assert ((inl_k > 0) != (inl_p > 0)).sum().item() <= MAX_LANES
