"""Port parity of the fused solver's GLS pass (landmark fusion's weighted
LM, run inside the kernel when lane weights are given): the plain PyTorch
version against the JAX package's TPU kernel in Pallas interpret mode on
the same hypotheses and lane weights (CPU)."""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_solver_kernel import (  # noqa: E402,F401
    test_fused_solve_plain_matches_pallas_interpret as _check)


def test_fused_solve_plain_gls_matches_pallas_interpret(rng):
    _check(rng, "weighted_lm")
