"""A run with no card fails rather than falls back to the CPU, and the
import check compares whole top-level module names."""

import subprocess
import sys

import torch

from vobench import run as bench_run
from vobench.run import forbidden_modules


def test_no_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench_run.main(["--workload", "flagship_online", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2
    assert out.out == ""
    assert "never runs on the CPU" in out.err


def test_forbidden_names():
    assert forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_modules(["jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jaxlib"]
    assert forbidden_modules(["spsvo_tpu.ops.image"]) == ["spsvo_tpu"]
    assert forbidden_modules(["spsvo_tpu_torch", "spsvo_tpu_torch.ops",
                              "spsvo_tpu_tools", "jaxtyping"]) == []


def test_a_run_loads_no_jax():
    """A whole run at a small size on the CPU, in a fresh interpreter,
    leaves none of the forbidden modules loaded."""
    code = (
        "from vobench.tests import tiny\n"
        "from vobench.run import execute, forbidden_modules\n"
        "out = execute(tiny.run('flagship_online'))\n"
        "assert out['result']['correct'], out['numbers']\n"
        "print(forbidden_modules())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=bench_run.spec.ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
