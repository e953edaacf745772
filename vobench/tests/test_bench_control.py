"""The control of each configuration, in the program's place at a small
size on the CPU, is not correct: superpoint_laptop's reference with its
conv operands in TF32 against the reference in fp32, flagship_sp's
program with its int8 trunk against the bf16 reference. On the card the
same readings come from `python3 -m vobench.control --control`."""

import pytest

from vobench import compare, spec
from vobench.control import readings
from vobench.tests import tiny


@pytest.mark.parametrize("workload", ["laptop_online", "flagship_online"])
def test_control_is_not_correct(workload):
    numbers = readings(tiny.run(workload), control=True)
    compared = compare.judge(numbers, spec.limits(workload))
    assert not compare.passed(compared), numbers
