"""The conv work counted from layer shapes reproduces the bounds the kernel
table was measured against."""

import pytest

from vobench import flops


@pytest.mark.parametrize("arch,h,w,b,prec,per_layer,ms", [
    ("superpoint_pretrained", 120, 392, 64, "bf16", True, 0.656),
    ("superpoint_pretrained", 120, 392, 2, "bf16", True, 0.0206),
    ("superpoint_pretrained", 360, 1176, 16, "bf16", True, 1.475),
    ("sp_resnet18", 360, 1176, 2, "fp32", False, 8.252),
    ("superpoint_pretrained", 120, 392, 64, "fp32", False, 7.621),
    ("superpoint_pretrained", 120, 392, 2, "fp32", False, 0.238),
])
def test_bounds(arch, h, w, b, prec, per_layer, ms):
    # the table's numbers are rounded to the digits they show
    digits = len(str(ms).split(".")[1])
    assert round(flops.least_ms(arch, h, w, b, prec, per_layer),
                 digits) == ms


def test_per_layer_bound_is_at_least_the_totals():
    for prec in ("bf16", "fp32"):
        a = flops.least_ms("sp_resnet18", 360, 1176, 2, prec)
        b = flops.least_ms("sp_resnet18", 360, 1176, 2, prec, False)
        assert a >= b


def test_model_flops():
    # 2 x outputs x K of every conv, two images
    assert flops.total_ops("sp_resnet18", 360, 1176, 2) == pytest.approx(
        5.5285e11, rel=1e-4)
    assert flops.total_ops("superpoint_pretrained", 120, 392, 2) == \
        pytest.approx(1.5957e10, rel=1e-4)
