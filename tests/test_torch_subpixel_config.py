"""Sub-pixel keypoint refinement, the sweep enumerations and the utils of
the port against the JAX package (CPU)."""
import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from spsvo_tpu import config as jconfig  # noqa: E402
from spsvo_tpu.ops import postprocess as jpost  # noqa: E402
from spsvo_tpu.utils import checkpoint as jckpt  # noqa: E402
from spsvo_tpu.utils import logging as jlog  # noqa: E402
from spsvo_tpu_torch import config as tconfig  # noqa: E402
from spsvo_tpu_torch.ops import postprocess as tpost  # noqa: E402
from spsvo_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from spsvo_tpu_torch.utils import logging as tlog  # noqa: E402
from spsvo_tpu_torch.utils import profiling as tprof  # noqa: E402


def _heads(rng, b=2, hc=12, wc=20):
    det = rng.normal(size=(b, hc, wc, 65)).astype(np.float32) * 3.0
    desc = rng.normal(size=(b, hc, wc, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return det, desc


@pytest.mark.parametrize("variant", [True, "axis", "quad"])
def test_subpixel_refiners_match_jax(rng, variant):
    """Both refiners on a random heatmap with keypoints on the border and
    invalid slots: 1e-6."""
    heat = rng.random((2, 40, 56)).astype(np.float32)
    xy = np.stack([rng.integers(0, 56, (2, 64)), rng.integers(0, 40, (2, 64))],
                  axis=-1).astype(np.float32)
    xy[:, :4] = [[0, 0], [55, 39], [0, 39], [55, 0]]
    valid = rng.random((2, 64)) > 0.2
    name = "refine_subpixel_quad" if variant == "quad" else "refine_subpixel"
    ref = np.asarray(getattr(jpost, name)(jnp.asarray(heat), jnp.asarray(xy),
                                          jnp.asarray(valid)))
    got = getattr(tpost, name)(torch.as_tensor(heat), torch.as_tensor(xy),
                               torch.as_tensor(valid)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(got - xy).max() <= 0.5 and (got != xy).any()
    np.testing.assert_array_equal(got[~valid], xy[~valid])


@pytest.mark.parametrize("variant", [False, True, "quad"])
def test_extract_keypoints_subpixel_matches_jax(rng, variant):
    """`extract_keypoints(subpixel=...)` refines on the RAW heatmap and
    samples descriptors at the refined positions: xy 1e-5, desc 1e-5."""
    det, desc = _heads(rng)
    kw = dict(k=96, conf_thresh=0.015, nms_radius=4, border=4,
              subpixel=variant)
    ref = jpost.extract_keypoints(jnp.asarray(det), jnp.asarray(desc), **kw)
    got = tpost.extract_keypoints(torch.as_tensor(det), torch.as_tensor(desc),
                                  **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), atol=1e-5)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc),
                               atol=1e-5)
    frac = got.xy.numpy()[got.valid.numpy()] % 1.0
    assert (frac != 0).any() == bool(variant)


def test_extract_keypoints_rejects_unknown_subpixel(rng):
    det, desc = _heads(rng, b=1)
    with pytest.raises(ValueError, match="subpixel_refine='cubic'"):
        tpost.extract_keypoints(torch.as_tensor(det), torch.as_tensor(desc),
                                k=16, conf_thresh=0.015, nms_radius=4,
                                border=4, subpixel="cubic")


def _fields(cfg):
    return {f.name: (getattr(cfg, f.name).value
                     if hasattr(getattr(cfg, f.name), "value")
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name,rows", [("sweep_configs", 72),
                                       ("classic_sweep_configs", 6),
                                       ("device_classic_sweep_configs", 4)])
def test_sweep_enumerations_equal_field_for_field(name, rows):
    """72 + 6 + 4 = 82 rows, each equal to the JAX package's in every
    field, with and without a base config."""
    for kw in (dict(), dict(max_keypoints=321, ransac_iterations=77)):
        ref = getattr(jconfig, name)(jconfig.VOConfig(**kw) if kw else None)
        got = getattr(tconfig, name)(tconfig.VOConfig(**kw) if kw else None)
        assert len(got) == len(ref) == rows
        for a, b in zip(got, ref):
            assert _fields(a) == _fields(b)
            assert a.config_string == b.config_string
    assert tconfig.MODEL_PREFIXES == jconfig.MODEL_PREFIXES


def test_default_config_builds_a_pipeline():
    """`VOConfig()`'s solver defaults (adaptive RANSAC, while-loop LM) are
    supported, and so are sub-pixel refinement with landmark fusion and its
    refinement pass; a classic configuration is sent to the class that
    runs it, and `VOConfig()`'s own family, `sp_mbv1`, names its absent
    ONNX file."""
    from spsvo_tpu_torch.pipeline import VisualOdometry
    cfg = tconfig.VOConfig(model_name_prefix="superpoint_pretrained",
                           image_height=48, image_width=160,
                           max_keypoints=64)
    assert cfg.lm_unroll == 0 and cfg.ransac_chunk == 64
    vo = VisualOdometry(cfg, device="cpu")
    img = (np.random.default_rng(0).random((48, 160)) * 255).astype(np.uint8)
    P = np.array([[100.0, 0, 80, 0], [0, 100.0, 24, 0], [0, 0, 1, 0]])
    T, _ = vo.process(img, img, P, P)
    np.testing.assert_array_equal(T, np.eye(4))
    refine = VisualOdometry(dataclasses.replace(
        cfg, subpixel_refine="quad", landmark_fusion=True,
        landmark_refine=True), device="cpu")
    for shift in (0, 2):
        T, _ = refine.process(np.roll(img, shift, axis=1), img, P, P)
        assert np.isfinite(T).all()
    with pytest.raises(ValueError, match="ClassicVisualOdometry"):
        VisualOdometry(dataclasses.replace(cfg, is_classic=True),
                       device="cpu")
    with pytest.raises(FileNotFoundError, match="sp_mbv1_b1.onnx"):
        VisualOdometry(tconfig.VOConfig(), device="cpu")     # sp_mbv1


def test_runtime_guards_count_like_the_jax_package(caplog):
    quiet = logging.getLogger("test_guards")
    quiet.addHandler(logging.NullHandler())
    guards = [jlog.RuntimeGuards(latency_budget_ms=50.0, logger=quiet),
              tlog.RuntimeGuards(latency_budget_ms=50.0, logger=quiet)]
    for g in guards:
        assert g.check_latency(49.0, 0) and not g.check_latency(51.0, 1)
        assert g.check_matches(10, "a") and not g.check_matches(9, "b")
        assert not g.check_descriptors(3, "left")
        assert g.check_chain_capacity(False)
        assert not g.check_chain_capacity(True, num_chain=64, capacity=64,
                                          frame=3)
    assert guards[0].summary() == guards[1].summary() == {
        "latency": 1, "matches": 1, "descriptors": 1, "chain_capacity": 1}
    assert tlog.get_logger() is tlog.get_logger()
    assert tlog.get_logger().name == "spsvo_tpu_torch"


def test_profiling_spans_csv_and_trace(tmp_path):
    """The span store: spans recorded while tracing is on, in the order
    they opened, under their parent and request, and cleared by the
    snapshot; a device trace holds them as ranges."""
    tprof.enable()
    try:
        for f in range(2):
            with tprof.span("spsvo.frame", request=f):
                with tprof.span("spsvo.frame.launch"):
                    sum(range(1000))
        snap = tprof.snapshot()
    finally:
        tprof.disable()
    assert [(r["name"], r["parent"], r["request"]) for r in snap["spans"]] \
        == [("spsvo.frame", None, 0), ("spsvo.frame.launch", 0, 0),
            ("spsvo.frame", None, 1), ("spsvo.frame.launch", 2, 1)]
    assert all(r["end_ns"] > r["start_ns"] for r in snap["spans"])
    assert tprof.snapshot()["spans"] == []
    with tprof.device_trace(str(tmp_path / "trace")):
        with tprof.span("spsvo.segment", request=0):
            torch.ones(8).sum()
    path = str(tmp_path / "trace" / "trace.json")
    assert os.path.getsize(path) > 0 and "spsvo.segment" in open(path).read()
    assert [r["name"] for r in tprof.snapshot()["spans"]] == [
        "spsvo.segment"]


def test_params_npz_round_trip_across_packages(rng, tmp_path):
    """What either package saves, the other loads: the same names and
    arrays."""
    params = {"conv1a/kernel": rng.normal(size=(3, 3, 1, 4)).astype(np.float32),
              "conv1a/bias": rng.normal(size=4).astype(np.float32)}
    a = tckpt.save_params_npz(str(tmp_path / "t" / "p.npz"),
                              {k: torch.as_tensor(v) for k, v in
                               params.items()})
    b = jckpt.save_params_npz(str(tmp_path / "j.npz"), params)
    for path in (a, b):
        for load in (tckpt.load_params_npz, jckpt.load_params_npz):
            got = load(path)
            assert set(got) == set(params)
            for k, v in params.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v)
