"""Port parity: the SuperPoint postprocess (softmax, depth-to-space, NMS,
top-K, descriptor sampling) against the JAX package on the same det/desc
inputs (CPU)."""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spsvo_tpu.ops import postprocess as jpp  # noqa: E402
from spsvo_tpu_torch.ops import postprocess as tpp  # noqa: E402


def _heads(rng, b=2, hc=12, wc=20):
    det = (rng.normal(size=(b, hc, wc, 65)) * 3.0).astype(np.float32)
    det[..., 64] += 2.0                                # dustbin-heavy cells
    desc = rng.normal(size=(b, hc, wc, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return det, desc


def _t(x):
    return torch.as_tensor(np.array(x))


def test_cell_softmax_and_depth_to_space(rng):
    det, _ = _heads(rng)
    np.testing.assert_allclose(tpp.cell_softmax(_t(det)).numpy(),
                               np.asarray(jpp.cell_softmax(jnp.asarray(det))),
                               atol=1e-6)
    x = rng.random((2, 5, 7, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tpp.depth_to_space(_t(x)).numpy(),
        np.asarray(jpp.depth_to_space(jnp.asarray(x))))


@pytest.mark.parametrize("radius,iters", [(4, 2), (2, 1), (1, 3)])
def test_nms_identical(rng, radius, iters):
    # quantised scores: exact ties between neighbours exercise the equality
    # tests inside the iterated max-pool NMS
    s = np.floor(rng.random((2, 48, 64)) * 8).astype(np.float32) / 8
    s[s < 0.5] = 0.0
    np.testing.assert_array_equal(
        tpp.nms(_t(s), radius, iters).numpy(),
        np.asarray(jpp.nms(jnp.asarray(s), radius, iters)))


@pytest.mark.parametrize("radius", [4, 0])
def test_select_topk_stable_on_ties(rng, radius):
    """Equal scores keep the lowest index first (lax.top_k's order), on the
    4x4 block path (radius >= 3) and on the flat path."""
    s = np.floor(rng.random((2, 48, 64)) * 4).astype(np.float32) / 4
    s = np.asarray(jpp.nms(jnp.asarray(s), max(radius, 1), 2))
    args = dict(k=100, conf_thresh=0.1, border=4, post_nms_radius=radius)
    xy_j, sc_j, v_j = jpp.select_topk(jnp.asarray(s), **args)
    xy_t, sc_t, v_t = tpp.select_topk(_t(s), **args)
    np.testing.assert_array_equal(xy_t.numpy(), np.asarray(xy_j))
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("k,conf,radius,border", [(64, 0.015, 4, 4),
                                                  (200, 0.005, 4, 8),
                                                  (128, 0.015, 2, 4)])
def test_extract_keypoints_identical(rng, k, conf, radius, border):
    det, desc = _heads(rng)
    args = dict(k=k, conf_thresh=conf, nms_radius=radius, border=border)
    ref = jpp.extract_keypoints(jnp.asarray(det), jnp.asarray(desc), **args)
    got = tpp.extract_keypoints(_t(det), _t(desc), **args)
    assert int(np.asarray(ref.valid).sum()) > 10
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score),
                               atol=1e-6)
    np.testing.assert_allclose(got.desc.numpy(), np.asarray(ref.desc),
                               atol=1e-5)


def test_sample_descriptors_subpixel_positions(rng):
    _, desc = _heads(rng)
    xy = np.stack([rng.uniform(0, 159, (2, 50)),
                   rng.uniform(0, 95, (2, 50))], -1).astype(np.float32)
    np.testing.assert_allclose(
        tpp.sample_descriptors(_t(desc), _t(xy), (96, 160)).numpy(),
        np.asarray(jpp.sample_descriptors(jnp.asarray(desc), jnp.asarray(xy),
                                          (96, 160))), atol=1e-5)
