"""Homographic-adaptation data: the port's `spsvo_tpu_torch.io.homography`
against the JAX package's `spsvo_tpu.io.homography` on the same numpy
inputs, with JAX's random draws injected (CPU).

Tolerances, and why:
- homographies: 1e-6 of the largest entry (3x3 float32 products in another
  summation order);
- warped images: within 1e-5, but for under 0.1% of the pixels: `inv(H)`
  (LU in both, other rounding) moves a source coordinate by ~1e-6 px,
  which flips the in-bounds test of a border pixel now and then (measured
  at 48x64: max 1.1e-5, 0.008% of the values beyond 1e-5);
- correspondence matrices and cell labels: exact, keypoints sharing a cell
  included (the highest keypoint index wins, as JAX's serial scatter does
  on the CPU).
Adds ~10 s (one process, one torch thread).
"""
import functools

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spsvo_tpu.io import homography as jh  # noqa: E402
from spsvo_tpu_torch.io import homography as th  # noqa: E402

H_, W_ = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_homography_draws(key, h, w, max_scale=0.2, max_translation=0.1,
                         max_rotation=0.3, max_perspective=0.001):
    """The draws `spsvo_tpu.io.homography.sample_homography(key, ...)`
    makes, as numpy: (s, theta, tx, ty, p)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    s = 1.0 + jax.random.uniform(k1, (), minval=-max_scale,
                                 maxval=max_scale)
    theta = jax.random.uniform(k2, (), minval=-max_rotation,
                               maxval=max_rotation)
    tx = jax.random.uniform(k3, (), minval=-max_translation,
                            maxval=max_translation) * w
    ty = jax.random.uniform(k4, (), minval=-max_translation,
                            maxval=max_translation) * h
    p = jax.random.uniform(k5, (2,), minval=-max_perspective,
                           maxval=max_perspective)
    return tuple(np.asarray(v) for v in (s, theta, tx, ty, p))


def stacked_draws(keys, h, w, **ranges) -> th.HomographyDraws:
    per = [jax_homography_draws(k, h, w, **ranges) for k in keys]
    return th.HomographyDraws(*[torch.tensor(np.stack([d[i] for d in per]))
                                for i in range(5)])


@functools.lru_cache(maxsize=None)
def _jax_fns():
    warp = jax.jit(jax.vmap(jh.warp_image))
    corr = jax.jit(jax.vmap(lambda H: jh.cell_correspondence(H, H_, W_)))
    labels = jax.jit(jax.vmap(
        lambda xy, v: jh.keypoints_to_cell_labels(xy, v, H_, W_)))
    batch = jax.jit(jh.make_homographic_batch)
    return warp, corr, labels, batch


def assert_warp_close(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert (err > 1e-5).mean() < 1e-3, (err.max(), (err > 1e-5).mean())


def test_homographies_equal_with_jax_draws():
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    Hj = np.stack([np.asarray(jh.sample_homography(k, H_, W_)) for k in keys])
    Ht = th.homography_from_draws(stacked_draws(keys, H_, W_), H_, W_)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0,
                               atol=1e-6 * np.abs(Hj).max())


def test_draws_follow_the_ranges_and_the_seed():
    """Drawn from a generator: within the ranges, and one seed gives one
    set of draws."""
    d = th.draw_homographies(4096, H_, W_, torch.Generator().manual_seed(0))
    assert (d.s - 1).abs().max() <= 0.2 and d.theta.abs().max() <= 0.3
    assert d.tx.abs().max() <= 0.1 * W_ and d.ty.abs().max() <= 0.1 * H_
    assert d.p.abs().max() <= 0.001 and (d.s - 1).abs().max() > 0.19
    H1 = th.sample_homography(H_, W_, batch=3,
                              generator=torch.Generator().manual_seed(5))
    H2 = th.sample_homography(H_, W_, batch=3,
                              generator=torch.Generator().manual_seed(5))
    assert torch.equal(H1, H2) and H1.shape == (3, 3, 3)


def test_warp_points_matches_jax(rng):
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    Hj = np.stack([np.asarray(jh.sample_homography(k, H_, W_)) for k in keys])
    xy = rng.uniform(-10, 80, (3, 50, 2)).astype(np.float32)
    ref = np.asarray(jax.vmap(jh.warp_points)(jnp.asarray(Hj),
                                              jnp.asarray(xy)))
    ours = th.warp_points(torch.tensor(Hj), torch.tensor(xy)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-4)


def test_warp_image_matches_jax(rng):
    warp, *_ = _jax_fns()
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    Hj = np.stack([np.asarray(jh.sample_homography(k, H_, W_)) for k in keys])
    img = rng.random((4, H_, W_, 1), np.float32)
    ref = np.asarray(warp(jnp.asarray(img), jnp.asarray(Hj)))
    Ht = th.homography_from_draws(stacked_draws(keys, H_, W_), H_, W_)
    ours = th.warp_image(torch.tensor(img), Ht)
    assert ours.shape == img.shape
    assert_warp_close(ours, ref)
    # the unbatched forms, (h, w) and (h, w, C), as the JAX function takes
    one = th.warp_image(torch.tensor(img[0, ..., 0]), Ht[0])
    assert one.shape == (H_, W_)
    assert_warp_close(one, ref[0, ..., 0])
    assert torch.allclose(th.warp_image(torch.tensor(img[0]), torch.eye(3)),
                          torch.tensor(img[0]), atol=1e-6)


def test_cell_correspondence_equal():
    _, corr, _, _ = _jax_fns()
    keys = jax.random.split(jax.random.PRNGKey(8), 4)
    Hj = np.stack([np.asarray(jh.sample_homography(k, H_, W_)) for k in keys]
                  + [np.eye(3, dtype=np.float32)])
    ref = np.asarray(corr(jnp.asarray(Hj)))
    ours = th.cell_correspondence(torch.tensor(Hj), H_, W_).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ref.sum() > 5 * (H_ // 8) * (W_ // 8)


def test_cell_labels_equal_with_shared_cells(rng):
    """Several keypoints in one cell (the highest index wins in both),
    invalid keypoints, and points outside the image (clamped)."""
    *_, labels, _ = _jax_fns()
    xy = rng.uniform(-5, 70, (3, 40, 2)).astype(np.float32)
    xy[:, 20:] = xy[:, :20] + rng.uniform(-0.9, 0.9, (3, 20, 2))
    xy[:, 35:] = xy[:, 5:10]                      # exact duplicates
    valid = rng.random((3, 40)) < 0.8
    ref = np.asarray(labels(jnp.asarray(xy), jnp.asarray(valid)))
    ours = th.keypoints_to_cell_labels(torch.tensor(xy), torch.tensor(valid),
                                       H_, W_)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ref != 64).sum() > 20


def test_make_homographic_batch_matches_jax(rng):
    *_, batch_fn = _jax_fns()
    key = jax.random.PRNGKey(11)
    images = rng.random((3, H_, W_, 1), np.float32)
    xy = rng.uniform(0, 64, (3, 30, 2)).astype(np.float32)
    valid = rng.random((3, 30)) < 0.9
    ref = batch_fn(key, jnp.asarray(images), jnp.asarray(xy),
                   jnp.asarray(valid))
    draws = stacked_draws(jax.random.split(key, 3), H_, W_)
    ours = th.make_homographic_batch(torch.tensor(images), torch.tensor(xy),
                                     torch.tensor(valid), draws=draws)
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours["image_a"].numpy(), ref["image_a"])
    assert_warp_close(ours["image_b"], ref["image_b"])
    for k in ("labels_a", "labels_b", "correspondence"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    # drawn from a generator instead: same shapes and types
    drawn = th.make_homographic_batch(
        torch.tensor(images), torch.tensor(xy), torch.tensor(valid),
        generator=torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in drawn.items()} == \
        {k: v.shape for k, v in ours.items()}
