"""The device-resident AKAZE-class front end: the port's
`spsvo_tpu_torch.ops.akaze` against the JAX package's `spsvo_tpu.ops.akaze`
on the same numpy inputs (CPU). The 15 explicit diffusion levels compound
rounding, so the stages are held one by one on injected inputs (the
tolerance in each test), and the whole detector by counts and overlap.

Inputs: a 150x496 corridor frame (`synthetic_corridor`, seed 12) and a
random smooth image."""
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.ops import akaze as tak

H, W = 150, 496


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The front ends are thousands of small CPU ops: with the suite's
    worker processes side by side, torch's default of one thread per core
    in each of them spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _frame():
    frames, _, _, _ = tsyn.synthetic_corridor(
        np.random.default_rng(12), n_frames=1, h=H, w=W, tex_px=1024)
    return frames[0][0].astype(np.float32) / 255.0


def _smooth(rng, h=60, w=90):
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(rng.random((h, w)), 1.5).astype(np.float32)


def _jit(fn, **static):
    import jax
    return jax.jit(functools.partial(fn, **static))


def _t(a):
    return torch.as_tensor(np.array(a))


def test_static_schedules_and_tables_equal():
    """Python and numpy on both sides: equal."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    for T in (0.0, -1.0, 0.1, 0.32, 1.28, 5.12, 20.0):
        assert tak._fed_tau_steps(T) == jak._fed_tau_steps(T)
        if T > 0:
            assert abs(sum(tak._fed_tau_steps(T)) - T) < 1e-12
    for a, b in zip(tak._mldb_tables(), jak._mldb_tables()):
        np.testing.assert_array_equal(a, b)
    assert tak.MLDB_BITS == jak.MLDB_BITS == 488
    for args in ((375, 1242, 512, 4, 4, 31), (150, 496, 256, 4, 4, 16),
                 (96, 320, 100, 3, 2, 16)):
        assert tak._level_quotas_area(*args) == jak._level_quotas_area(*args)
        assert sum(tak._level_quotas_area(*args)) == args[2]


def test_scharr_and_hessian_match(rng):
    """Stencils with the JAX package's order of terms: 1e-6 of the range
    for the first derivatives, 1e-5 of the peak for the Hessian response
    (three stencil passes and a difference of products)."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    L = _smooth(rng)
    jx, jy = _jit(jak._scharr)(L)
    tx, ty = tak._scharr(_t(L))
    for got, want in ((tx, jx), (ty, jy)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    want = np.asarray(_jit(jak.hessian_response, sigma_oct=2.26)(L))
    got = tak.hessian_response(_t(L), 2.26).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # leading dimensions
    both = tak.hessian_response(_t(np.stack([L, L[::-1].copy()])), 2.26)
    np.testing.assert_array_equal(both[0].numpy(), got)


def test_diffusion_step_matches(rng):
    """One explicit step on injected L, g: 1e-6 absolute on values in
    [0, 1]; ten steps in a row stay within 1e-5."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    L = _smooth(rng)
    g = (0.2 + 0.8 * rng.random(L.shape)).astype(np.float32)
    want = np.asarray(_jit(jak._diffusion_step, tau=0.21)(L, g))
    got = tak._diffusion_step(_t(L), _t(g), 0.21).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    step = _jit(jak._diffusion_step, tau=0.25)
    jl, tl = L, _t(L)
    for _ in range(10):
        jl, tl = step(jl, g), tak._diffusion_step(tl, _t(g), 0.25)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    # zero-flux borders: the mean is conserved
    assert abs(float(tl.mean()) - float(L.mean())) < 1e-5


def test_local_max_equal(rng):
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    r = rng.integers(0, 5, (40, 50)).astype(np.float32)     # ties
    np.testing.assert_array_equal(tak._local_max_3x3(_t(r)).numpy(),
                                  np.asarray(jak._local_max_3x3(r)))


def test_quantile_is_jnp_quantile_per_image(rng):
    """Linear interpolation between order statistics, per image of a batch
    (not over the batch): 1e-6 relative."""
    jnp = pytest.importorskip("jax.numpy")
    x = rng.random((3, 37, 41)).astype(np.float32) * np.array(
        [1.0, 5.0, 0.1], np.float32)[:, None, None]
    got = tak._quantile(_t(x), 0.7)
    assert got.shape == (3, 1, 1)
    for b in range(3):
        np.testing.assert_allclose(float(got[b]),
                                   float(jnp.quantile(x[b], 0.7)), rtol=1e-6)


def test_nonlinear_scale_space_matches():
    """The 16 evolution levels of a corridor frame: same shapes, scales and
    octaves; values within 1e-4 on [0, 1] images at the first octave and
    2e-4 at the last (each level adds its cycle's rounding)."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    img = _frame()
    want = _jit(jak.nonlinear_scale_space)(img)
    got = tak.nonlinear_scale_space(_t(img))
    assert len(got) == len(want) == 16
    for (tl, ts, to), (jl, js, jo) in zip(got, want):
        assert to == int(jo) and abs(ts - float(js)) < 1e-6  # jit: fp32
        assert tuple(tl.shape) == (H >> to, W >> to)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=1e-4 if to == 0 else 2e-4)
    # per image: a batch of two gives what each gives alone
    two = tak.nonlinear_scale_space(_t(np.stack([img, img[:, ::-1].copy()])))
    np.testing.assert_array_equal(two[5][0][0].numpy(), got[5][0].numpy())


def test_mldb_descriptors_teacher_forced(rng):
    """Same diffused level image and keypoints through both: differing bits
    under 1e-3 of the 486 comparison bits; the two padding bits are 0."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    L = tak.nonlinear_scale_space(_t(_frame()))[2][0].numpy()
    xy = np.stack([rng.integers(20, W - 20, 256),
                   rng.integers(20, H - 20, 256)], -1).astype(np.int32)
    want = np.asarray(_jit(jak.mldb_descriptors, sigma_oct=2.26)(L, xy))
    got = tak.mldb_descriptors(_t(L), _t(xy), 2.26).numpy()
    assert got.shape == (256, 488) and not got[:, 486:].any()
    assert (got != want).mean() <= 1e-3
    assert 0.2 < got[:, :486].mean() < 0.8


def test_akaze_features_counts_and_overlap():
    """The whole detector, K=256: the same number of valid keypoints, at
    least 95% of them at the same pixel of the same level, and there the
    bits differ in under 1e-2 (held only by counts and overlap: a response
    within rounding of a neighbour's, or of the threshold, moves a peak)."""
    jak = pytest.importorskip("spsvo_tpu.ops.akaze")
    img = _frame()
    want = _jit(jak.akaze_features, k=256)(img)
    got = tak.akaze_features(_t(img), k=256)
    gv, wv = got.valid.numpy(), np.asarray(want.valid)
    assert got.desc.shape == (256, 488)
    assert abs(int(gv.sum()) - int(wv.sum())) <= 2 and wv.sum() > 100
    same = np.all(got.xy.numpy() == np.asarray(want.xy), -1) & gv & wv
    assert same.sum() >= 0.95 * wv.sum()
    assert (got.desc.numpy()[same] != np.asarray(want.desc)[same]
            ).mean() <= 1e-2
    np.testing.assert_allclose(got.score.numpy()[same],
                               np.asarray(want.score)[same], rtol=1e-3)
    # level-0 coordinates of octave o sit on the half-pixel grid
    xy = got.xy.numpy()[gv]
    assert xy.min() >= 16 - 0.5 and xy[:, 0].max() <= W - 16


def test_featureless_image_gives_no_keypoints():
    kp = tak.akaze_features(torch.full((H, W), 0.43), k=64)
    assert not kp.valid.any() and torch.isfinite(kp.desc).all()
