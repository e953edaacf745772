"""The device-resident ORB-class front ends: the port's
`spsvo_tpu_torch.ops.orb` against the JAX package's `spsvo_tpu.ops.orb`,
function by function on the same numpy inputs (CPU). Integer stages (FAST,
quotas, tables, top-K on ties) are held to equality; float stages to the
tolerance each test states; descriptor bits teacher-forced (same keypoints,
same level image) to a bound on the fraction of differing bits. The `gpu`
test holds the card against the CPU.

Inputs: random uint8 images and 150x496 corridor frames
(`synthetic_corridor`, seed 12)."""
import functools

import numpy as np
import pytest
import torch

from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.ops import orb as torb
from spsvo_tpu_torch.ops.image import bilinear_resize as t_resize

H, W = 150, 496
# teacher-forced descriptor bits: a bit flips only where the two compared
# samples are closer than the float stages' rounding (the JAX package holds
# its own two formulations to 1e-3, tests/test_orb.py)
BIT_FRAC = 1e-3


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
def _corridor():
    frames, _, _, _ = tsyn.synthetic_corridor(
        np.random.default_rng(12), n_frames=2, h=H, w=W, tex_px=1024)
    return np.stack([np.stack(f) for f in frames])          # (2, 2, H, W) u8


def _image(source, rng=None):
    if source == "corridor":
        return _corridor()[0, 0]
    # smooth random blobs on noise: FAST fires on both, ties everywhere
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    img[40:90, 100:300] = rng.integers(0, 4, (50, 200)) * 60
    return img.astype(np.uint8)


def _jit(fn, **static):
    import jax
    return jax.jit(functools.partial(fn, **static))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("threshold", [20, 7])
@pytest.mark.parametrize("nms", [True, False], ids=["nms", "raw"])
@pytest.mark.parametrize("source", ["random", "corridor"])
def test_fast_score_map_bit_equal(rng, source, nms, threshold):
    """Integer arithmetic end to end: equal, with leading dimensions too."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    img = _image(source, rng)
    want = np.asarray(_jit(jorb.fast_score_map, threshold=threshold,
                           nms=nms)(img))
    got = torb.fast_score_map(_t(img), threshold, nms=nms)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 50
    both = torb.fast_score_map(_t(np.stack([img, img[::-1].copy()]))[None],
                               threshold, nms=nms)
    assert both.shape == (1, 2, H, W) and torch.equal(both[0, 0], got)


@pytest.mark.parametrize("sigma,radius", [(2.0, 3), (1.0, None), (0.5, None),
                                          (3.9, None)])
def test_gaussian_blur_matches(rng, sigma, radius):
    """Taps summed in the JAX package's order: 1e-6 relative on grey levels
    (a fused multiply-add in one of the two is the only difference)."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    img = _image("random", rng).astype(np.float32)
    want = np.asarray(_jit(jorb.gaussian_blur, sigma=sigma,
                           radius=radius)(img))
    got = torb.gaussian_blur(_t(img), sigma, radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    if radius == 3:
        np.testing.assert_array_equal(
            torb.gaussian_blur7(_t(img)[None])[0].numpy(), got)


def test_ic_moment_maps_and_orientation(rng):
    """Integer images: every partial sum is exact, so equal. Float images
    (an upper pyramid level): 1e-5 of the map's range. Orientation at the
    same keypoints: 1e-5."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    img = _image("corridor").astype(np.float32)
    np.testing.assert_array_equal(
        torb.ic_moment_maps(_t(img)).numpy(),
        np.asarray(_jit(jorb.ic_moment_maps)(img)))
    lvl = t_resize(_t(img), 125, 413).numpy()
    want = np.asarray(_jit(jorb.ic_moment_maps)(lvl))
    got = torb.ic_moment_maps(_t(lvl)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    xy = np.stack([rng.integers(16, 413 - 16, 200),
                   rng.integers(16, 125 - 16, 200)], -1).astype(np.int32)
    jc, js = _jit(jorb.ic_orientation)(lvl, xy)
    tc, ts = torb.ic_orientation(_t(lvl), _t(xy))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_shi_tomasi_score_map_matches(rng):
    """Sums of products of integer gradients, exact below 2^24; the square
    root and the last subtraction leave 1e-6 of the map's peak."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    img = _image("corridor").astype(np.float32)
    want = np.asarray(_jit(jorb.shi_tomasi_score_map)(img))
    got = torb.shi_tomasi_score_map(_t(img)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_static_tables_equal():
    """Pattern, ring tables, patch masks, level shapes and quotas are numpy
    and Python on both sides: equal."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    np.testing.assert_array_equal(torb.make_brief_pattern(),
                                  jorb.make_brief_pattern())
    assert torb.make_brief_pattern().shape == (256, 2, 2)
    for a, b in zip(torb._brisk_tables(), jorb._brisk_tables()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(torb._ic_masks(), jorb._ic_masks()):
        np.testing.assert_array_equal(a, b)
    assert torb._ic_row_widths() == jorb._ic_row_widths()
    assert torb.FAST_CIRCLE == jorb.FAST_CIRCLE
    for args in ((375, 1242, 512, 8, 1.2, 31), (150, 496, 256, 2, 1.2, 16),
                 (120, 392, 500, 8, 1.2, 31), (96, 320, 100, 4, 1.5, 16)):
        assert (list(torb.level_quotas(*args))
                == list(jorb.level_quotas(*args)))
        assert sum(torb.level_quotas(*args)) == args[2]
        assert (list(torb._level_shapes(args[0], args[1], args[3], args[4]))
                == list(jorb._level_shapes(args[0], args[1], args[3],
                                           args[4])))
    with pytest.raises(ValueError, match="usable"):
        torb.level_quotas(60, 60, 100, 2, 1.2, 31)


def test_shift_matches():
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    a = np.arange(2 * 5 * 7, dtype=np.int32).reshape(2, 5, 7)
    for dy, dx in ((0, 0), (2, -1), (-3, 3), (1, 0)):
        np.testing.assert_array_equal(torb._shift(_t(a), dy, dx).numpy(),
                                      np.asarray(jorb._shift(a, dy, dx)))


def test_top_keypoints_keeps_lowest_index_on_ties(rng):
    """A FAST map is full of ties: the port's stable top-K picks what
    `jax.lax.top_k` picks, in the same order."""
    jax = pytest.importorskip("jax")
    score = rng.integers(0, 4, (3, 40, 50)).astype(np.int32)
    xy, top, valid = torb.top_keypoints(_t(score), 300)
    for b in range(3):
        want_s, want_i = jax.lax.top_k(score[b].reshape(-1), 300)
        np.testing.assert_array_equal(top[b].numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(
            (xy[b, :, 1] * 50 + xy[b, :, 0]).numpy(), np.asarray(want_i))
    assert torch.equal(valid, top > 0)


def _level_inputs(rng, level):
    """An unrounded pyramid level of a corridor frame and keypoints inside
    its 16 px border."""
    img = _t(_image("corridor").astype(np.float32))
    h, w = H, W
    for lvl in range(1, level + 1):
        h, w = torb._level_shapes(H, W, level + 1, 1.2)[lvl]
        img = t_resize(img, h, w)
    xy = np.stack([rng.integers(16, w - 16, 256),
                   rng.integers(16, h - 16, 256)], -1).astype(np.int32)
    return img.numpy(), xy


@pytest.mark.parametrize("level", [0, 2])
def test_brief_descriptors_teacher_forced(rng, level):
    """Same level image, keypoints and angles through both: differing bits
    under BIT_FRAC; the whole `_describe` chain (orientation, blur, bits) on
    the same level image likewise."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    lvl, xy = _level_inputs(rng, level)
    ang = rng.uniform(0, 2 * np.pi, 256).astype(np.float32)
    blur = np.asarray(_jit(jorb.gaussian_blur7)(lvl))
    want = np.asarray(_jit(jorb.brief_descriptors)(blur, xy, np.cos(ang),
                                                   np.sin(ang)))
    got = torb.brief_descriptors(_t(blur), _t(xy), _t(np.cos(ang)),
                                 _t(np.sin(ang))).numpy()
    assert got.shape == (256, 256) and set(np.unique(got)) == {0.0, 1.0}
    assert (got != want).mean() <= BIT_FRAC
    want = np.asarray(_jit(jorb._describe, descriptor="brief",
                           pattern=None)(lvl, xy))
    got = torb._describe(_t(lvl), _t(xy), "brief", None).numpy()
    assert (got != want).mean() <= BIT_FRAC
    # an explicit pattern, and leading dimensions
    pat = torb.make_brief_pattern()[:64]
    one = torb.brief_descriptors(_t(blur), _t(xy), _t(np.cos(ang)),
                                 _t(np.sin(ang)), pat)
    two = torb.brief_descriptors(_t(blur)[None], _t(xy)[None],
                                 _t(np.cos(ang))[None], _t(np.sin(ang))[None],
                                 pat)
    assert one.shape == (256, 64) and torch.equal(two[0], one)


@pytest.mark.parametrize("level", [0, 1])
def test_brisk_descriptors_teacher_forced(rng, level):
    """512 ring-pattern bits and the long-pair orientation on the same
    level image and keypoints, against the JAX function evaluated op by op:
    bits under BIT_FRAC, 99% of the angles within 1e-4 (the positions are
    random, many on flat texture where the orientation gradient is rounding
    noise and the (K, 60) x (60, 2) product's order shows). Against the
    jitted JAX program the bit bound is 1e-2: XLA's fused program differs
    from JAX's own op-by-op result in ~0.3% of the bits there."""
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    lvl, xy = _level_inputs(rng, level)
    td, tc, ts = torb.brisk_descriptors(_t(lvl), _t(xy))
    assert td.shape == (256, 512)
    jd, jc, js = jorb.brisk_descriptors(lvl, xy)
    assert (td.numpy() != np.asarray(jd)).mean() <= BIT_FRAC
    for a, b in ((tc, jc), (ts, js)):
        assert (np.abs(a.numpy() - np.asarray(b)) <= 1e-4).mean() >= 0.99
    jd, _, _ = _jit(jorb.brisk_descriptors)(lvl, xy)
    assert (td.numpy() != np.asarray(jd)).mean() <= 1e-2
    with pytest.raises(ValueError, match="unknown device descriptor"):
        torb._describe(_t(lvl), _t(xy), "sift", None)


def _assert_keypoints_match(got, want, n_exact=None, overlap=0.99):
    """Valid counts equal; the first `n_exact` slots (level 0) equal in xy,
    score and validity; over all slots at least `overlap` of the keypoints
    coincide, and where they do the bits differ in under BIT_FRAC."""
    gxy, gs, gv, gd = (a.numpy() for a in got)
    wxy, ws, wv, wd = (np.asarray(a) for a in want)
    assert gd.shape == wd.shape and gv.sum() == wv.sum() > 0
    if n_exact:
        np.testing.assert_array_equal(gxy[..., :n_exact, :],
                                      wxy[..., :n_exact, :])
        np.testing.assert_array_equal(gs[..., :n_exact], ws[..., :n_exact])
        np.testing.assert_array_equal(gv[..., :n_exact], wv[..., :n_exact])
    same = np.all(gxy == wxy, -1) & gv & wv
    assert same.sum() >= overlap * wv.sum(), (same.sum(), wv.sum())
    assert (gd[same] != wd[same]).mean() <= BIT_FRAC


def test_pyramid_levels_round_alike():
    """Level 0 is integers. Upper levels are resized from the unrounded
    previous one with the taps in the JAX package's order: equal to the JAX
    resize evaluated op by op. Against the jitted JAX resize (XLA contracts
    the two lerps) the float levels agree to 1e-4 grey levels and their
    rounded images, what FAST sees, differ in under 1e-3 of the pixels."""
    pytest.importorskip("jax")
    from spsvo_tpu.ops.image import bilinear_resize as j_resize
    img = _image("corridor").astype(np.float32)
    tl, jl, je = _t(img), img, img
    for h, w in torb._level_shapes(H, W, 4, 1.2)[1:]:
        tl = t_resize(tl, h, w)
        je = np.asarray(j_resize(je, h, w))
        np.testing.assert_array_equal(tl.numpy(), je)
        jl = np.asarray(_jit(j_resize, dst_h=h, dst_w=w)(jl))
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4)
        assert (np.round(tl.numpy()) != np.round(jl)).mean() <= 1e-3


KW = dict(k=256, n_levels=2, border=16)


@functools.lru_cache(maxsize=None)
def _jax_batch(detector, descriptor):
    """The jitted JAX front end (vmap) over the 4 corridor images, compiled
    once per setting."""
    from spsvo_tpu.ops import orb as jorb
    imgs = _corridor().reshape(4, H, W).astype(np.float32) / 255.0
    out = _jit(jorb.orb_frontend_batch, detector=detector,
               descriptor=descriptor, **KW)(imgs)
    return imgs, type(out)(*(np.asarray(a) for a in out))


@pytest.mark.parametrize("descriptor", ["brief", "brisk"])
def test_orb_features_match(descriptor):
    """The whole detector on one corridor frame, 2 levels, K=256: level-0
    keypoints (the first quota) equal bit for bit; over all levels the
    valid counts are equal and at least 99% of the keypoints coincide."""
    pytest.importorskip("jax")
    imgs, want = _jax_batch("orb", descriptor)
    got = torb.orb_features(_t(imgs[1]), descriptor=descriptor, **KW)
    q0 = torb.level_quotas(H, W, 256, 2, 1.2, 16)[0]
    _assert_keypoints_match(got, type(want)(*(a[1] for a in want)),
                            n_exact=q0)
    assert got.desc.shape == (256, torb.descriptor_bits(descriptor))


def test_gftt_features_match():
    """Single scale: 99% of the keypoints coincide (the response map's 1e-6
    differences can reorder near-equal peaks), scores within 1e-5."""
    pytest.importorskip("jax")
    imgs, want = _jax_batch("shi_tomasi", "brief")
    got = torb.gftt_features(_t(imgs[2]), k=256)
    _assert_keypoints_match(got, type(want)(*(a[2] for a in want)))
    np.testing.assert_allclose(got.score.numpy(), want.score[2], rtol=1e-5)


@pytest.mark.parametrize("detector,descriptor", [
    ("orb", "brief"), ("orb", "brisk"), ("shi_tomasi", "brief"),
    ("akaze", "mldb")])
def test_orb_frontend_batch_matches_and_chunks(detector, descriptor):
    """All four detector/descriptor settings over the 4 corridor images
    against the JAX batch (vmap): counts equal, 99% of keypoints coincide
    (AKAZE: 95%, its 15 diffusion levels compound rounding); and an image's
    result does not depend on the chunk it is in: chunked equals unchunked
    bit for bit."""
    pytest.importorskip("jax")
    imgs, want = _jax_batch(detector, descriptor)
    kw = dict(detector=detector, descriptor=descriptor, **KW)
    got = torb.orb_frontend_batch(_t(imgs), **kw)
    _assert_keypoints_match(got, want,
                            overlap=0.95 if detector == "akaze" else 0.99)
    assert got.xy.shape == (4, 256, 2)
    for chunk in (1, 3):
        part = torb.orb_frontend_batch(_t(imgs), chunk=chunk, **kw)
        for a, b in zip(part, got):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown device detector"):
        torb.orb_frontend_batch(_t(imgs), k=8, detector="sift")


def test_frontend_kwargs_follow_the_config():
    jorb = pytest.importorskip("spsvo_tpu.ops.orb")
    from spsvo_tpu import config as jconfig
    from spsvo_tpu_torch import config as tconfig
    for det, desc in (("ORB", "ORB"), ("ORB", "BRISK"), ("SHI_TOMASI", "ORB"),
                      ("AKAZE", "AKAZE")):
        kws = [o.frontend_kwargs(c.VOConfig(
            is_classic=True, device_classic=True, max_keypoints=300,
            orb_n_levels=5, orb_edge_threshold=19,
            detector_type=c.DetectorType[det],
            descriptor_type=c.DescriptorType[desc]))
            for o, c in ((jorb, jconfig), (torb, tconfig))]
        assert kws[0] == kws[1] and kws[1]["k"] == 300
    assert [torb.descriptor_bits(d) for d in ("brief", "brisk", "mldb")] == [
        256, 512, 488]


def test_featureless_image_gives_no_keypoints():
    kp = torb.orb_features(torch.full((2, H, W), 0.43), k=64, n_levels=2,
                           border=16)
    assert not kp.valid.any() and torch.isfinite(kp.desc).all()
    kp = torb.gftt_features(torch.full((H, W), 0.43), k=64)
    assert not kp.valid.any()


@pytest.mark.gpu
@pytest.mark.parametrize("detector,descriptor", [
    ("orb", "brief"), ("orb", "brisk"), ("shi_tomasi", "brief"),
    ("akaze", "mldb")])
def test_frontend_on_the_card_matches_cpu(detector, descriptor):
    """The same ops on the card: FAST maps equal, keypoints equal, bits
    under BIT_FRAC (AKAZE: 95% of keypoints)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    imgs = _t(_corridor().reshape(4, H, W).astype(np.float32) / 255.0)
    base = torch.round(imgs * 255.0)
    assert torch.equal(torb.fast_score_map(base.cuda(), 20).cpu(),
                       torb.fast_score_map(base, 20))
    kw = dict(k=256, n_levels=2, border=16, detector=detector,
              descriptor=descriptor)
    cpu = torb.orb_frontend_batch(imgs, **kw)
    card = torb.orb_frontend_batch(imgs.cuda(), **kw)
    _assert_keypoints_match(type(cpu)(*(a.cpu() for a in card)), cpu,
                            overlap=0.95 if detector == "akaze" else 0.99)
