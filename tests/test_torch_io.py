"""The port's I/O against OpenCV and the JAX package (CPU): the PNG codec
against cv2 on files with every row filter, the KITTI text formats byte for
byte, the frame loader, and the numpy scene renderers against the cv2
ones."""
import os
import struct
import zlib

import numpy as np
import pytest

from spsvo_tpu_torch.eval import synthetic as tsyn
from spsvo_tpu_torch.io import kitti as tkitti, loader as tloader, png

cv2 = pytest.importorskip("cv2")


def _image(rng, h=75, w=131):
    """Smooth structure plus noise, so adaptive filtering has a choice."""
    img = cv2.GaussianBlur((rng.random((h, w)) * 255).astype(np.uint8),
                           (0, 0), 2.0).astype(np.int32)
    img[::7] += rng.integers(-20, 20, w)
    return np.clip(img, 0, 255).astype(np.uint8)


def _filtered_png(img, filters):
    """A PNG of `img` whose row r uses filter `filters[r]`, built with the
    forward filters of the PNG specification (bytes per pixel = 1)."""
    x = img.astype(np.int32)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]              # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]                 # up
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]            # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = [np.zeros_like(x), a, b, (a + b) // 2, paeth]
    rows = np.stack([(x[r] - pred[f][r]) & 255 for r, f in enumerate(filters)])
    raw = np.concatenate([np.asarray(filters, np.uint8)[:, None],
                          rows.astype(np.uint8)], axis=1).tobytes()

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))
    comp = zlib.compress(raw)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1],
                                         img.shape[0], 8, 0, 0, 0, 0))
            + chunk(b"IDAT", comp[:100]) + chunk(b"IDAT", comp[100:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth",
                                     "sub_up", "mixed"])
def test_png_decoder_every_row_filter_equals_cv2(rng, tmp_path, filters):
    """Each filter alone, None/Sub/Up mixed (the whole-row path) and all
    five mixed (the anti-diagonal path), split over two IDAT chunks: the
    decoder returns the image and so does cv2.imread."""
    img = _image(rng)
    h = img.shape[0]
    kinds = {"none": [0], "sub": [1], "up": [2], "average": [3],
             "paeth": [4], "sub_up": [0, 1, 2], "mixed": [0, 1, 2, 3, 4]}
    ft = rng.choice(kinds[filters], h)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_filtered_png(img, ft))
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)
    out = png.read_gray8(path)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("strategy", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("level", [None, 6])
def test_png_decoder_equals_cv2_on_files_cv2_wrote(rng, tmp_path, strategy,
                                                   level):
    """cv2.imwrite with each zlib strategy, at its default (Sub rows) and at
    compression level 6 (adaptive filtering)."""
    img = _image(rng, 90, 200)
    path = str(tmp_path / "c.png")
    params = [cv2.IMWRITE_PNG_STRATEGY, strategy]
    if level is not None:
        params += [cv2.IMWRITE_PNG_COMPRESSION, level]
    assert cv2.imwrite(path, img, params)
    np.testing.assert_array_equal(png.read_gray8(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_writer_round_trip_and_rejections(rng, tmp_path):
    img = _image(rng, 64, 97)
    path = str(tmp_path / "w.png")
    png.write_gray8(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_gray8(path), img)
    colour = str(tmp_path / "rgb.png")
    cv2.imwrite(colour, np.dstack([img] * 3))
    with pytest.raises(ValueError, match="colour type 2, bit depth 8"):
        png.read_gray8(colour)
    deep = str(tmp_path / "g16.png")
    cv2.imwrite(deep, img.astype(np.uint16) * 256)
    with pytest.raises(ValueError, match="colour type 0, bit depth 16"):
        png.read_gray8(deep)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_gray8(b"JFIF" * 10)
    with pytest.raises(ValueError, match="2-D uint8"):
        png.encode_gray8(img.astype(np.float32))


def _poses(rng, n):
    out, T = [], np.eye(4)
    for _ in range(n):
        d = np.eye(4)
        d[:3, :3] = tsyn._rotvec_to_matrix(rng.normal(size=3) * 0.02)
        d[:3, 3] = rng.normal(size=3) * 0.1 + [0, 0, 1.0]
        T = T @ d
        out.append(T.copy())
    return out


def test_kitti_text_formats_equal_the_jax_package(rng, tmp_path):
    """Pose files byte for byte, poses read back, calib parsing (both key
    styles), result file names and the three eval tables."""
    from spsvo_tpu.io import kitti as jkitti
    poses = _poses(rng, 12)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "sub" / "b.txt")
    jkitti.write_kitti_poses(a, poses)
    tkitti.write_kitti_poses(b, poses)
    assert open(a, "rb").read() == open(b, "rb").read()
    for Tt, Tj in zip(tkitti.read_kitti_poses(a), jkitti.read_kitti_poses(a)):
        np.testing.assert_array_equal(Tt, Tj)
    for keys in (("P0", "P1"), ("P_rect_00", "P_rect_01")):
        calib = str(tmp_path / f"calib_{keys[0]}.txt")
        with open(calib, "w") as f:
            f.write("calib_time: 09-Jan-2012\n")
            for k in keys + ("P2",):
                f.write(k + ": " + " ".join(f"{v:.12e}" for v in
                                            rng.normal(size=12)) + "\n")
        for Pt, Pj in zip(tkitti.read_calib(calib), jkitti.read_calib(calib)):
            np.testing.assert_array_equal(Pt, Pj)
    with open(str(tmp_path / "empty.txt"), "w") as f:
        f.write("Tr: 1 2 3\n")
    with pytest.raises(ValueError, match="no gray-camera projections"):
        tkitti.read_calib(str(tmp_path / "empty.txt"))
    for i in (0, 5, 10, 13):
        assert tkitti.result_filename(i) == jkitti.result_filename(i)
    assert tkitti.KITTI_EVAL_DRIVES == jkitti.KITTI_EVAL_DRIVES
    assert tkitti.KITTI_EVAL_START_FRAME == jkitti.KITTI_EVAL_START_FRAME
    assert tkitti.KITTI_EVAL_END_FRAME == jkitti.KITTI_EVAL_END_FRAME


def _tree(root, rng, n=5, h=60, w=200):
    seq = os.path.join(root, "sequences", "00")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, cam))
    frames = []
    for i in range(n):
        il, ir = _image(rng, h, w), _image(rng, h, w)
        cv2.imwrite(os.path.join(seq, "image_0", f"{i:06d}.png"), il)
        png.write_gray8(os.path.join(seq, "image_1", f"{i:06d}.png"), ir)
        frames.append((il, ir))
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for k, bx in (("P0", 0.0), ("P1", -386.1448)):
            f.write(f"{k}: 718.856 0 607.1928 {bx} 0 718.856 185.2157 0 "
                    "0 0 1 0\n")
    return frames


def test_kitti_sequence_reader_and_loader(rng, tmp_path):
    """`KittiOdometrySequence` yields what the JAX package's (cv2) reader
    yields, start/end included; `make_loader` (here the native loader)
    yields (idx, (2, H, W)) in order, within one grey level of the JAX
    package's Python loader (that one resizes in uint8 with cv2, which
    rounds; the port's Python loader keeps the float taps of its device
    preprocessing); both of the port's loaders hand a decode error to the
    consumer and stop early on `close()`."""
    from spsvo_tpu.io import kitti as jkitti, loader as jloader
    root = str(tmp_path)
    frames = _tree(root, rng)
    tseq = tkitti.KittiOdometrySequence(root, "00", start=1, end=4)
    jseq = jkitti.KittiOdometrySequence(root, "00", start=1, end=4)
    assert len(tseq) == len(jseq) == 3 and tseq.files == jseq.files
    np.testing.assert_array_equal(tseq.P_r, jseq.P_r)
    for (tl, tr), (jl, jr), (il, ir) in zip(tseq, jseq, frames[1:4]):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tl, il)
    with pytest.raises(FileNotFoundError):
        tkitti.KittiOdometrySequence(root, "07")
    full = tkitti.KittiOdometrySequence(root, "00")
    lp = [os.path.join(full.left_dir, f) for f in full.files]
    rp = [os.path.join(full.right_dir, f) for f in full.files]
    for normalize, make in ((True, tloader.make_loader),
                            (False, tloader.make_loader),
                            (True, tloader.PythonStereoLoader),
                            (False, tloader.PythonStereoLoader)):
        got = list(make(lp, rp, 32, 96, queue_capacity=2,
                        normalize=normalize))
        ref = list(jloader.PythonStereoLoader(lp, rp, 32, 96,
                                              normalize=normalize))
        assert [i for i, _ in got] == list(range(5))
        for (_, a), (_, b) in zip(got, ref):
            assert a.shape == (2, 32, 96) and a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1.01 / 255 if normalize
                                       else 1.01)
    # here g++ and OpenCV build the native loader
    assert isinstance(tloader.make_loader(lp, rp, 32, 96),
                      tloader.NativeStereoLoader)
    with open(lp[2], "wb") as f:
        f.write(b"not a png")
    for make in (tloader.make_loader, tloader.PythonStereoLoader):
        ld = make(lp, rp, 32, 96)
        with pytest.raises(ValueError, match="not a PNG"):
            list(ld)
        ld.close()
        early = make(lp[:2] * 20, rp[:2] * 20, 32, 96, queue_capacity=1)
        next(iter(early))
        early.close()
    assert not early._thread.is_alive()


def test_synthetic_drive_copy_within_two_grey_levels():
    """The numpy homography warp against cv2.warpPerspective: the same
    poses, and images within 2 grey levels on >= 99.9% of the pixels, over
    a yawing drive (cv2 interpolates in fixed point)."""
    from spsvo_tpu.eval import synthetic as jsyn
    kw = dict(n_frames=3, h=120, w=392, depth=12.0, yaw_rate=0.004)
    fj, pj, plj, prj = jsyn.synthetic_drive(np.random.default_rng(1), **kw)
    ft, pt, plt, prt = tsyn.synthetic_drive(np.random.default_rng(1), **kw)
    np.testing.assert_array_equal(plt, plj)
    np.testing.assert_array_equal(prt, prj)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    for pair_t, pair_j in zip(ft, fj):
        for a, b in zip(pair_t, pair_j):
            assert a.dtype == np.uint8 and a.shape == (120, 392)
            d = np.abs(a.astype(int) - b.astype(int))
            assert (d <= 2).mean() >= 0.999, (d > 2).mean()
    with pytest.warns(RuntimeWarning, match="geometry degenerates"):
        tsyn.synthetic_drive(np.random.default_rng(1), n_frames=3, h=24,
                             w=64, depth=0.5)


def test_synthetic_blocks_copy_equals_original():
    """Same seed -> the same poses and the same images up to the texture
    blur (see the corridor test in tests/test_torch_pipeline.py)."""
    from spsvo_tpu.eval import synthetic as jsyn
    kw = dict(n_frames=2, h=60, w=200, tex_px=512)
    fj, pj, _, _ = jsyn.synthetic_blocks(np.random.default_rng(2), **kw)
    ft, pt, _, _ = tsyn.synthetic_blocks(np.random.default_rng(2), **kw)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    for pair_t, pair_j in zip(ft, fj):
        for a, b in zip(pair_t, pair_j):
            d = np.abs(a.astype(int) - b.astype(int))
            assert (d > 0).mean() <= 0.01 and d.max() <= 64


@pytest.mark.parametrize("normalize", [True, False])
def test_native_loader_matches_jax(rng, tmp_path, monkeypatch, normalize):
    """The port's own copy of the native loader (built into
    `.kernel_cache/`) yields the JAX package's native loader's frames (that
    one built in a directory of this test), bit for bit and in order, over
    more frames than its ring holds, with several workers."""
    from spsvo_tpu.io import loader as jloader
    monkeypatch.setenv("SPSVO_NATIVE_DIR", str(tmp_path / "jax_native"))
    _tree(str(tmp_path), rng, n=12, h=70, w=230)
    full = tkitti.KittiOdometrySequence(str(tmp_path), "00")
    lp = [os.path.join(full.left_dir, f) for f in full.files]
    rp = [os.path.join(full.right_dir, f) for f in full.files]
    kw = dict(queue_capacity=3, num_threads=3, normalize=normalize)
    got = list(tloader.NativeStereoLoader(lp, rp, 48, 160, **kw))
    ref = list(jloader.NativeStereoLoader(lp, rp, 48, 160, **kw))
    assert [i for i, _ in got] == [i for i, _ in ref] == list(range(12))
    for (_, a), (_, b) in zip(got, ref):
        assert a.shape == (2, 48, 160) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    from spsvo_tpu_torch import _build
    assert os.path.dirname(tloader._build_native()) == _build.CACHE


def test_make_loader_falls_back_where_the_library_does_not_load(
        rng, tmp_path, monkeypatch):
    """A native library that does not load (in this test: not a library;
    elsewhere: built against an OpenCV the machine lacks, or no OpenCV to
    build against) makes `make_loader` warn and return the Python loader."""
    _tree(str(tmp_path), rng, n=2)
    full = tkitti.KittiOdometrySequence(str(tmp_path), "00")
    lp = [os.path.join(full.left_dir, f) for f in full.files]
    rp = [os.path.join(full.right_dir, f) for f in full.files]
    bad = tmp_path / "libbroken.so"
    bad.write_bytes(b"not a shared library")
    monkeypatch.setattr(tloader, "_build_native", lambda: str(bad))
    tloader._native_lib.cache_clear()
    try:
        with pytest.warns(UserWarning, match="native loader unavailable"):
            ld = tloader.make_loader(lp, rp, 32, 96)
        assert isinstance(ld, tloader.PythonStereoLoader)
        assert [i for i, _ in ld] == [0, 1]
        with pytest.raises(RuntimeError, match="unavailable"):
            tloader.NativeStereoLoader(lp, rp, 32, 96)
    finally:
        tloader._native_lib.cache_clear()
