"""Port parity: config, presets, SE(3) and image ops of `spsvo_tpu_torch`
against `spsvo_tpu` on the same numpy inputs (CPU)."""
import dataclasses
import enum

import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from spsvo_tpu import config as jcfg, presets as jpresets  # noqa: E402
from spsvo_tpu.geometry import se3 as jse3  # noqa: E402
from spsvo_tpu.ops import image as jimage  # noqa: E402
from spsvo_tpu_torch import config as tcfg, presets as tpresets  # noqa: E402
from spsvo_tpu_torch.geometry import se3 as tse3  # noqa: E402
from spsvo_tpu_torch.ops import image as timage  # noqa: E402

ATOL = 1e-6


def _plain(v):
    return v.value if isinstance(v, enum.Enum) else v


def _cfg_dict(cfg):
    return {f.name: _plain(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def test_voconfig_fields_and_defaults_match():
    jf = dataclasses.fields(jcfg.VOConfig)
    tf = dataclasses.fields(tcfg.VOConfig)
    assert [f.name for f in jf] == [f.name for f in tf]
    assert _cfg_dict(jcfg.VOConfig()) == _cfg_dict(tcfg.VOConfig())
    for name in ("DetectorType", "DescriptorType", "MatcherType",
                 "SelectorType", "Precision", "ImagePosition", "MatchType"):
        j, t = getattr(jcfg, name), getattr(tcfg, name)
        assert [(m.name, m.value) for m in j] == [(m.name, m.value) for m in t]
    cfg_j, cfg_t = jcfg.VOConfig(), tcfg.VOConfig()
    for prop in ("cell", "grid_height", "grid_width", "config_string"):
        assert getattr(cfg_j, prop) == getattr(cfg_t, prop)


@pytest.mark.parametrize("kwargs", [
    dict(image_height=121), dict(image_width=390), dict(model_batch_size=3),
    dict(device_classic=True), dict(refinement_degree=5),
    dict(is_classic=True, device_classic=True,
         descriptor_type="SuperPoint"),
    dict(is_classic=True, image_height=121),
])
def test_voconfig_validation_matches(kwargs):
    def build(mod):
        kw = dict(kwargs)
        if "descriptor_type" in kw:
            kw["descriptor_type"] = mod.DescriptorType(kw["descriptor_type"])
        try:
            mod.VOConfig(**kw)
        except ValueError as e:
            return str(e)
        return None
    assert build(jcfg) == build(tcfg)


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_match(name):
    assert _cfg_dict(jpresets.PRESETS[name]()) == _cfg_dict(
        tpresets.PRESETS[name]())


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def test_quat_to_matrix_and_multiply(rng):
    q = _quats(rng, 64) * rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
    np.testing.assert_allclose(tse3.quat_to_matrix(_t(q)).numpy(),
                               np.asarray(jse3.quat_to_matrix(jnp.asarray(q))),
                               atol=ATOL)
    q2 = _quats(rng, 64)
    np.testing.assert_allclose(
        tse3.quat_multiply(_t(q), _t(q2)).numpy(),
        np.asarray(jse3.quat_multiply(jnp.asarray(q), jnp.asarray(q2))),
        atol=1e-5)


def test_matrix_to_quat_all_branches(rng):
    q = _quats(rng, 128)
    # rotations near 180 degrees about each axis exercise every Shepperd branch
    q[:4] = np.array([[1, 0, 0, 0.01], [0, 1, 0, 0.01], [0, 0, 1, 0.01],
                      [0, 0, 0, 1]], np.float32)
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(tse3.matrix_to_quat(_t(R)).numpy(),
                               np.asarray(jse3.matrix_to_quat(jnp.asarray(R))),
                               atol=ATOL)


@pytest.mark.parametrize("scale", [1e-8, 1e-3, 0.3])
def test_quat_boxplus(rng, scale):
    q = _quats(rng, 32)
    d = (rng.normal(size=(32, 3)) * scale).astype(np.float32)
    np.testing.assert_allclose(
        tse3.quat_boxplus(_t(q), _t(d)).numpy(),
        np.asarray(jse3.quat_boxplus(jnp.asarray(q), jnp.asarray(d))),
        atol=ATOL)


def test_make_and_invert_transform(rng):
    q = _quats(rng, 16)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    Tj = jse3.make_transform(jnp.asarray(q), jnp.asarray(t))
    Tt = tse3.make_transform(_t(q), _t(t))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=ATOL)
    np.testing.assert_allclose(tse3.invert_transform(Tt).numpy(),
                               np.asarray(jse3.invert_transform(Tj)),
                               atol=1e-5)


@pytest.mark.parametrize("src,dst", [((375, 1242), (120, 392)),
                                     ((376, 1241), (96, 320)),
                                     ((200, 300), (120, 392)),
                                     ((120, 392), (120, 392))])
def test_crop_geometry_and_projection(src, dst):
    assert timage.crop_geometry(*src, *dst) == jimage.crop_geometry(*src, *dst)
    P = np.array([[718.856, 0, 607.1928, 45.0], [0, 718.856, 185.2157, -2.0],
                  [0, 0, 1.0, 0.1]], np.float32)
    np.testing.assert_allclose(
        timage.update_projection_matrix(_t(P), *src, *dst).numpy(),
        np.asarray(jimage.update_projection_matrix(jnp.asarray(P), *src,
                                                   *dst)), atol=1e-4)
    np.testing.assert_allclose(
        timage.update_projection_matrix_np(P, *src, *dst),
        jimage.update_projection_matrix_np(P, *src, *dst))


def test_preprocess_stereo_pair_uint8(rng):
    img_l = rng.integers(0, 256, (187, 621), dtype=np.uint8)
    img_r = rng.integers(0, 256, (187, 621), dtype=np.uint8)
    P = np.array([[718.856, 0, 607.1928, 0], [0, 718.856, 185.2157, 0],
                  [0, 0, 1.0, 0]], np.float32)
    Pr = P.copy()
    Pr[0, 3] = -386.1448
    ij, plj, prj = jimage.preprocess_stereo_pair(
        jnp.asarray(img_l), jnp.asarray(img_r), jnp.asarray(P),
        jnp.asarray(Pr), dst_h=96, dst_w=320)
    it, plt, prt = timage.preprocess_stereo_pair(
        torch.as_tensor(img_l), torch.as_tensor(img_r), _t(P), _t(Pr),
        dst_h=96, dst_w=320)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), atol=ATOL)
    np.testing.assert_allclose(plt.numpy(), np.asarray(plj), atol=1e-4)
    np.testing.assert_allclose(prt.numpy(), np.asarray(prj), atol=1e-4)
    # the numpy twin takes the same bilinear taps as the device path
    np.testing.assert_allclose(timage.preprocess_image_np(img_l, 96, 320),
                               np.asarray(ij[0]), atol=ATOL)


def test_bilinear_resize_float(rng):
    img = rng.random((3, 50, 71)).astype(np.float32)
    np.testing.assert_allclose(
        timage.bilinear_resize(_t(img), 37, 90).numpy(),
        np.asarray(jimage.bilinear_resize(jnp.asarray(img), 37, 90)),
        atol=ATOL)
