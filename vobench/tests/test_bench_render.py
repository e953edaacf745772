"""The card's corridor renderer against the numpy original at a small
size: the same blurs, and the same geometry for the same textures."""

import numpy as np
import torch

from spsvo_tpu_torch.eval import synthetic
from vobench import render


def test_blurs_match():
    rng = np.random.default_rng(0)
    x = rng.random((40, 60)).astype(np.float32)
    np.testing.assert_array_equal(
        render.blur_f32(torch.as_tensor(x), 6.0).numpy(),
        synthetic._blur_f32(x, 6.0))
    u = (rng.random((40, 60)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        render.blur_u8(torch.as_tensor(u), 1.0).numpy(),
        synthetic._blur_u8(u, 1.0))


def test_geometry_matches(monkeypatch):
    gen = torch.Generator().manual_seed(1)
    tex = [render.blob_texture(gen, 128, 6.0) for _ in range(3)]
    assert set(np.unique(tex[0].numpy())) >= {30.0, 230.0}
    given = iter([t.numpy() for t in tex])
    monkeypatch.setattr(synthetic, "blob_texture", lambda *a, **k: next(given))
    twists = render.s_curve(4, 0.35, 0.003)
    frames, poses, P_l, P_r = synthetic.synthetic_corridor(
        np.random.default_rng(0), n_frames=4, h=60, w=200, twists=twists,
        tex_px=128)
    scene = render.Corridor(tex, 60, 200)
    mine = scene.drive(render.trajectory(twists)).numpy().astype(int)
    theirs = np.stack([[l_, r_] for l_, r_ in frames]).astype(int)
    np.testing.assert_allclose(np.stack(render.trajectory(twists)),
                               np.stack(poses), atol=1e-12)
    np.testing.assert_array_equal(scene.P_l, P_l)
    np.testing.assert_array_equal(scene.P_r, P_r)
    # both truncate float64 texels to uint8: flat texels at exactly 30 or
    # 230 land on either side of the integer as the last bit falls
    diff = np.abs(mine - theirs)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.03
