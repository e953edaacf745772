"""Dense distillation: the port's `spsvo_tpu_torch.distill` against the JAX
package's `spsvo_tpu.distill` on the same numpy inputs, with JAX's random
draws injected (CPU). The teacher is the committed `superpoint_pretrained`
(the JAX default, `sp_mbv1`, is an ONNX file the repository does not hold);
the student a freshly initialised `sp_resnet18`.

Tolerances, and why:
- augmented batches: within 1e-5 but for under 0.1% of the values (the
  homography warp's border pixels, tests/test_torch_homography.py);
- distillation losses: 1e-6 relative (float32 softmax and reductions in
  another order);
- one EMA distillation step: the loss to 1e-6 relative; the parameters
  within 1e-6 where JAX's |g| >= 1e-5 and the packages' gradients agree to
  |g| / 10, within 2 lr elsewhere (Adam's first step is lr times the sign
  of g; see tests/test_torch_training.py), at most 1e-3 of the |g| >= 1e-5
  elements outside; the EMA equal to 0.9 * start + 0.1 * params;
- cosine learning rates: within 2e-7 of the initial rate of optax's
  float32 values at every step (XLA's float32 cosine and its fused program
  round differently; measured 1.75e-7, under 2 ulp of the initial rate);
- keypoint agreement: equal on the same trunk outputs; with each
  package's own trunk, counts within one per frame and precision / recall
  within 0.02 (a keypoint at the confidence threshold flips);
- INTER_AREA shrinking: within 1e-6 of cv2.resize (OpenCV's vectorised sums
  round in another order);
- synthetic training frames: the corridor renders equal, the plane drive's
  within two grey levels (tests/test_torch_io.py).
Adds ~35 s (one process, one torch thread).
"""
import functools
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from spsvo_tpu import distill as jd  # noqa: E402
from spsvo_tpu.models import zoo as jzoo  # noqa: E402
from spsvo_tpu.models.onnx_import import make_apply  # noqa: E402
from spsvo_tpu_torch import distill as td  # noqa: E402
from spsvo_tpu_torch import training as tt  # noqa: E402
from spsvo_tpu_torch.io.homography import HomographyDraws  # noqa: E402
from spsvo_tpu_torch.models import zoo as tzoo  # noqa: E402
from spsvo_tpu_torch.models.graph import conv_weight_names  # noqa: E402

H, W, B = 32, 96, 2
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one torch thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_augment_draws(key, n, fh, fw, batch, h, w, clean_prob=0.0):
    """The draws `spsvo_tpu.distill.augment_batch(key, ...)` makes, as the
    port's `AugmentDraws` (CPU tensors)."""
    ks = jax.random.split(key, 8)
    fidx = jax.random.randint(ks[0], (batch,), 0, n)
    y0 = jax.random.randint(ks[1], (batch,), 0, max(fh - h, 0) + 1)
    x0 = jax.random.randint(ks[2], (batch,), 0, max(fw - w, 0) + 1)
    hom = []
    for k in jax.random.split(ks[3], batch):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        hom.append((1.0 + jax.random.uniform(k1, (), minval=-0.3, maxval=0.3),
                    jax.random.uniform(k2, (), minval=-0.25, maxval=0.25),
                    jax.random.uniform(k3, (), minval=-0.1, maxval=0.1) * w,
                    jax.random.uniform(k4, (), minval=-0.1, maxval=0.1) * h,
                    jax.random.uniform(k5, (2,), minval=-0.001,
                                       maxval=0.001)))
    bc = jax.random.uniform(ks[4], (batch, 1, 1, 1), minval=0.6, maxval=1.4)
    br = jax.random.uniform(ks[5], (batch, 1, 1, 1), minval=-0.15,
                            maxval=0.15)
    noise = jax.random.normal(ks[6], (batch, h, w, 1))
    clean = (jax.random.bernoulli(ks[7], clean_prob, (batch, 1, 1, 1))
             if clean_prob > 0.0 else jnp.zeros((batch, 1, 1, 1), bool))

    def t(v):
        return torch.from_numpy(np.array(v))

    return td.AugmentDraws(
        t(fidx).long(), t(y0).long(), t(x0).long(),
        HomographyDraws(*[t(np.stack([np.asarray(d[i]) for d in hom]))
                          for i in range(5)]),
        t(bc).reshape(-1), t(br).reshape(-1), t(noise), t(clean).reshape(-1))


@functools.lru_cache(maxsize=None)
def _frames():
    return np.random.default_rng(5).random((5, 64, 160)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_augment(batch, h, w, clean_prob):
    return jax.jit(lambda k, f: jd.augment_batch(k, f, batch, h, w,
                                                 clean_prob=clean_prob))


def assert_warp_close(ours, ref):
    err = np.abs(np.asarray(ours) - np.asarray(ref))
    assert (err > 1e-5).mean() < 1e-3, (err.max(), (err > 1e-5).mean())


@pytest.mark.parametrize("clean_prob", [0.0, 0.5])
def test_augment_batch_matches_jax(clean_prob):
    frames = _frames()
    key = jax.random.PRNGKey(3)
    ref = _jax_augment(6, H, W, clean_prob)(key, jnp.asarray(frames))
    draws = jax_augment_draws(key, 5, 64, 160, 6, H, W, clean_prob)
    ours = td.augment_batch(torch.from_numpy(frames), 6, H, W, clean_prob,
                            draws=draws)
    assert ours.shape == (6, H, W, 1)
    assert_warp_close(ours, ref)
    if clean_prob:
        assert 0 < int(draws.clean.sum()) < 6
    drawn = td.augment_batch(torch.from_numpy(frames), 6, H, W, clean_prob,
                             generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (6, H, W, 1)
    assert float(drawn.min()) >= 0.0 and float(drawn.max()) <= 1.0


@pytest.mark.parametrize("temperature,sparsity", [(1.0, 0.0), (2.0, 0.0),
                                                  (1.0, 1e-2)])
def test_distill_loss_matches_jax(temperature, sparsity):
    r = np.random.default_rng(1)
    det_t = r.normal(size=(2, 3, 4, 65)).astype(np.float32) * 3
    det_s = det_t + r.normal(size=det_t.shape).astype(np.float32)
    desc_t, desc_s = (r.normal(size=(2, 3, 4, 256)).astype(np.float32)
                      for _ in range(2))
    desc_t /= np.linalg.norm(desc_t, axis=-1, keepdims=True)
    desc_s /= np.linalg.norm(desc_s, axis=-1, keepdims=True)
    hwio = {"b.weight": r.normal(size=(3, 3, 8, 4)).astype(np.float32),
            "a.weight": r.normal(size=(1, 1, 4, 8)).astype(np.float32),
            "a.bias": r.normal(size=(8,)).astype(np.float32)}
    images = np.zeros((2, 24, 32, 1), np.float32)
    ref, aux_j = jd.distill_loss(
        lambda p, x: {"output_det": jnp.asarray(det_s),
                      "output_desc": jnp.asarray(desc_s)},
        {k: jnp.asarray(v) for k, v in sorted(hwio.items())},
        jnp.asarray(det_t), jnp.asarray(desc_t), jnp.asarray(images),
        sparsity, temperature=temperature)
    oihw = tzoo.params_from_jax(hwio, ["a.weight", "b.weight"])
    ours, aux = td.distill_loss(
        lambda p, x: {"output_det": torch.from_numpy(det_s),
                      "output_desc": torch.from_numpy(desc_s)},
        oihw, torch.from_numpy(det_t), torch.from_numpy(desc_t),
        torch.from_numpy(images), sparsity, temperature=temperature)
    assert abs(float(ours) - float(ref)) <= 1e-6 * abs(float(ref))
    for k in ("det_kl", "desc_cos"):
        assert abs(float(aux[k]) - float(aux_j[k])) <= \
            1e-6 * abs(float(aux_j[k])), k


@pytest.mark.parametrize("steps", [20, 3000])
def test_cosine_schedule_matches_optax(steps):
    """Every step, past the end included, eager and under jit (as the JAX
    package's distillation step reads it)."""
    ref = optax.cosine_decay_schedule(1e-3, steps, alpha=0.05)
    ours = tt.cosine_decay_schedule(1e-3, steps, alpha=0.05)
    counts = np.arange(steps + 3, dtype=np.int32)
    got = np.array([ours(int(c)) for c in counts])
    jitted = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(counts)))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=2e-7 * 1e-3)
    for c in (0, 1, steps // 2, steps, steps + 2):
        np.testing.assert_allclose(got[c], float(ref(jnp.int32(c))),
                                   rtol=0, atol=2e-7 * 1e-3)
    assert got[0] == np.float32(1e-3) and got[-1] == got[steps]


@functools.lru_cache(maxsize=None)
def _models():
    """(student graph, student init params (JAX layout), teacher graph,
    teacher params (JAX layout))."""
    s_builder = tzoo._BUILDERS["sp_resnet18"]()
    s_np = s_builder.init_params(torch.Generator().manual_seed(0))
    t_builder = jzoo.build_superpoint_vgg()
    with np.load(f"{jzoo.weights_dir()}/superpoint_pretrained.npz") as d:
        t_np = {k: d[k] for k in d.files}
    return s_builder.build(), s_np, t_builder.build(), t_np


def test_ema_distill_step_matches_jax():
    """One `build_distill_step` step (EMA 0.9, the cosine schedule, clean
    samples, KD temperature 1) from equal parameters and JAX's draws."""
    s_graph, s_np, t_graph, t_np = _models()
    frames = _frames()
    key = jax.random.PRNGKey(7)
    sched = optax.cosine_decay_schedule(LR, 10, alpha=0.05)
    s_fn_j = make_apply(jzoo.build_sp_resnet18().build(), jnp.float32)
    t_fn_j = make_apply(t_graph, jnp.float32)
    s_j = {k: jnp.asarray(v) for k, v in s_np.items()}
    t_j = {k: jnp.asarray(v) for k, v in t_np.items()}
    from spsvo_tpu.training import make_optimizer
    # JAX's gradient of the step below, for the parameter rule
    images_j = jd.augment_batch(key, jnp.asarray(frames), B, H, W,
                                clean_prob=0.5)
    t_out = t_fn_j(t_j, images_j)
    _, g_j = jax.value_and_grad(
        lambda p: jd.distill_loss(s_fn_j, p, t_out["output_det"],
                                  t_out["output_desc"], images_j),
        has_aux=True)(s_j)
    opt_j = make_optimizer(sched, s_j).init(s_j)
    step_j = jd.build_distill_step(s_fn_j, t_fn_j, t_j, jnp.asarray(frames),
                                   B, H, W, sched, ema=0.9, clean_prob=0.5)
    # the step donates its carry: give it copies
    carry_j, aux_j = step_j((jax.tree.map(jnp.copy, s_j), opt_j,
                             jax.tree.map(jnp.copy, s_j)), key)

    student = tzoo.model_from_params(s_graph, s_np, device="cpu")
    teacher = tzoo.model_from_params(t_graph, t_np, device="cpu")
    s_fn, t_fn = tzoo.apply_fn(student), tzoo.apply_fn(teacher)
    p0 = {k: v.clone() for k, v in student.state_dict().items()}
    tx = tt.Adam(tt.cosine_decay_schedule(LR, 10, alpha=0.05))
    step = td.build_distill_step(s_fn, t_fn, dict(teacher.state_dict()),
                                 torch.from_numpy(frames), B, H, W, tx.lr,
                                 ema=0.9, clean_prob=0.5)
    draws = jax_augment_draws(key, 5, 64, 160, B, H, W, clean_prob=0.5)
    (params, opt, ema), aux = step(
        (p0, tx.init(p0), {k: v.clone() for k, v in p0.items()}),
        draws=draws)
    assert abs(float(aux["loss"]) - float(aux_j["loss"])) <= \
        1e-6 * abs(float(aux_j["loss"]))
    assert opt.count == 1
    conv = conv_weight_names(s_graph)
    ref = tzoo.params_from_jax({k: np.asarray(v)
                                for k, v in carry_j[0].items()}, conv)
    g_ref = {k: v for k, v in tzoo.params_from_jax(
        {k: np.asarray(v) for k, v in g_j.items()}, conv).items()
        if k in opt.mu}
    images = td.augment_batch(torch.from_numpy(frames), B, H, W,
                              draws=draws)
    with torch.no_grad():
        t_out_t = t_fn(dict(teacher.state_dict()), images)
    _, g = tt.value_and_grad(
        lambda p: td.distill_loss(s_fn, p, t_out_t["output_det"],
                                  t_out_t["output_desc"], images), p0)
    n_big = n_out = 0
    for k in ref:
        d = (params[k] - ref[k]).abs()
        if k not in g_ref:                       # BN buffers
            assert torch.equal(params[k], p0[k]), k
            continue
        big = g_ref[k].abs() >= 1e-5
        held = big & ((g[k] - g_ref[k]).abs() < g_ref[k].abs() / 10)
        assert float(d.max()) <= 2 * LR * (1 + 1e-3), k
        if held.any():
            assert float(d[held].max()) <= 1e-6, (k, float(d[held].max()))
        n_big += int(big.sum())
        n_out += int((big & ~held & (d > 1e-6)).sum())
        torch.testing.assert_close(ema[k], 0.9 * p0[k] + 0.1 * params[k],
                                   rtol=0, atol=1e-7)
    assert n_out <= 1e-3 * n_big, (n_out, n_big)


def test_keypoint_agreement_matches_jax():
    """Equal when both packages see the same trunk outputs (JAX's, injected:
    the agreement and the postprocess alone); with each package's own
    trunk, a keypoint at the confidence threshold can flip (measured: one
    keypoint of 142 over three frames), so counts within one per frame and
    precision / recall within 0.02."""
    from spsvo_tpu.ops.image import preprocess_image_np
    from spsvo_tpu_torch.eval import synthetic as tsyn
    frames, *_ = tsyn.synthetic_corridor(np.random.default_rng(3),
                                         n_frames=3, h=96, w=320)
    imgs = np.stack([f[0] for f in frames]).astype(np.float32) / 255.0
    _, _, t_graph, t_np = _models()
    with np.load(f"{jzoo.weights_dir()}/sp_resnet18.npz") as d:
        s_np = {k: d[k] for k in d.files}
    s_fn_j = make_apply(jzoo.build_sp_resnet18().build(), jnp.float32)
    t_fn_j = make_apply(t_graph, jnp.float32)
    s_j = {k: jnp.asarray(v) for k, v in s_np.items()}
    t_j = {k: jnp.asarray(v) for k, v in t_np.items()}
    ref = jd.keypoint_agreement(s_fn_j, s_j, t_fn_j, t_j, imgs, 64, 192)

    x = jnp.asarray(np.stack([preprocess_image_np(
        (f * 255).astype(np.uint8), 64, 192) for f in imgs]))[..., None]
    fixed = {name: {k: np.array(v) for k, v in fn(p, x).items()}
             for name, fn, p in (("s", s_fn_j, s_j), ("t", t_fn_j, t_j))}

    def as_jax(name):
        return lambda p, x: {k: jnp.asarray(v)
                             for k, v in fixed[name].items()}

    def as_port(name):
        return lambda p, x: {k: torch.from_numpy(v)
                             for k, v in fixed[name].items()}

    dummy = {"w": torch.zeros(1)}
    ref_fixed = jd.keypoint_agreement(as_jax("s"), s_j, as_jax("t"), t_j,
                                      imgs, 64, 192)
    assert ref_fixed == ref
    assert td.keypoint_agreement(as_port("s"), dummy, as_port("t"), dummy,
                                 imgs, 64, 192) == ref

    s_model = tzoo.load_model("sp_resnet18", device="cpu")
    t_model = tzoo.model_from_params(t_graph, t_np, device="cpu")
    ours = td.keypoint_agreement(
        tzoo.apply_fn(s_model), dict(s_model.state_dict()),
        tzoo.apply_fn(t_model), dict(t_model.state_dict()), imgs, 64, 192)
    assert abs(ours["mean_keypoints"] - ref["mean_keypoints"]) <= 1.0
    for k in ("precision", "recall"):
        assert abs(ours[k] - ref[k]) <= 0.02, (k, ours, ref)
    assert ref["mean_keypoints"] > 20 and ref["precision"] > 0.1


@pytest.mark.parametrize("src,dst", [((375, 1242), (64, 160)),
                                     ((100, 130), (50, 65)),
                                     ((90, 121), (37, 50)),
                                     ((40, 60), (40, 33))])
def test_resize_area_matches_cv2(rng, src, dst):
    import cv2
    img = rng.random(src).astype(np.float32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    ours = td.resize_area(img, *dst)
    assert ours.shape == dst and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shrinks only"):
        td.resize_area(img, src[0] + 1, src[1])


def test_load_sample_frames(tmp_path, rng):
    from spsvo_tpu_torch.io.png import write_gray8
    imgs = (rng.random((3, 20, 30)) * 255).astype(np.uint8)
    for i, im in enumerate(imgs):
        write_gray8(str(tmp_path / f"{i:04d}.png"), im)
    (tmp_path / "notes.txt").write_text("not an image")
    got = td.load_sample_frames(str(tmp_path))
    np.testing.assert_array_equal(got, imgs.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        td.load_sample_frames(str(tmp_path), normalize=False), imgs)
    (tmp_path / "0003.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(ValueError, match="JPEG"):
        td.load_sample_frames(str(tmp_path))


def test_synthetic_training_frames_match_the_jax_renders(tmp_path):
    """The JAX recipe draw for draw (rebuilt here over the JAX package's
    renderers, without its cache under the home directory), and the cache
    read back."""
    from spsvo_tpu.eval import synthetic as jsyn
    kw = dict(seed=3, n_corridor=4, n_drive=4, h=40, w=96)
    ours = td.synthetic_training_frames(cache_dir=str(tmp_path), **kw)
    rng = np.random.default_rng(3)
    ref = []
    frames, _, _, _ = jsyn.synthetic_corridor(
        rng, n_frames=4, h=40, w=96, forward_per_frame=rng.uniform(1.0, 3.0),
        yaw_rate=rng.uniform(-0.02, 0.02), tex_scale=rng.uniform(24.0, 96.0),
        blob_sigma=rng.uniform(4.0, 12.0))
    ref += [f[0] for f in frames]
    frames, _, _, _ = jsyn.synthetic_drive(
        rng, n_frames=4, h=40, w=96, depth=rng.uniform(8.0, 40.0),
        forward_per_frame=0.3, yaw_rate=rng.uniform(-0.01, 0.01))
    ref += [f[0] for f in frames]
    ref = np.stack(ref).astype(np.float32) / 255.0
    assert ours.shape == (8, 40, 96) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[:4], ref[:4])
    assert np.abs(ours[4:] - ref[4:]).max() <= 2 / 255 + 1e-7
    assert len(list(tmp_path.iterdir())) == 1
    np.testing.assert_array_equal(
        td.synthetic_training_frames(cache_dir=str(tmp_path), **kw), ours)


def test_distill_end_to_end_on_the_cpu(monkeypatch):
    """`distill()` with select_best over a few steps, two resolutions and
    synthetic frames of another size (shrunk by `resize_area`): the best
    checkpoint is recorded, every parameter is finite, BN statistics are
    unchanged and the conv weights moved."""
    synth_calls = []

    def fake_synth(seed=0):
        synth_calls.append(seed)
        return np.random.default_rng(seed).random((3, 80, 200)).astype(
            np.float32)

    monkeypatch.setattr(td, "synthetic_training_frames", fake_synth)
    rows = []
    params, hist = td.distill(
        "sp_resnet18", teacher_prefix="superpoint_pretrained", steps=6,
        batch=2, h=32, w=96, holdout=2, log_every=1, clean_prob=0.25,
        resolutions=((32, 96, 2), (48, 64, 1)), frames=_frames(),
        log=rows.append, device="cpu")
    assert synth_calls == [0] and len(hist) == 6 == len(rows)
    assert "best_step" in hist[-1] and hist[-1]["best_score"] >= 0.0
    assert {"precision", "recall", "mean_keypoints"} <= set(hist[0])
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    init = tzoo.init_student("sp_resnet18", 0, device="cpu").state_dict()
    for k, v in params.items():
        if tt._is_buffer(k):
            assert torch.equal(v, init[k]), k
    assert not torch.equal(params["stem.conv.weight"],
                           init["stem.conv.weight"])


def test_distill_default_teacher_needs_its_file():
    if os.path.exists(os.path.join(tzoo.reference_models_dir(),
                                   "sp_mbv1_b1.onnx")):
        pytest.skip("the sp_mbv1 ONNX file is present")
    with pytest.raises(FileNotFoundError, match="sp_mbv1"):
        td.distill("sp_resnet18", frames=_frames(), steps=1, device="cpu")
