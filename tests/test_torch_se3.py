"""The se3 helpers of `spsvo_tpu_torch.geometry.se3` against the JAX
package's on the same numpy inputs (CPU): batched rotations including the
identity, a half turn and angles below the sinc branch's 1e-8, quaternions
of both signs. Tolerance 1e-6 (fp32 rounding in another op order)."""
import numpy as np
import pytest
import torch

from spsvo_tpu_torch.geometry import se3 as tse3

ATOL = 1e-6


def _inputs(rng):
    """Rodrigues vectors (..., 3): random, tiny, zero, a half turn, with a
    leading batch of (2, 8); quaternions of both signs; transforms and
    points."""
    rvec = rng.normal(size=(2, 8, 3)).astype(np.float32)
    rvec[0, 0] = 0.0
    rvec[0, 1] = [3e-9, -1e-9, 2e-9]
    rvec[0, 2] = [np.pi, 0.0, 0.0]
    rvec[0, 3] *= 1e-4
    q = rng.normal(size=(2, 8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[1, :4] *= -1.0                       # w < 0: the short rotation flips
    T = np.tile(np.eye(4, dtype=np.float32), (2, 8, 1, 1))
    from scipy.spatial.transform import Rotation
    T[..., :3, :3] = Rotation.from_rotvec(
        rvec.reshape(-1, 3)).as_matrix().reshape(2, 8, 3, 3)
    T[..., :3, 3] = rng.normal(size=(2, 8, 3))
    pts = rng.normal(size=(2, 8, 5, 3)).astype(np.float32)
    return rvec, q, T, pts


CASES = {
    "quat_conjugate": lambda rvec, q, T, pts: (q,),
    "axis_angle_to_quat": lambda rvec, q, T, pts: (rvec,),
    "quat_to_axis_angle": lambda rvec, q, T, pts: (q,),
    "axis_angle_to_matrix": lambda rvec, q, T, pts: (rvec,),
    "matrix_to_axis_angle": lambda rvec, q, T, pts: (T[..., :3, :3],),
    "so3_exp": lambda rvec, q, T, pts: (rvec,),
    "hat": lambda rvec, q, T, pts: (rvec,),
    "transform_points": lambda rvec, q, T, pts: (T, pts),
    "rotate_points": lambda rvec, q, T, pts: (q, pts),
}


@pytest.mark.parametrize("name", list(CASES))
def test_se3_helper_matches_jax(rng, name):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.geometry import se3 as jse3
    args = CASES[name](*_inputs(rng))
    ref = np.asarray(getattr(jse3, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(tse3, name)(*(torch.as_tensor(a) for a in args))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=1e-6)
