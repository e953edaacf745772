"""Port parity: the matcher. The port's plain mutual-NN matcher (the plain
version of the CUDA kernel) against the JAX package's Pallas kernel in
interpret mode and its XLA matcher, at the per-frame shapes (K=512, D=256),
fp32 and bf16, with invalid slots and exact ties. The `gpu` test holds the
CUDA kernel against the plain version on the card."""
import numpy as np
import pytest
import torch

from spsvo_tpu_torch.ops import matching as tmatch
from spsvo_tpu_torch.ops.matching_cuda import match_nn_batched, match_nn_plain


def _descs(rng, n, d=256):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(rng, k=512):
    d0 = _descs(rng, k)
    d1 = _descs(rng, k)
    d1[200:240] = d0[100:140] + 0.05 * rng.normal(size=(40, 256))
    d1[300:310] = d1[200:210]            # duplicated targets: exact row ties
    d0[400:405] = d0[100:105]            # duplicated queries: column ties
    v0 = rng.random(k) > 0.2
    v1 = rng.random(k) > 0.2
    return d0, v0, d1, v1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matcher_matches_jax(rng, dtype):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import matching as jmatch
    from spsvo_tpu.ops.matching_pallas import match_nn_pallas

    d0, v0, d1, v1 = _case(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jd0, jd1 = jnp.asarray(d0).astype(jdt), jnp.asarray(d1).astype(jdt)
    ref = jmatch.match_nn(jmatch.l2_distance_sq(jd0, jd1), jnp.asarray(v0),
                          jnp.asarray(v1), cross_check=True)
    pal_idx, pal_d = match_nn_pallas(jd0, jnp.asarray(v0), jd1,
                                     jnp.asarray(v1), interpret=True)
    jax.block_until_ready(pal_idx)
    got = tmatch.match_nn(
        tmatch.l2_distance_sq(torch.as_tensor(d0).to(tdt),
                              torch.as_tensor(d1).to(tdt)),
        torch.as_tensor(v0), torch.as_tensor(v1), cross_check=True)
    idx = got.idx.numpy()
    assert (idx >= 0).sum() > 100
    np.testing.assert_array_equal(idx, np.asarray(ref.idx))
    np.testing.assert_array_equal(idx, np.asarray(pal_idx))
    matched = idx >= 0
    # fp32 distances of the same values, summed in another order
    np.testing.assert_allclose(got.dist2.numpy()[matched],
                               np.asarray(ref.dist2)[matched], atol=1e-5)
    np.testing.assert_allclose(got.dist2.numpy()[matched],
                               np.asarray(pal_d)[matched], atol=1e-5)


def test_ratio_test_matches_jax(rng):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from spsvo_tpu.ops import matching as jmatch
    d0, v0, d1, v1 = _case(rng)
    ref = jmatch.match_descriptors(jnp.asarray(d0), jnp.asarray(v0),
                                   jnp.asarray(d1), jnp.asarray(v1),
                                   use_ratio_test=True)
    got = tmatch.match_descriptors(torch.as_tensor(d0), torch.as_tensor(v0),
                                   torch.as_tensor(d1), torch.as_tensor(v1),
                                   use_ratio_test=True)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


def test_batched_wrapper_on_cpu_is_the_plain_version(rng):
    d0, v0, d1, v1 = _case(rng)
    q = torch.as_tensor(d0)
    desc1 = torch.stack([torch.as_tensor(d1), torch.as_tensor(d0[::-1].copy())])
    valid1 = torch.stack([torch.as_tensor(v1), torch.as_tensor(v0[::-1].copy())])
    idx, dist2 = match_nn_batched(q[None].expand(2, *q.shape),
                                  torch.as_tensor(v0)[None].expand(2, 512),
                                  desc1, valid1)
    for b in range(2):
        ref = tmatch.match_nn(tmatch.l2_distance_sq(q, desc1[b]),
                              torch.as_tensor(v0), valid1[b])
        assert torch.equal(idx[b], ref.idx)
        assert torch.equal(dist2[b], ref.dist2)
    idx_all_invalid, _ = match_nn_plain(
        q[None], torch.zeros((1, 512), dtype=torch.bool), desc1[:1],
        valid1[:1])
    assert (idx_all_invalid == -1).all()


def _cuda_args(rng, dev, dtype, shape):
    """(desc0, valid0, desc1, valid1) on the card. "B2": the per-frame
    layout (one query broadcast against two targets); "B63": the online
    hybrid's 2N-1 pairs for N=32, each with its own query; "ragged":
    K0=500 against K1=300. All with invalid slots and exact ties."""
    if shape == "B2":
        d0, v0, d1, v1 = _case(rng)
        desc0 = torch.as_tensor(d0, device=dev).to(dtype)
        valid0 = torch.as_tensor(v0, device=dev)
        desc1 = torch.as_tensor(d1, device=dev).to(dtype)
        return (desc0[None].expand(2, *desc0.shape),
                valid0[None].expand(2, 512),
                torch.stack([desc1, desc0.flip(0)]),
                torch.stack([torch.as_tensor(v1, device=dev), valid0.flip(0)]))
    B, K0, K1 = (63, 512, 512) if shape == "B63" else (2, 500, 300)
    d0 = np.stack([_descs(rng, K0) for _ in range(B)])
    d1 = np.stack([_descs(rng, K1) for _ in range(B)])
    d1[:, 200:240] = d0[:, 100:140] + 0.05 * rng.normal(size=(B, 40, 256))
    d1[:, 250:260] = d1[:, 200:210]      # duplicated targets: exact row ties
    d0[:, 400:405] = d0[:, 100:105]      # duplicated queries: column ties
    return (torch.as_tensor(d0, device=dev).to(dtype),
            torch.as_tensor(rng.random((B, K0)) > 0.2, device=dev),
            torch.as_tensor(d1, device=dev).to(dtype),
            torch.as_tensor(rng.random((B, K1)) > 0.2, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["B2", "B63", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(rng, dtype, shape):
    """bf16 runs the tensor-core kernel, fp32 the SIMT kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args = _cuda_args(rng, dev, dtype, shape)
    idx_k, dist_k = match_nn_batched(*args)
    idx_p, dist_p = match_nn_plain(*args)
    torch.cuda.synchronize()
    # exact ties resolve to the lowest index in both; distances are fp32
    # sums in another order
    assert (idx_p >= 0).sum().item() > 50 * args[0].shape[0]
    assert (idx_k != idx_p).sum().item() <= 2
    torch.testing.assert_close(dist_k, dist_p, atol=1e-4, rtol=0)
    # the bf16 kernel leaves its scratch as it found it: a second call on
    # the same inputs gives the same answer
    idx_2, dist_2 = match_nn_batched(*args)
    assert torch.equal(idx_2, idx_k) and torch.equal(dist_2, dist_k)
