// Fused mutual-nearest-neighbour descriptor matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel spsvo_tpu/ops/matching_pallas.py::_match_kernel
// (wrapper match_nn_pallas). Per batch entry b it computes, for query
// descriptors d0 (K0, D) against targets d1 (K1, D):
//   dist = max(|a|^2 + |b|^2 - 2 a.b, 0), masked to 1e30 where either slot
//   is invalid; row argmin and column argmin, lowest index wins ties; the
//   mutual check; idx (-1 = no match) and the row-min dist^2.
// bf16 descriptors are upcast to fp32 after the load (a bf16 x bf16 product
// is exact in fp32), so the numbers are the fp32 distance matrix.
//
// What bounds it on this card: at the per-frame shapes (B=2, K=512, D=256)
// the work is 2 x 512 x 512 x 256 FMAs (~134 MFLOP) and the inputs are
// under 1 MB, so the kernel is bound by latency and launch overhead, not by
// FLOPs or HBM bytes. The design keeps the K0 x K1 distance matrix out of
// device memory entirely (as the TPU kernel kept it in VMEM): one CTA per
// (batch, 32-row query tile) holds its query tile in shared memory, streams
// 32-column target tiles through shared memory in D-chunks of 64, and keeps
// the row min/argmin in registers (columns scanned in increasing order with
// a strict <, so the lowest column wins). The column argmin across CTAs is
// an atomicMin on a packed 64-bit key (float bits of dist << 32 | row):
// dist >= 0 after the clamp, so its bits order like unsigned integers and
// the packed key keeps the lowest-row tie rule. A second small launch does
// the mutual check. Plain FP32 FMAs; wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;        // query rows per CTA, target columns per tile
constexpr int WARPS = 8;        // CTA = 32 x 8 threads
constexpr int RPT = TILE / WARPS;   // query rows per thread
constexpr int DCHUNK = 64;      // target tile depth staged per step
constexpr int MAX_D = 256;
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(TILE * WARPS)
match_rows_kernel(const T* __restrict__ d0, long long d0_bs,
                  const uint8_t* __restrict__ v0, long long v0_bs,
                  const T* __restrict__ d1, long long d1_bs,
                  const uint8_t* __restrict__ v1, long long v1_bs,
                  int K0, int K1, int D, float* __restrict__ rowmin,
                  int* __restrict__ rowarg,
                  unsigned long long* __restrict__ colkey) {
  __shared__ float sA[TILE][MAX_D];
  __shared__ float sB[TILE][DCHUNK + 1];
  __shared__ float nA[TILE], nB[TILE];
  __shared__ uint8_t vA[TILE], vB[TILE];
  __shared__ float cmin[WARPS][TILE];
  __shared__ int carg[WARPS][TILE];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TILE;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  d0 += b * d0_bs;
  d1 += b * d1_bs;
  v0 += b * v0_bs;
  v1 += b * v1_bs;

  for (int i = tid; i < TILE * D; i += TILE * WARPS) {
    const int r = i / D, k = i % D, gr = row0 + r;
    sA[r][k] = gr < K0 ? to_f(d0[(long long)gr * D + k]) : 0.f;
  }
  if (tid < TILE) vA[tid] = (row0 + tid < K0) ? v0[row0 + tid] : 0;
  __syncthreads();
  for (int r = ty; r < TILE; r += WARPS) {
    float s = 0.f;
    for (int k = tx; k < D; k += TILE) s += sA[r][k] * sA[r][k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (tx == 0) nA[r] = s;
  }

  float best[RPT];
  int bestc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) { best[i] = INFINITY; bestc[i] = 0x7fffffff; }

  for (int c0 = 0; c0 < K1; c0 += TILE) {
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    float nb = 0.f;
    for (int k0 = 0; k0 < D; k0 += DCHUNK) {
      const int kc = min(DCHUNK, D - k0);
      __syncthreads();   // previous chunk fully consumed
      for (int i = tid; i < TILE * DCHUNK; i += TILE * WARPS) {
        const int c = i / DCHUNK, k = i % DCHUNK, gc = c0 + c;
        sB[c][k] = (gc < K1 && k < kc)
                       ? to_f(d1[(long long)gc * D + k0 + k]) : 0.f;
      }
      __syncthreads();
      for (int k = 0; k < kc; ++k) {
        const float bv = sB[tx][k];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i] = fmaf(sA[ty + WARPS * i][k0 + k], bv, acc[i]);
      }
      if (ty == 0)
        for (int k = 0; k < kc; ++k) nb += sB[tx][k] * sB[tx][k];
    }
    if (ty == 0) {
      nB[tx] = nb;
      vB[tx] = (c0 + tx < K1) ? v1[c0 + tx] : 0;
    }
    __syncthreads();

    const int gc = c0 + tx;
    float cbest = INFINITY;
    int crow = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + WARPS * i, gr = row0 + r;
      if (gr < K0 && gc < K1) {
        float dist = fmaxf((nA[r] + nB[tx]) - 2.0f * acc[i], 0.f);
        if (!(vA[r] && vB[tx])) dist = BIG;
        if (dist < best[i]) { best[i] = dist; bestc[i] = gc; }
        if (dist < cbest) { cbest = dist; crow = gr; }
      }
    }
    cmin[ty][tx] = cbest;
    carg[ty][tx] = crow;
    __syncthreads();
    if (ty == 0 && gc < K1) {
      float m = cmin[0][tx];
      int a = carg[0][tx];
      for (int w = 1; w < WARPS; ++w) {
        const float mw = cmin[w][tx];
        const int aw = carg[w][tx];
        if (mw < m || (mw == m && aw < a)) { m = mw; a = aw; }
      }
      if (a != 0x7fffffff) {
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(m) << 32) | (unsigned)a;
        atomicMin(&colkey[(long long)b * K1 + gc], key);
      }
    }
  }

  // row min/argmin across the 32 lanes: lexicographic (dist, column)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float v = best[i];
    int c = bestc[i];
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, off);
      const int oc = __shfl_xor_sync(FULL, c, off);
      if (ov < v || (ov == v && oc < c)) { v = ov; c = oc; }
    }
    const int gr = row0 + ty + WARPS * i;
    if (tx == 0 && gr < K0) {
      rowmin[(long long)b * K0 + gr] = v;
      rowarg[(long long)b * K0 + gr] = c;
    }
  }
}

__global__ void match_mutual_kernel(const float* __restrict__ rowmin,
                                    const int* __restrict__ rowarg,
                                    const unsigned long long* __restrict__ colkey,
                                    const uint8_t* __restrict__ v0,
                                    long long v0_bs, int B, int K0, int K1,
                                    int* __restrict__ idx,
                                    float* __restrict__ dist2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * K0) return;
  const int b = (int)(i / K0), r = (int)(i % K0);
  const float m = rowmin[i];
  const int c = rowarg[i];
  bool ok = v0[b * v0_bs + r] && m < BIG;
  if (ok) {
    const unsigned long long key = colkey[(long long)b * K1 + c];
    ok = (int)(key & 0xffffffffull) == r;
  }
  idx[i] = ok ? c : -1;
  dist2[i] = m;
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). All buffers are
// device pointers allocated by the caller; `colkey` is scratch of B*K1
// uint64 and is reset here. Batch strides are in elements (0 = broadcast).
extern "C" int match_nn_launch(const void* d0, long long d0_bs,
                               const void* v0, long long v0_bs,
                               const void* d1, long long d1_bs,
                               const void* v1, long long v1_bs, int B, int K0,
                               int K1, int D, int is_bf16, void* rowmin,
                               void* rowarg, void* colkey, void* idx,
                               void* dist2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || K0 <= 0 || K1 <= 0 || D <= 0 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      colkey, 0xff, sizeof(unsigned long long) * (size_t)B * K1, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K0 + TILE - 1) / TILE, B), block(TILE, WARPS);
  if (is_bf16) {
    match_rows_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)d0, d0_bs, (const uint8_t*)v0, v0_bs,
        (const __nv_bfloat16*)d1, d1_bs, (const uint8_t*)v1, v1_bs, K0, K1, D,
        (float*)rowmin, (int*)rowarg, (unsigned long long*)colkey);
  } else {
    match_rows_kernel<float><<<grid, block, 0, s>>>(
        (const float*)d0, d0_bs, (const uint8_t*)v0, v0_bs, (const float*)d1,
        d1_bs, (const uint8_t*)v1, v1_bs, K0, K1, D, (float*)rowmin,
        (int*)rowarg, (unsigned long long*)colkey);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * K0, threads = 256;
  match_mutual_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      (const float*)rowmin, (const int*)rowarg,
      (const unsigned long long*)colkey, (const uint8_t*)v0, v0_bs, B, K0, K1,
      (int*)idx, (float*)dist2);
  return (int)cudaGetLastError();
}
