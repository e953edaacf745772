// Fused mutual-nearest-neighbour descriptor matcher for Hopper (sm_90a).
//
// Replaces the TPU kernel spsvo_tpu/ops/matching_pallas.py::_match_kernel
// (wrapper match_nn_pallas). Per batch entry b it computes, for query
// descriptors d0 (K0, D) against targets d1 (K1, D):
//   dist = max(|a|^2 + |b|^2 - 2 a.b, 0), masked to 1e30 where either slot
//   is invalid; row argmin and column argmin, lowest index wins ties; the
//   mutual check; idx (-1 = no match) and the row-min dist^2.
//
// What bounds it on this card. At the per-frame shapes (B=2, K0=K1=512,
// D=256, bf16) the product is 2*B*K0*K1*D = 268 MFLOP: 0.27 us at the bf16
// tensor-core peak (989 TFLOP/s); the bytes (query read once, targets,
// masks, outputs: ~0.80 MB) take 0.24 us at 3.35 TB/s. Both are far below
// one launch's own latency (a few us), so the design aims at ONE device
// operation per call whose time is set by the launch and a short chain.
//
// bf16 path (the main path), match_nn_bf16_launch:
//  - Product on the tensor cores: wgmma m64n64k16, bf16 operands, fp32
//    accumulators. A bf16 x bf16 product is exact in fp32, so this is the
//    function the plain version computes (it upcasts, then sums in fp32).
//    Both operands are K-major exactly as stored (d0 and d1 rows), so no
//    transpose: A = the CTA's 64 query rows, B = its 64 target rows.
//  - Loads: TMA. One thread starts every copy at the kernel's entry: for
//    each 64-wide k-block, a 64x64 box of A and one of B into shared
//    memory in the 128-byte swizzle layout wgmma reads, completing on that
//    k-block's mbarrier; the four wgmmas of a k-block start as soon as it
//    has landed, so copy and product overlap. The tensor map zero-fills the
//    ragged edge. (A first version copied with per-thread 16-byte cp.async
//    into the no-swizzle layout: the copies took ~5 us of a 15 us call.)
//    The maps are encoded on the host per call (cuTensorMapEncodeTiled,
//    reached through cudaGetDriverEntryPoint: no libcuda link).
//  - Grid: (K1/64, K0/64, B) CTAs of one warpgroup: 128 CTAs at B=2 (the
//    card has 132 SMs), ~4,000 at the hybrid's B=63. A broadcast operand
//    (batch stride 0) is a map with one batch entry.
//  - Norms |a|^2, |b|^2 in fp32 from the same shared tiles, computed while
//    the wgmmas run.
//  - Row AND column argmin cross CTAs: both are packed 64-bit atomicMin
//    keys (float bits of the clamped distance << 32 | index). dist >= 0
//    after the clamp, so the bits order like unsigned integers and the key
//    keeps the lowest-index tie rule. Inside a CTA: quad shuffles for rows,
//    warp shuffles then the 4 warps' minima in shared memory for columns.
//  - Mutual check and scratch reset in the same launch: each CTA fences its
//    atomics and takes a ticket; the last CTA of batch entry b reads the
//    keys from L2, writes idx / dist2 for b, and resets b's keys and ticket
//    to their initial values, so the caller's persistent scratch is ready
//    for the next call. One device operation per call (the wrapper fills
//    the scratch once, when it first allocates or grows it).
//
// fp32 path, match_nn_f32_launch: a SIMT kernel on the fp32 cores (TF32
// would change the numbers; the reference pins fp32): a memset of the
// column keys, the rows kernel, the mutual kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long KEY_NONE = ~0ull;
constexpr int MAX_D = 256;

__device__ __forceinline__ unsigned long long pack_key(float d, int i) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)i;
}

// ===========================================================================
// bf16: TMA + wgmma tiles
// ===========================================================================

constexpr int BM = 64;            // query rows per CTA (wgmma M)
constexpr int BN = 64;            // target rows per CTA (wgmma N)
constexpr int BK = 64;            // k-block: one 128-byte swizzle atom wide
constexpr int TC_THREADS = 128;   // one warpgroup
constexpr int MAX_KB = MAX_D / BK;
constexpr int KB_BYTES = BM * BK * 2;   // one k-block of one tile: 8 KB

struct __align__(1024) TcSmem {
  unsigned char a[MAX_KB][KB_BYTES];   // 128B-swizzled, as TMA writes it
  unsigned char b[MAX_KB][KB_BYTES];
  unsigned long long full[MAX_KB];     // mbarrier per k-block (A and B)
  unsigned long long ckw[4][BN];       // per-warp column minima
  float na[BM], nb[BN];
  uint8_t vb[BN];
  int last;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// One 64 x 64 bf16 box of a (B', K, D) tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, int batch,
                                         unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(k), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle layout: rows
// of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused there.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Sum of squares of tile row r over nkb swizzled k-blocks (fp32, fixed
// order: k-block, then logical 16-byte chunk).
__device__ __forceinline__ float row_norm(const unsigned char (*t)[KB_BYTES],
                                          int r, int nkb) {
  float s = 0.f;
  for (int kb = 0; kb < nkb; ++kb)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          t[kb] + r * 128 + ((c ^ (r & 7)) << 4));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        s = fmaf(f.x, f.x, s);
        s = fmaf(f.y, f.y, s);
      }
    }
  return s;
}

__device__ __forceinline__ unsigned long long shfl_min(unsigned long long k,
                                                       int off) {
  const unsigned long long o = __shfl_xor_sync(FULL, k, off);
  return o < k ? o : k;
}

__global__ void __launch_bounds__(TC_THREADS)
match_tc_kernel(const __grid_constant__ CUtensorMap map0,
                const __grid_constant__ CUtensorMap map1, int bcast0,
                int bcast1,
                const uint8_t* __restrict__ v0, long long v0_bs,
                const uint8_t* __restrict__ v1, long long v1_bs, int K0,
                int K1, int D, unsigned long long* __restrict__ rowkey,
                unsigned long long* __restrict__ colkey,
                unsigned* __restrict__ ticket, int* __restrict__ idx,
                float* __restrict__ dist2) {
  extern __shared__ unsigned char smem_raw[];
  TcSmem& sh = *reinterpret_cast<TcSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nkb = D / BK;

  // ---- one thread starts every copy: k-block kb of A and B on full[kb] ---
  if (tid == 0) {
    for (int kb = 0; kb < nkb; ++kb)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&sh.full[kb]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int kb = 0; kb < nkb; ++kb) {
      const unsigned bar = smem_u32(&sh.full[kb]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(2 * KB_BYTES)
                   : "memory");
      tma_load(sh.a[kb], &map0, kb * BK, row0, bcast0 ? 0 : b, bar);
      tma_load(sh.b[kb], &map1, kb * BK, col0, bcast1 ? 0 : b, bar);
    }
  }
  // masks while the tiles are in flight
  v0 += b * v0_bs;
  v1 += b * v1_bs;
  rowkey += (long long)b * K0;
  colkey += (long long)b * K1;
  const int lr0 = warp * 16 + (lane >> 2), lr1 = lr0 + 8;
  const int gr0 = row0 + lr0, gr1 = row0 + lr1;
  const bool in0 = gr0 < K0, in1 = gr1 < K0;
  const bool va0 = in0 && v0[in0 ? gr0 : 0], va1 = in1 && v0[in1 ? gr1 : 0];
  if (tid < BN) sh.vb[tid] = (col0 + tid < K1) ? v1[col0 + tid] : 0;
  __syncthreads();   // barriers initialised

  // ---- product: each k-block's 4 wgmmas start as soon as it has landed ---
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int kb = 0; kb < nkb; ++kb) {
    mbar_wait(smem_u32(&sh.full[kb]), 0);
    const uint64_t da = sw128_desc(sh.a[kb]), db = sw128_desc(sh.b[kb]);
#pragma unroll
    for (int s = 0; s < BK / 16; ++s)   // +32 bytes within the swizzle atom
      wgmma_m64n64k16(acc, da + 2 * s, db + 2 * s, (kb | s) != 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

  // norms from the same tiles while the tensor cores run
  if (tid < BM) sh.na[tid] = row_norm(sh.a, tid, nkb);
  else sh.nb[tid - BM] = row_norm(sh.b, tid - BM, nkb);

  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  __syncthreads();

  // ---- epilogue: accumulator (row 16w + lane/4 + 8i, col 8j + 2(lane%4) + k)
  // is acc[4j + 2i + k] ---------------------------------------------------
  const float na0 = sh.na[lr0], na1 = sh.na[lr1];
  unsigned long long rk0 = KEY_NONE, rk1 = KEY_NONE;
  unsigned long long ck[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int lc = 8 * j + 2 * (lane & 3) + k, gc = col0 + lc;
      unsigned long long c = KEY_NONE;
      if (gc < K1) {
        const bool vb = sh.vb[lc] != 0;
        const float nb = sh.nb[lc];
        if (in0) {
          float d = fmaxf((na0 + nb) - 2.0f * acc[4 * j + k], 0.f);
          if (!(va0 && vb)) d = BIG;
          const unsigned long long kr = pack_key(d, gc);
          rk0 = kr < rk0 ? kr : rk0;      // columns increase: lowest wins
          c = pack_key(d, gr0);
        }
        if (in1) {
          float d = fmaxf((na1 + nb) - 2.0f * acc[4 * j + 2 + k], 0.f);
          if (!(va1 && vb)) d = BIG;
          const unsigned long long kr = pack_key(d, gc);
          rk1 = kr < rk1 ? kr : rk1;
          const unsigned long long kc = pack_key(d, gr1);
          c = kc < c ? kc : c;
        }
      }
      ck[2 * j + k] = c;
    }
  }
  // rows: the 4 lanes of a quad hold one row's 64 column slots
  rk0 = shfl_min(shfl_min(rk0, 1), 2);
  rk1 = shfl_min(shfl_min(rk1, 1), 2);
  if ((lane & 3) == 0) {
    if (rk0 != KEY_NONE) atomicMin(&rowkey[gr0], rk0);
    if (rk1 != KEY_NONE) atomicMin(&rowkey[gr1], rk1);
  }
  // columns: the 8 quads of a warp hold a column's 16 rows; then the 4
  // warps' minima in warp order
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const unsigned long long c = shfl_min(shfl_min(shfl_min(ck[i], 4), 8), 16);
    if (lane < 4) sh.ckw[warp][8 * (i >> 1) + 2 * lane + (i & 1)] = c;
  }
  __syncthreads();
  if (tid < BN && col0 + tid < K1) {
    unsigned long long c = sh.ckw[0][tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) c = sh.ckw[w][tid] < c ? sh.ckw[w][tid] : c;
    if (c != KEY_NONE) atomicMin(&colkey[col0 + tid], c);
  }

  // ---- last CTA of batch entry b: mutual check + scratch reset ------------
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned n = gridDim.x * gridDim.y;
    sh.last = atomicAdd(&ticket[b], 1u) == n - 1;
  }
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  constexpr int U = 4;                 // rows per thread in flight
  for (int r0 = tid; r0 < K0; r0 += U * TC_THREADS) {
    unsigned long long rk[U], ckk[U];
    bool vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * TC_THREADS;
      rk[u] = r < K0 ? __ldcg(&rowkey[r]) : KEY_NONE;
      vr[u] = r < K0 && v0[r];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (int)(rk[u] & 0xffffffffull);
      ckk[u] = (rk[u] != KEY_NONE && c < K1) ? __ldcg(&colkey[c]) : KEY_NONE;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * TC_THREADS;
      if (r >= K0) break;
      const float m = __uint_as_float((unsigned)(rk[u] >> 32));
      const int c = (int)(rk[u] & 0xffffffffull);
      const bool ok = vr[u] && m < BIG &&
                      (int)(ckk[u] & 0xffffffffull) == r;
      idx[(long long)b * K0 + r] = ok ? c : -1;
      dist2[(long long)b * K0 + r] = m;
    }
  }
  __syncthreads();
  for (int r = tid; r < K0; r += TC_THREADS) rowkey[r] = KEY_NONE;
  for (int c = tid; c < K1; c += TC_THREADS) colkey[c] = KEY_NONE;
  if (tid == 0) ticket[b] = 0u;
}

// Tensor map of a (B', K, D) bf16 tensor with rows of D elements and a
// batch stride of bs elements (B' = 1 for a broadcast, bs = 0): 64 x 64
// boxes, 128-byte swizzle, zero fill out of bounds (the ragged edge).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int make_map(CUtensorMap* map, const void* base, int B, int K, int D,
             long long bs) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !fn)
      return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)K,
                              (cuuint64_t)(bs == 0 ? 1 : B)};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)(bs ? bs : (long long)K * D) * 2};
  const cuuint32_t box[3] = {BK, BM, 1}, estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                            const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ===========================================================================
// fp32: SIMT kernel
// ===========================================================================

constexpr int TILE = 32;        // query rows per CTA, target columns per tile
constexpr int WARPS = 8;        // CTA = 32 x 8 threads
constexpr int RPT = TILE / WARPS;   // query rows per thread
constexpr int DCHUNK = 64;      // target tile depth staged per step

// One CTA per (batch, 32-row query tile) holds its query tile in shared
// memory, streams 32-column target tiles through shared memory in D-chunks
// of 64, and keeps the row min/argmin in registers (columns scanned in
// increasing order with a strict <, so the lowest column wins). The column
// argmin across CTAs is an atomicMin on the packed key (dist, row).
__global__ void __launch_bounds__(TILE * WARPS)
match_rows_kernel(const float* __restrict__ d0, long long d0_bs,
                  const uint8_t* __restrict__ v0, long long v0_bs,
                  const float* __restrict__ d1, long long d1_bs,
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
    sA[r][k] = gr < K0 ? d0[(long long)gr * D + k] : 0.f;
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
        sB[c][k] = (gc < K1 && k < kc) ? d1[(long long)gc * D + k0 + k] : 0.f;
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
      if (a != 0x7fffffff)
        atomicMin(&colkey[(long long)b * K1 + gc], pack_key(m, a));
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

// Both entry points return the cudaError_t of their launches (0 = success).
// Buffers are device pointers allocated by the caller; batch strides are in
// elements (0 = broadcast).

// bf16, one launch. `rowkey` (B*K0) and `colkey` (B*K1) uint64 must hold
// all ones and `ticket` (B) uint32 zeros on entry; the kernel leaves them
// so. d0, d1 16-byte aligned, batch strides multiples of 8, D % 64 == 0.
extern "C" int match_nn_bf16_launch(const void* d0, long long d0_bs,
                                    const void* v0, long long v0_bs,
                                    const void* d1, long long d1_bs,
                                    const void* v1, long long v1_bs, int B,
                                    int K0, int K1, int D, void* rowkey,
                                    void* colkey, void* ticket, void* idx,
                                    void* dist2, void* stream) {
  if (B <= 0 || K0 <= 0 || K1 <= 0 || D < BK || D > MAX_D || D % BK ||
      d0_bs % 8 || d1_bs % 8 ||
      ((uintptr_t)d0 | (uintptr_t)d1) % 16)
    return (int)cudaErrorInvalidValue;
  static unsigned long long attr_set = 0;        // one bit per device
  const int smem = (int)sizeof(TcSmem) + 1024;   // + alignment slack
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(attr_set >> dev & 1ull)) {
    e = cudaFuncSetAttribute(match_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set |= 1ull << dev;
  }
  CUtensorMap map0, map1;
  int err = make_map(&map0, d0, B, K0, D, d0_bs);
  if (err) return err;
  err = make_map(&map1, d1, B, K1, D, d1_bs);
  if (err) return err;
  dim3 grid((K1 + BN - 1) / BN, (K0 + BM - 1) / BM, B);
  match_tc_kernel<<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(
      map0, map1, d0_bs == 0, d1_bs == 0, (const uint8_t*)v0, v0_bs,
      (const uint8_t*)v1,
      v1_bs, K0, K1, D, (unsigned long long*)rowkey,
      (unsigned long long*)colkey, (unsigned*)ticket, (int*)idx,
      (float*)dist2);
  return (int)cudaGetLastError();
}

// fp32, three device operations. `colkey` is scratch of B*K1 uint64
// and is reset here.
extern "C" int match_nn_f32_launch(const void* d0, long long d0_bs,
                                   const void* v0, long long v0_bs,
                                   const void* d1, long long d1_bs,
                                   const void* v1, long long v1_bs, int B,
                                   int K0, int K1, int D, void* rowmin,
                                   void* rowarg, void* colkey, void* idx,
                                   void* dist2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || K0 <= 0 || K1 <= 0 || D <= 0 || D > MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      colkey, 0xff, sizeof(unsigned long long) * (size_t)B * K1, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((K0 + TILE - 1) / TILE, B), block(TILE, WARPS);
  match_rows_kernel<<<grid, block, 0, s>>>(
      (const float*)d0, d0_bs, (const uint8_t*)v0, v0_bs, (const float*)d1,
      d1_bs, (const uint8_t*)v1, v1_bs, K0, K1, D, (float*)rowmin,
      (int*)rowarg, (unsigned long long*)colkey);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = B * K0, threads = 256;
  match_mutual_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      (const float*)rowmin, (const int*)rowarg,
      (const unsigned long long*)colkey, (const uint8_t*)v0, v0_bs, B, K0, K1,
      (int*)idx, (float*)dist2);
  return (int)cudaGetLastError();
}
