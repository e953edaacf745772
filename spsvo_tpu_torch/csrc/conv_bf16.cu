// bf16 convolution for Hopper (sm_90a): two implicit GEMMs on the tensor
// cores, one per route.
//
// Replaces an XLA op, not a Pallas kernel: the bf16 branch of
// spsvo_tpu/models/onnx_import.py::_conv (lines 249-269),
// lax.conv_general_dilated on bf16 operands with
// preferred_element_type=float32. That is exact bf16 products summed in
// fp32 with an fp32 result, which is what a bf16 MMA with fp32 accumulators
// computes:
//   y[n, co, oh, ow] = b[co] + sum over the group's (ci, kh, kw) of
//                      bf16(x[n, ci, ih, iw]) * bf16(w[co, ci, kh, kw])
//   ih = oh * sh - pad_top + kh * dh,  iw = ow * sw - pad_left + kw * dw
// (zero outside the image), then ReLU where the graph fused one, then,
// where the graph fused one, the 2x2 stride-2 max-pool.
//
// Routes, chosen from the layer's attributes alone (ops/conv_cuda.py
// `route`):
//  - dense (conv_bf16_dense_launch): groups 1, stride 1, dilation 1, a
//    1x1 or 3x3 kernel, C a multiple of 16. Eleven of superpoint_pretrained's
//    twelve convs, every 3x3 and 1x1 of sp_resnet18's blocks and heads.
//    Input bf16 NHWC, weight bf16 [Cout][KH][KW][C] (a packed copy the
//    wrapper keeps beside the fp32 OIHW buffer and rebuilds when the
//    buffer's version or storage changes). A warp-specialised persistent
//    kernel: one producer thread keeps a 4-stage ring of shared-memory
//    stages filled by TMA, two consumer warpgroups run wgmma.m64nNk16
//    (N = 64 or 128, from Cout) with fp32 accumulators in registers, one
//    m64 block each or, at N = 64, two.
//  - generic (conv_bf16_launch, the first version): every other form -
//    conv1a (C = 1, K = 9), strided, dilated, grouped and depthwise convs.
//    Input fp32 NCHW and weight fp32 OIHW, rounded to bf16 as they are
//    loaded; mma.sync.m16n8k16. It writes fp32 NCHW or, new, bf16 NHWC, so
//    that conv1a feeds conv1b's TMA loads.
//
// What held the first version back, and what this design does about it:
//  1. The implicit im2col was a scalar fp32 gather (16 __ldg and div/mod
//     per thread per k-tile; a 3x3 conv read each input 9 times through
//     registers). Dense route: each (tap, 64-channel chunk) of K is ONE TMA
//     box load of a TH x TW rectangle of one image's output pixels shifted
//     by the tap, a 128-row x 128-byte K-major tile in the 128-byte swizzle
//     wgmma reads. TMA's zero fill outside the tensor is the conv's zero
//     padding: no bounds arithmetic in the inner loop, no thread spends an
//     instruction on a load. The 9 re-reads of a 3x3 conv hit L2.
//  2. Activations travelled as fp32 NCHW although only their bf16 value
//     is used. A conv-to-conv activation (models/graph.py's storage pass)
//     is now written once as bf16 NHWC by its producer's epilogue, rounded
//     as Tensor.to(torch.bfloat16) rounds (__floats2bfloat162_rn), and read
//     as is. Graph outputs and tensors with an fp32 consumer stay fp32 NCHW.
//  3. The three 2x2 max-pools ran as separate passes over full-resolution
//     fp32 maps. A conv whose only consumer is an unpadded 2x2/2 MaxPool
//     stored as bf16 (conv1b, conv2b, conv3b) pools in its epilogue: the M
//     tile is whole row pairs (TH even, tiles start at even rows and
//     columns), the tile is staged rounded in shared memory and only the
//     pooled bf16 tensor is written. Rounding is monotone, so max then
//     round equals round then max; the window is read in F.max_pool2d's
//     order with its NaN rule; an odd last row or column is dropped as the
//     floor drops it.
//  4. One 128x64x32 tile for every layer. Dense route: N is 64 or 128
//     from Cout; the M tile is 128 pixels, or 256 at N = 64 (two m64
//     blocks per warpgroup: half the weight loads per pixel and twice the
//     products per stage; 0.80 -> 0.64 ms on conv1b at B=64 on an NVIDIA
//     H100 80GB HBM3 at 700 W, tools/torch_conv_ab.py), as
//     TH x TW with TW in 8..64 picked per layer from OH and OW to waste the
//     fewest pixels; the grid is persistent (min(tiles, SMs) CTAs walking
//     the tiles), so the producer loads a CTA's next tile while its
//     consumers run the epilogue. The generic route's bf16 NHWC epilogue
//     stages the tile along the channels and writes 16 bytes per store.
//
// Batch invariance, by design. Dense route: every output element is
// summed over K in the order (kh, kw, 64-channel chunk, k16 step) in one
// fp32 accumulator with one instruction (wgmma.m64nNk16, N from Cout), no
// split of K and no atomics: the order is fixed by the layer form
// (C, Cout, KH, KW). The tile's shape along M (from OH, OW and Cout),
// which m64 block holds an element and where it lies in the tile change no
// element's sum. Generic route: k-tiles of 32
// in (ci, kh, kw) order, mma.sync, one constant tile. So an image's output
// is the same bits at any batch size and any offset in the batch. The two
// routes order K differently, and round differently; a layer always takes
// the same one.
//
// Bound at the trunk's shapes (superpoint_pretrained, 120x392, B=64; the
// 3.35 TB/s and 989 TFLOP/s of an H100 SXM): 511 GFLOP of bf16 MMAs, 0.52
// ms. Counting bf16 inputs, bf16 weights and the stored outputs (bf16
// conv-to-conv, pooled where fused, fp32 for the two heads' outputs), the
// larger of bytes and operations per layer sums to ~0.66 ms: conv1a 0.12
// (bytes), conv1b 0.22 (operations), conv2a/2b 0.06 each, conv3a 0.03,
// conv3b 0.06, conv4a/4b 0.014 each, convPa/Da 0.03 each, convPb 0.011,
// convDb 0.02. chip_smoke.py phase 4b prints it per layer from the shapes,
// beside the fp32-bytes bound (1.145 ms).
//
// Both kernels launch on the caller's stream, allocate nothing and can be
// captured in a CUDA graph (the tensor maps are kernel parameters).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ===========================================================================
// generic route: mma.sync implicit GEMM over fp32 NCHW
// ===========================================================================

constexpr int BM = 128;          // output pixels per CTA
constexpr int BN = 64;           // output channels per CTA
constexpr int BK = 32;           // k-tile
constexpr int LDS = BK + 8;      // bf16 row stride in shared memory: 80 B,
                                 // conflict-free fragment reads
constexpr int THREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr int CS_LD = BM + 4;    // fp32 row stride of the staged output
constexpr int A_ELEMS = BM * LDS;
constexpr int B_ELEMS = BN * LDS;
constexpr int AB_BYTES = 2 * (A_ELEMS + B_ELEMS) * 2;
constexpr int CT_LD = BN + 4;    // fp32 row stride of the staged output
                                 // along the channels (bf16 NHWC)
constexpr int C_BYTES = BN * CS_LD * 4 > BM * CT_LD * 4 ? BN * CS_LD * 4
                                                        : BM * CT_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

struct Shape {
  int N, C, H, W, Cout, KH, KW, OH, OW;
  int sh, sw, pt, pl, dh, dw, groups, relu, out_bf16;
  int Cg, Ng, K, KHW;
  long long M;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float relu_f(float v) {
  return (v > 0.f || v != v) ? v : 0.f;   // NaN passes, as torch.relu
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
conv_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, void* __restrict__ y,
                 const Shape s) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  __shared__ long long out_base[BM];     // y offset of each tile row, or -1
  uint16_t* As = reinterpret_cast<uint16_t*>(smem);        // [2][BM][LDS]
  uint16_t* Bs = As + 2 * A_ELEMS;                          // [2][BN][LDS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int g = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = s.H * s.W;
  const long long OHW = (long long)s.OH * s.OW;

  // A loader: one output pixel (tile row a_m) and 16 consecutive k
  const int a_m = tid % BM, a_k = (tid / BM) * 16;
  const long long m = m0 + a_m;
  const bool m_ok = m < s.M;
  int ih0 = 0, iw0 = 0;
  const float* x_img = x;
  {
    const long long mm = m_ok ? m : 0;
    const long long n_img = mm / OHW;
    const int pix = (int)(mm - n_img * OHW);
    const int oh = pix / s.OW, ow = pix - (pix / s.OW) * s.OW;
    ih0 = oh * s.sh - s.pt;
    iw0 = ow * s.sw - s.pl;
    x_img = x + (n_img * s.C + (long long)g * s.Cg) * HW;
    // fp32 NCHW: channel 0 of the group at this pixel; bf16 NHWC: the pixel
    if (tid < BM)
      out_base[tid] = !m_ok ? -1
                      : s.out_bf16 ? mm * s.Cout + (long long)g * s.Ng
                      : (n_img * s.Cout + (long long)g * s.Ng) * OHW + pix;
  }
  // B loader: one output channel (tile row b_n) and 8 consecutive k
  const int b_n = tid >> 2, b_k = (tid & 3) * 8;
  const bool n_ok = n0 + b_n < s.Ng;
  const float* w_row = w + ((long long)g * s.Ng + n0 + (n_ok ? b_n : 0)) * s.K;

  float fa[16], fb[8];
  auto load = [&](int kt) {
    int k = kt * BK + a_k;
    int ci = k / s.KHW;
    int r = k - ci * s.KHW;
    int kh = r / s.KW;
    int kw = r - kh * s.KW;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = 0.f;
      if (m_ok && k + j < s.K) {
        const int ih = ih0 + kh * s.dh, iw = iw0 + kw * s.dw;
        if ((unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W)
          v = __ldg(x_img + (long long)ci * HW + ih * s.W + iw);
      }
      fa[j] = v;
      if (++kw == s.KW) {
        kw = 0;
        if (++kh == s.KH) {
          kh = 0;
          ++ci;
        }
      }
    }
    const int kb = kt * BK + b_k;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      fb[j] = (n_ok && kb + j < s.K) ? __ldg(w_row + kb + j) : 0.f;
  };
  auto store = [&](int buf) {
    uint32_t pa[8], pb[4];
#pragma unroll
    for (int j = 0; j < 8; ++j) pa[j] = pack_bf16(fa[2 * j], fa[2 * j + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) pb[j] = pack_bf16(fb[2 * j], fb[2 * j + 1]);
    uint4* da = reinterpret_cast<uint4*>(As + buf * A_ELEMS + a_m * LDS + a_k);
    da[0] = make_uint4(pa[0], pa[1], pa[2], pa[3]);
    da[1] = make_uint4(pa[4], pa[5], pa[6], pa[7]);
    *reinterpret_cast<uint4*>(Bs + buf * B_ELEMS + b_n * LDS + b_k) =
        make_uint4(pb[0], pb[1], pb[2], pb[3]);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
  const int KT = (s.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);      // in flight during the MMAs
    const uint16_t* a_s = As + cur * A_ELEMS;
    const uint16_t* b_s = Bs + cur * B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint16_t* p = a_s + (wm + mi * 16 + gid) * LDS + ks + tig * 2;
        af[mi][0] = ld_pair(p);
        af[mi][1] = ld_pair(p + 8 * LDS);
        af[mi][2] = ld_pair(p + 8);
        af[mi][3] = ld_pair(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* p = b_s + (wn + ni * 8 + gid) * LDS + ks + tig * 2;
        bf[ni][0] = ld_pair(p);
        bf[ni][1] = ld_pair(p + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bf[ni]);
    }
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bias, ReLU, stage the tile in shared memory - [BN][BM] to
  // write fp32 NCHW along the pixels, [BM][BN] to write bf16 NHWC along the
  // channels, 8 channels (16 bytes) per store
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = wn + ni * 8 + tig * 2 + c;
      const int n = n0 + col;
      const float b = (bias != nullptr && n < s.Ng)
                          ? __ldg(bias + (long long)g * s.Ng + n) : 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = acc[mi][ni][h * 2 + c];
          if (bias != nullptr) v = v + b;
          if (s.relu) v = relu_f(v);
          const int row = wm + mi * 16 + gid + 8 * h;
          if (s.out_bf16) Cs[row * CT_LD + col] = v;
          else Cs[col * CS_LD + row] = v;
        }
      }
    }
  }
  __syncthreads();
  if (s.out_bf16) {
    __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(y);
    const bool vec = (s.Ng & 7) == 0 && (s.Cout & 7) == 0;
    for (int idx = tid; idx < BM * (BN / 8); idx += THREADS) {
      const int ml = idx / (BN / 8), nl = 8 * (idx % (BN / 8));
      const long long ob = out_base[ml];
      if (ob < 0 || n0 + nl >= s.Ng) continue;
      const float4 lo = *reinterpret_cast<const float4*>(Cs + ml * CT_LD + nl);
      const float4 hi =
          *reinterpret_cast<const float4*>(Cs + ml * CT_LD + nl + 4);
      uint4 v;
      v.x = pack_bf16(lo.x, lo.y);
      v.y = pack_bf16(lo.z, lo.w);
      v.z = pack_bf16(hi.x, hi.y);
      v.w = pack_bf16(hi.z, hi.w);
      if (vec) {
        *reinterpret_cast<uint4*>(yb + ob + n0 + nl) = v;
      } else {
        const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
        for (int k = 0; k < 8 && n0 + nl + k < s.Ng; ++k)
          reinterpret_cast<uint16_t*>(yb)[ob + n0 + nl + k] = e[k];
      }
    }
  } else {
    float* yf = reinterpret_cast<float*>(y);
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int nl = idx / BM, ml = idx - (idx / BM) * BM;
      const long long ob = out_base[ml];
      if (ob >= 0 && n0 + nl < s.Ng)
        yf[ob + (long long)(n0 + nl) * OHW] = Cs[nl * CS_LD + ml];
    }
  }
}

// ===========================================================================
// dense route: TMA-fed, warp-specialised wgmma implicit GEMM over bf16 NHWC
// ===========================================================================

constexpr int D_BK = 64;             // channels per (tap, chunk): 128 bytes
constexpr int D_STAGES = 4;   // 8 or 5 were no faster on an NVIDIA H100
constexpr int D_CONSUMERS = 2;       // warpgroups, 64 * MB tile rows each
constexpr int D_THREADS = 128 * (D_CONSUMERS + 1);

enum OutMode { OUT_F32_NCHW = 0, OUT_BF16_NHWC = 1, OUT_BF16_NHWC_POOL = 2 };

struct DenseShape {
  int N, C, H, W, Cout, KH, KW, OH, OW, pt, pl, relu, mode;
  int tw_log2, tiles_w, tiles_h, tiles_n, chunks, k_steps;
  long long tiles;
};

// N tile BN_ (the wgmma's N), MB_ m64 blocks per consumer warpgroup: an M
// tile of BM = 128 MB_ output pixels, TH x TW
template <int BN_, int MB_>
struct DenseSmem {
  static constexpr int BM = 128 * MB_;
  static constexpr int A_BYTES = BM * D_BK * 2;
  static constexpr int B_BYTES = BN_ * D_BK * 2;
  static constexpr int ST_LD = BN_ + 8;      // bf16 staging row: +16 B,
                                             // conflict-free quad stores
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = D_STAGES * A_BYTES;
  static constexpr int ST_OFF = B_OFF + D_STAGES * B_BYTES;
  static constexpr int BAR_OFF = ST_OFF + BM * ST_LD * 2;
  static constexpr int BYTES = BAR_OFF + 2 * D_STAGES * 8;
  static constexpr int ALLOC = BYTES + 1024;   // for the 1024-byte alignment
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// a lost arrival traps (a launch error the wrapper raises), never hangs
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spins = 0; !mbar_try(bar, parity);)
    if (++spins > (1LL << 26)) __trap();
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// consumer warpgroups only (the producer warpgroup has left): barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * D_CONSUMERS) : "memory");
}

__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int NR>
__device__ __forceinline__ void fence_acc(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
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

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN_>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN_ / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_bn<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  wgmma_n64(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_bn<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  wgmma_n128(d, da, db, scale_d);
}

// max in F.max_pool2d's order and rule: a NaN wins, else a strictly larger
// value; the window's first element stands on ties
__device__ __forceinline__ float pool_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&b));
  const float2 fc = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&c));
  const float2 fd = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&d));
  const float lo = pool_max(pool_max(pool_max(fa.x, fb.x), fc.x), fd.x);
  const float hi = pool_max(pool_max(pool_max(fa.y, fb.y), fc.y), fd.y);
  return pack_bf16(lo, hi);   // each is one of the window's bf16 values
}

template <int BN_, int MB_>
__global__ void __launch_bounds__(D_THREADS, 1)
conv_dense_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ bias, void* __restrict__ y,
                  const DenseShape s) {
  using L = DenseSmem<BN_, MB_>;
  constexpr int BM = L::BM;
  constexpr int NR = BN_ / 2;                 // accumulators per m64 block
  constexpr int STAGE_TX = L::A_BYTES + L::B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const unsigned sm_base = smem_u32(sm);
  const unsigned full0 = sm_base + L::BAR_OFF;          // full[s] at +8s
  const unsigned empty0 = full0 + 8 * D_STAGES;        // empty[s] at +8s
  uint16_t* stage_out = reinterpret_cast<uint16_t*>(sm + L::ST_OFF);

  const int tid = threadIdx.x;
  const int wg = tid / 128;                   // 0, 1: consumers; 2: producer
  if (tid == 0) {
    for (int st = 0; st < D_STAGES; ++st) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       full0 + 8 * st)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       empty0 + 8 * st),
                   "n"(D_CONSUMERS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tw = 1 << s.tw_log2;
  const int th = BM >> s.tw_log2;

  if (wg == D_CONSUMERS) {
    // ---- producer: one thread keeps the ring full, tile after tile ------
    if (tid != 128 * D_CONSUMERS) return;
    int st = 0;
    unsigned phase = 0;
    for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const int nt = (int)(t % s.tiles_n);
      long long r = t / s.tiles_n;
      const int twi = (int)(r % s.tiles_w);
      r /= s.tiles_w;
      const int thi = (int)(r % s.tiles_h);
      const int img = (int)(r / s.tiles_h);
      const int ow0 = twi * tw, oh0 = thi * th, co0 = nt * BN_;
      for (int tap = 0; tap < s.KH * s.KW; ++tap) {
        const int kh = tap / s.KW, kw = tap - (tap / s.KW) * s.KW;
        const int iw = ow0 + kw - s.pl, ih = oh0 + kh - s.pt;
        for (int cc = 0; cc < s.chunks; ++cc) {
          mbar_wait(empty0 + 8 * st, phase ^ 1);
          const unsigned bar = full0 + 8 * st;
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  bar),
              "n"(STAGE_TX)
              : "memory");
          asm volatile(
              "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
              "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
                  sm_base + L::A_OFF + st * L::A_BYTES),
              "l"(&xmap), "r"(cc * D_BK), "r"(iw), "r"(ih), "r"(img), "r"(bar)
              : "memory");
          asm volatile(
              "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
              "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
                  sm_base + L::B_OFF + st * L::B_BYTES),
              "l"(&wmap), "r"(cc * D_BK), "r"(tap), "r"(co0), "r"(bar)
              : "memory");
          if (++st == D_STAGES) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows [64 MB wg, 64 MB (wg + 1)),
  // m64 block mb of it rows from 64 MB wg + 64 mb ---------------------------
  const int ct = tid - 128 * wg, warp = ct >> 5, lane = ct & 31;
  const int row_base = 64 * MB_ * wg + 16 * warp + (lane >> 2);  // + 64mb + 8i
  int st = 0;
  unsigned phase = 0;
  float acc[MB_][NR];
  for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
    const int nt = (int)(t % s.tiles_n);
    long long r = t / s.tiles_n;
    const int twi = (int)(r % s.tiles_w);
    r /= s.tiles_w;
    const int thi = (int)(r % s.tiles_h);
    const int img = (int)(r / s.tiles_h);
    const int ow0 = twi * tw, oh0 = thi * th, co0 = nt * BN_;

#pragma unroll
    for (int mb = 0; mb < MB_; ++mb)
#pragma unroll
      for (int i = 0; i < NR; ++i) acc[mb][i] = 0.f;
    int prev = -1;
    for (int ks = 0; ks < s.k_steps; ++ks) {
      mbar_wait(full0 + 8 * st, phase);
      // an m64 block is 64 rows of 128 B further: +8 KB, +512 in the
      // descriptor's address field; a k16 step +32 B inside the swizzle
      // atom, +2
      const uint64_t da = sw128_desc(sm_base + L::A_OFF + st * L::A_BYTES +
                                     wg * MB_ * 64 * 128);
      const uint64_t db = sw128_desc(sm_base + L::B_OFF + st * L::B_BYTES);
#pragma unroll
      for (int mb = 0; mb < MB_; ++mb) fence_acc(acc[mb]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < D_BK / 16; ++k16)
#pragma unroll
        for (int mb = 0; mb < MB_; ++mb)
          wgmma_bn<BN_>(acc[mb], da + 512 * mb + 2 * k16, db + 2 * k16,
                        (ks | k16) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int mb = 0; mb < MB_; ++mb) fence_acc(acc[mb]);
      // the previous stage's products are done: hand it back
      if (prev >= 0 && ct == 0) mbar_arrive(empty0 + 8 * prev);
      prev = st;
      if (++st == D_STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int mb = 0; mb < MB_; ++mb) fence_acc(acc[mb]);
    if (prev >= 0 && ct == 0) mbar_arrive(empty0 + 8 * prev);

    // ---- epilogue: accumulator (row row_base + 64mb + 8i, col 8j +
    // 2(lane%4) + k) is acc[mb][4j + 2i + k] --------------------------------
    const int cq = 2 * (lane & 3);
    if (s.mode == OUT_F32_NCHW) {
      // straight from the registers: a warp's store covers 8 consecutive
      // pixels of 4 channels
      const long long ohw = (long long)s.OH * s.OW;
      int pix[MB_][2];
#pragma unroll
      for (int mb = 0; mb < MB_; ++mb)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row_base + 64 * mb + 8 * i;
          const int oh = oh0 + (row >> s.tw_log2),
                    ow = ow0 + (row & (tw - 1));
          pix[mb][i] = (oh < s.OH && ow < s.OW) ? oh * s.OW + ow : -1;
        }
      float* yc = reinterpret_cast<float*>(y) +
                  ((long long)img * s.Cout + co0 + cq) * ohw;
#pragma unroll
      for (int j = 0; j < BN_ / 8; ++j) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int co = co0 + 8 * j + cq + k;
          if (co >= s.Cout) continue;
          const float b = bias != nullptr ? __ldg(bias + co) : 0.f;
          float* yk = yc + (8 * j + k) * ohw;
#pragma unroll
          for (int mb = 0; mb < MB_; ++mb)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (pix[mb][i] < 0) continue;
              float v = acc[mb][4 * j + 2 * i + k];
              if (bias != nullptr) v = v + b;
              if (s.relu) v = relu_f(v);
              yk[pix[mb][i]] = v;
            }
        }
      }
      continue;
    }
    // bf16: stage the rounded tile [BM][BN] in shared memory, then write
    // 16-byte runs of channels per pixel (or per pooled pixel)
#pragma unroll
    for (int j = 0; j < BN_ / 8; ++j) {
      const int c = 8 * j + cq;
      const float b0 = (bias != nullptr && co0 + c < s.Cout)
                           ? __ldg(bias + co0 + c) : 0.f;
      const float b1 = (bias != nullptr && co0 + c + 1 < s.Cout)
                           ? __ldg(bias + co0 + c + 1) : 0.f;
#pragma unroll
      for (int mb = 0; mb < MB_; ++mb) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v0 = acc[mb][4 * j + 2 * i], v1 = acc[mb][4 * j + 2 * i + 1];
          if (bias != nullptr) {
            v0 = v0 + b0;
            v1 = v1 + b1;
          }
          if (s.relu) {
            v0 = relu_f(v0);
            v1 = relu_f(v1);
          }
          *reinterpret_cast<uint32_t*>(
              stage_out + (row_base + 64 * mb + 8 * i) * L::ST_LD + c) =
              pack_bf16(v0, v1);
        }
      }
    }
    consumers_sync();
    __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(y);
    const bool vec = (s.Cout & 7) == 0;
    constexpr int CG = BN_ / 8;               // 16-byte channel groups
    if (s.mode == OUT_BF16_NHWC) {
      for (int idx = ct + 128 * wg; idx < BM * CG;
         idx += 128 * D_CONSUMERS) {
        const int row = idx / CG, cg = idx - (idx / CG) * CG;
        const int oh = oh0 + (row >> s.tw_log2), ow = ow0 + (row & (tw - 1));
        const int co = co0 + 8 * cg;
        if (oh >= s.OH || ow >= s.OW || co >= s.Cout) continue;
        const uint16_t* src = stage_out + row * L::ST_LD + 8 * cg;
        const long long o = (((long long)img * s.OH + oh) * s.OW + ow) * s.Cout
                            + co;
        if (vec) {
          *reinterpret_cast<uint4*>(yb + o) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && co + e < s.Cout; ++e)
            reinterpret_cast<uint16_t*>(yb)[o + e] = src[e];
        }
      }
    } else {   // OUT_BF16_NHWC_POOL: (th/2) x (tw/2) pooled pixels
      const int POH = s.OH >> 1, POW = s.OW >> 1;
      const int ptw_log2 = s.tw_log2 - 1, ptw = tw >> 1;
      const int npix = BM / 4;
      for (int idx = ct + 128 * wg; idx < npix * CG;
         idx += 128 * D_CONSUMERS) {
        const int p = idx / CG, cg = idx - (idx / CG) * CG;
        const int py = p >> ptw_log2, px = p & (ptw - 1);
        const int poh = (oh0 >> 1) + py, pow_ = (ow0 >> 1) + px;
        const int co = co0 + 8 * cg;
        if (poh >= POH || pow_ >= POW || co >= s.Cout) continue;
        const int r00 = (2 * py) * tw + 2 * px;
        const uint16_t* s00 = stage_out + r00 * L::ST_LD + 8 * cg;
        const uint16_t* s01 = s00 + L::ST_LD;
        const uint16_t* s10 = s00 + tw * L::ST_LD;
        const uint16_t* s11 = s10 + L::ST_LD;
        const uint4 a = *reinterpret_cast<const uint4*>(s00);
        const uint4 b = *reinterpret_cast<const uint4*>(s01);
        const uint4 c = *reinterpret_cast<const uint4*>(s10);
        const uint4 d = *reinterpret_cast<const uint4*>(s11);
        uint4 m;
        m.x = max_bf16x2(a.x, b.x, c.x, d.x);
        m.y = max_bf16x2(a.y, b.y, c.y, d.y);
        m.z = max_bf16x2(a.z, b.z, c.z, d.z);
        m.w = max_bf16x2(a.w, b.w, c.w, d.w);
        const long long o =
            (((long long)img * POH + poh) * POW + pow_) * s.Cout + co;
        if (vec) {
          *reinterpret_cast<uint4*>(yb + o) = m;
        } else {
          const uint16_t* mv = reinterpret_cast<const uint16_t*>(&m);
          for (int e = 0; e < 8 && co + e < s.Cout; ++e)
            reinterpret_cast<uint16_t*>(yb)[o + e] = mv[e];
        }
      }
    }
    consumers_sync();   // the staging buffer is free for the next tile
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

int encode_fn(EncodeTiled* out) {
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
  *out = encode;
  return 0;
}

// bf16 tensor map, 128-byte swizzle, zero fill outside the tensor
int make_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  EncodeTiled encode;
  const int e = encode_fn(&encode);
  if (e) return e;
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            (cuuint32_t)rank, const_cast<void*>(base), dims,
                            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the M tile's width: the fewest computed pixels over (OH, OW), the wider
// tile on a tie; a function of OH and OW only
int pick_tw_log2(int OH, int OW, int bm) {
  int best = 3;
  long long best_area = -1;
  for (int l = 3; l <= 6; ++l) {
    const long long tw = 1 << l, th = bm >> l;
    const long long area = ((OW + tw - 1) / tw) * tw * ((OH + th - 1) / th) *
                           th;
    if (best_area < 0 || area <= best_area) {
      best = l;
      best_area = area;
    }
  }
  return best;
}

template <int BN_, int MB_>
int launch_dense(const CUtensorMap& xm, const CUtensorMap& wm,
                 const float* bias, void* y, DenseShape s,
                 cudaStream_t stream) {
  static int configured[64] = {0};
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(conv_dense_kernel<BN_, MB_>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DenseSmem<BN_, MB_>::ALLOC);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = 1;
  }
  const long long grid = s.tiles < sms[dev] ? s.tiles : sms[dev];
  conv_dense_kernel<BN_, MB_>
      <<<(unsigned)grid, D_THREADS, DenseSmem<BN_, MB_>::ALLOC, stream>>>(
          xm, wm, bias, y, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Generic route. x (N, C, H, W) fp32 NCHW, w (Cout, C/groups, KH, KW) fp32,
// bias (Cout) fp32 or null, all contiguous; y (N, Cout, OH, OW) fp32 NCHW,
// or with out_bf16 (N, OH, OW, Cout) bf16 NHWC. Pads are (top, left); the
// bottom and right pads are implied by OH and OW. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int conv_bf16_launch(const void* x, const void* w, const void* bias,
                                void* y, int N, int C, int H, int W, int Cout,
                                int KH, int KW, int OH, int OW, int sh, int sw,
                                int pt, int pl, int dh, int dw, int groups,
                                int relu, int out_bf16, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || OH <= 0 || OW <= 0 || sh <= 0 || sw <= 0 || dh <= 0 ||
      dw <= 0 || groups <= 0 || C % groups || Cout % groups)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = N; s.C = C; s.H = H; s.W = W; s.Cout = Cout; s.KH = KH; s.KW = KW;
  s.OH = OH; s.OW = OW; s.sh = sh; s.sw = sw; s.pt = pt; s.pl = pl;
  s.dh = dh; s.dw = dw; s.groups = groups; s.relu = relu ? 1 : 0;
  s.out_bf16 = out_bf16 ? 1 : 0;
  s.Cg = C / groups; s.Ng = Cout / groups; s.KHW = KH * KW;
  s.K = s.Cg * s.KHW;
  s.M = (long long)N * OH * OW;
  const long long mt = (s.M + BM - 1) / BM;
  if (mt > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((s.Ng + BN - 1) / BN), (unsigned)groups);
  conv_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, y, s);
  return (int)cudaGetLastError();
}

// Dense route. x (N, H, W, C) bf16 NHWC, wp (Cout, KH, KW, C) bf16, bias
// (Cout) fp32 or null, all contiguous; groups 1, stride 1, dilation 1, C a
// multiple of 16. mode 0: y (N, Cout, OH, OW) fp32 NCHW; 1: (N, OH, OW,
// Cout) bf16 NHWC; 2: the 2x2/2 max-pool of that, (N, OH/2, OW/2, Cout)
// bf16 NHWC. Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_bf16_dense_launch(const void* x, const void* wp,
                                      const void* bias, void* y, int N, int C,
                                      int H, int W, int Cout, int KH, int KW,
                                      int OH, int OW, int pt, int pl, int relu,
                                      int mode, void* stream) {
  if (N <= 0 || C <= 0 || C % 16 || H <= 0 || W <= 0 || Cout <= 0 ||
      KH <= 0 || KW <= 0 || OH <= 0 || OW <= 0 || pt < 0 || pl < 0 ||
      mode < 0 || mode > 2 || (mode == 2 && (OH < 2 || OW < 2)) ||
      N > 65535)
    return (int)cudaErrorInvalidValue;
  DenseShape s;
  s.N = N; s.C = C; s.H = H; s.W = W; s.Cout = Cout; s.KH = KH; s.KW = KW;
  s.OH = OH; s.OW = OW; s.pt = pt; s.pl = pl; s.relu = relu ? 1 : 0;
  s.mode = mode;
  // from the form: N = 64 takes two m64 blocks per warpgroup (256-pixel
  // tiles: half the weight loads per pixel, twice the products per stage)
  const int bn = Cout <= 64 ? 64 : 128, mb = bn == 64 ? 2 : 1;
  const int bm = 128 * mb;
  s.tw_log2 = pick_tw_log2(OH, OW, bm);
  const int tw = 1 << s.tw_log2, th = bm >> s.tw_log2;
  s.tiles_w = (OW + tw - 1) / tw;
  s.tiles_h = (OH + th - 1) / th;
  s.tiles_n = (Cout + bn - 1) / bn;
  s.chunks = (C + D_BK - 1) / D_BK;
  s.k_steps = KH * KW * s.chunks;
  s.tiles = (long long)N * s.tiles_h * s.tiles_w * s.tiles_n;

  CUtensorMap xm, wm;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                            (cuuint64_t)H * W * C * 2};
  const cuuint32_t xb[4] = {(cuuint32_t)D_BK, (cuuint32_t)tw, (cuuint32_t)th,
                            1};
  int e = make_map(&xm, x, 4, xd, xs, xb);
  if (e) return e;
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)(KH * KW),
                            (cuuint64_t)Cout};
  const cuuint64_t ws[2] = {(cuuint64_t)C * 2, (cuuint64_t)KH * KW * C * 2};
  const cuuint32_t wb[3] = {(cuuint32_t)D_BK, 1, (cuuint32_t)bn};
  e = make_map(&wm, wp, 3, wd, ws, wb);
  if (e) return e;
  return bn == 64 ? launch_dense<64, 2>(xm, wm, (const float*)bias, y, s,
                                        (cudaStream_t)stream)
                  : launch_dense<128, 1>(xm, wm, (const float*)bias, y, s,
                                         (cudaStream_t)stream);
}
