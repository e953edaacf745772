// fp32 convolution for Hopper (sm_90a): an implicit GEMM on the CUDA
// cores, in fp32 FFMA, in two routes that compute the same bits.
//
// Replaces an XLA op, not a Pallas kernel: the fp32 branch of
// spsvo_tpu/models/onnx_import.py::_conv (lines 249-269),
// lax.conv_general_dilated on fp32 operands with the matmul precision
// pinned to float32 (spsvo_tpu/__init__.py). That is fp32 products summed
// in fp32 with an fp32 result:
//   y[n, co, oh, ow] = b[co] + sum over the group's (ci, kh, kw) of
//                      x[n, ci, ih, iw] * w[co, ci, kh, kw]
//   ih = oh * sh - pad_top + kh * dh,  iw = ow * sw - pad_left + kw * dw
// (zero outside the image), then ReLU where the graph fused one
// (models/graph.py fuse_conv_relu).
//
// True fp32: no TF32 and no tensor cores (TF32 keeps ~3 decimal digits;
// the reference keeps fp32's). As a GEMM:
//   M = N * OH * OW output pixels, N = Cout / groups, K = (C / groups) * KH * KW
// with K in (ci, kh, kw) order. A is gathered from the fp32 NCHW input
// (the implicit im2col), B is a (groups, K, Cout/groups) fp32 copy of the
// OIHW weight that the wrapper keeps beside the buffer
// (ops/conv_cuda.py kmajor_weight). The epilogue adds the bias, applies
// the ReLU (NaN passes, as torch.relu) and writes fp32 NCHW, 16 bytes per
// store where OH * OW is a multiple of 4.
//
// Generic route (conv_fp32_launch), every form: C = 1, strides,
// dilations, groups and depthwise, asymmetric ONNX pads, 1x1 and 3x3. A
// CTA computes a 64-pixel x 64-channel tile of one group with 256
// threads, each a 4 x 4 register micro-tile (4 consecutive pixels x 4
// consecutive channels). K runs in tiles of 16 staged through shared
// memory, two buffers: the next tile's loads are in flight in registers
// while the current one is multiplied.
//
// Dense route (conv_fp32_dense_launch): groups 1, stride 1, dilation 1, a
// 1x1 or 3x3 kernel and C a multiple of 16 (ops/conv_cuda.py route, the
// rule kernel 3's routes follow too): every conv of the trained trunks
// but the first. Its CTA tile is one of three (launch_tile), which the
// wrapper picks from M and Cout (ops/conv_cuda.py fp32_tile).
//
// The same bits from both routes, at any batch size and any offset in the
// batch: every output element is ONE accumulator, one fmaf chain over k =
// 0, 1, ..., K-1 in that order (the k-tiles in order, the steps of a tile
// in order), started at 0.0f, then the bias added and the ReLU. No split
// of K, no atomics, and nothing in that chain follows the tile, the route
// or N, H, W: a tile only says which thread runs which chains. Both
// routes read a zero (+0.0f) where a tap falls outside the image. Where
// K is not a multiple of 16 the generic chain ends with fmaf(0, 0, acc);
// the dense forms have K = 9C or C with C % 16 == 0, so it never does
// there, and the two routes run the same fmafs on the same operands, sign
// of zero included. Built without --use_fast_math (_build.NVCC_FLAGS),
// which would let the compiler reassociate the sums.
//
// What bounds it on this card: operations. superpoint_pretrained's 12
// convs at 120x392, B=64 are 5.08e11 FLOP, 7.6 ms at the H100's 67 TFLOP/s
// of non-tensor fp32; their bytes (fp32 in, weights, out) ~1.1 ms at 3.35
// TB/s. The generic route reaches a third of that peak on the 3x3 layers,
// and not for want of FMA pipes: each k step of its 4 x 4 micro-tile
// reads 8 floats of shared memory (two LDS.128) for 16 FFMAs, and in a
// warp (16 x 2 threads) the A loads span 16 distinct float4 and the B
// loads 2, three shared-memory wavefronts per 16 warp-FFMAs: ~75% of the
// SM's shared bandwidth with the FMA pipes at peak. The two loads take 2
// of every 18 issue slots, and its loader (an integer divide and modulo
// per k-tile, per-element bounds predicates, 8 loads through registers, 8
// scalar shared stores) some 60-100 instructions per 256 FFMAs; on Hopper
// an FFMA warp-instruction fills a sub-partition's issue slot, so every
// other instruction costs FMA throughput. The dense route answers each:
// - an 8 x 8 register tile per thread (R = 8) on the large layers: two
//   4-pixel halves BM/2 apart and two 4-channel halves BN/2 apart, the
//   classic SGEMM layout, with a warp 8 threads along the pixels and 4
//   along the channels, so each of a k step's 4 LDS.128 is one wavefront:
//   4 loads and 4 wavefronts for 64 FFMAs. The next step's fragments load
//   into a second register set while this step's FFMAs run, within 128
//   registers a thread (__launch_bounds__): four 128-thread CTAs an SM.
// - a cp.async ring of 3-8 k-tiles, one __syncthreads per k-tile. The A
//   tile is gathered 4 bytes per copy, consecutive threads on consecutive
//   output pixels of one (ci, kh, kw) (contiguous in NCHW), the padding
//   zero-filled by the copy's ignore-src operand. A k-tile is 2 or 4 input
//   channels x 9 taps (3x3) or 16 channels (1x1), so each copy's address
//   is the thread's pixel pointer plus a channel stride and a tap offset
//   known at compile time, and its tap validity one bit of a mask made
//   once: no divide and no select in the main loop. The B tile is
//   copied 16 bytes at a time (cp.async.cg) where Cout % 4 == 0, else 4.
// - a tile to fit the layer: 128 x 64 at 8 x 8 on the large layers,
//   64 x 32 and 32 x 32 at 4 x 4 on the small ones (the
//   1/8-resolution layers of two images), where an 8 x 8 tile leaves too
//   few warps to hide the loads' latency, each CTA too few others on its
//   SM to switch to.
//
// Both launch on the caller's stream, allocate nothing and can be
// captured in a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // output pixels per CTA
constexpr int BN = 64;           // output channels (of one group) per CTA
constexpr int BK = 16;           // k-tile
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each

struct Shape {
  int N, C, H, W, Cout, OH, OW;
  int KH, KW, sh, sw, pt, pl, dh, dw, relu;
  int Cg, Ng, K, KHW;
  long long M, OHW;
};

__device__ __forceinline__ float relu_f(float v) {
  return (v > 0.f || v != v) ? v : 0.f;   // NaN passes, as torch.relu
}

__global__ void __launch_bounds__(THREADS)
conv_fp32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                 const float* __restrict__ bias, float* __restrict__ y,
                 const Shape s) {
  __shared__ __align__(16) float As[2][BK][BM];   // [k][pixel]
  __shared__ __align__(16) float Bs[2][BK][BN];   // [k][channel]

  const int tid = threadIdx.x;
  const int tm = tid & 15, tn = tid >> 4;   // micro-tile: pixels 4tm.., channels 4tn..
  const int g = blockIdx.z;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int HW = s.H * s.W;

  // A loader: one output pixel (a_m) and 4 consecutive k of each tile
  const int a_m = tid & (BM - 1), a_k = (tid / BM) * 4;
  const long long m = m0 + a_m;
  const bool m_ok = m < s.M;
  int ih0 = 0, iw0 = 0;
  const float* x_img = x;
  {
    const long long mm = m_ok ? m : 0;
    const long long n_img = mm / s.OHW;
    const int pix = (int)(mm - n_img * s.OHW);
    const int oh = pix / s.OW, ow = pix - oh * s.OW;
    ih0 = oh * s.sh - s.pt;
    iw0 = ow * s.sw - s.pl;
    x_img = x + (n_img * s.C + (long long)g * s.Cg) * HW;
  }
  // B loader: one output channel (b_n) and 4 consecutive k of each tile
  const int b_n = tid & (BN - 1), b_k = (tid / BN) * 4;
  const bool n_ok = n0 + b_n < s.Ng;
  const float* w_col = wt + (long long)g * s.K * s.Ng + n0 + b_n;

  float fa[4], fb[4];
  auto load = [&](int kt) {
    const int k = kt * BK + a_k;
    int ci = k / s.KHW;
    const int r = k - ci * s.KHW;
    int kh = r / s.KW;
    int kw = r - kh * s.KW;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
    for (int j = 0; j < 4; ++j)
      fb[j] = (n_ok && kb + j < s.K)
                  ? __ldg(w_col + (long long)(kb + j) * s.Ng) : 0.f;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      As[buf][a_k + j][a_m] = fa[j];
      Bs[buf][b_k + j][b_n] = fb[j];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int KT = (s.K + BK - 1) / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load(kt + 1);      // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[cur][kk][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][kk][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < KT) store(cur ^ 1);
    __syncthreads();
  }

  // epilogue: bias, ReLU, fp32 NCHW. The 4 pixels 4tm.. lie in one image
  // and on a 16-byte boundary of y when OH * OW is a multiple of 4.
  const long long p0 = m0 + tm * 4;
  if (p0 >= s.M) return;
  const long long img0 = p0 / s.OHW;
  const long long pix0 = p0 - img0 * s.OHW;
  const bool vec = (s.OHW & 3) == 0 && p0 + 3 < s.M;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tn * 4 + j;
    if (n >= s.Ng) break;
    const int co = g * s.Ng + n;
    const float b = bias != nullptr ? __ldg(bias + co) : 0.f;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[i][j];
      if (bias != nullptr) v[i] = v[i] + b;
      if (s.relu) v[i] = relu_f(v[i]);
    }
    if (vec) {
      *reinterpret_cast<float4*>(y + (img0 * s.Cout + co) * s.OHW + pix0) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = p0 + i;
        if (p >= s.M) break;
        const long long img = p / s.OHW;
        y[(img * s.Cout + co) * s.OHW + (p - img * s.OHW)] = v[i];
      }
    }
  }
}


// ---- dense route ----

struct DenseShape {
  int C, H, W, Cout, OH, OW, pt, pl, relu, b_vec;
  int HW, K;
  long long OHW, M;
};

// One of the dense route's tiles: BM pixels x BN channels per CTA, R x R
// outputs per thread (R = 8: two 4-wide halves on each side), a KS x KS
// kernel, CPT input channels (CPT * KS * KS values of k) per k-tile and
// STAGES k-tiles in flight.
template <int BM, int BN, int R, int KS, int CPT, int STAGES>
struct DenseTile {
  static constexpr int THREADS = (BM / R) * (BN / R);
  static constexpr int TAPS = KS * KS;
  static constexpr int BK = CPT * TAPS;          // k per tile
  static constexpr int KG = THREADS / BM;        // A loader threads per pixel
  static constexpr int CPG = CPT / KG;           // ... channels each
  static constexpr int SMEM = STAGES * BK * (BM + BN) * 4;
  static_assert(THREADS % BM == 0 && CPT % KG == 0, "A loader split");
  static_assert(R == 4 || R == 8, "4 or 8 outputs a side");
  static_assert(THREADS % BN == 0 && THREADS % (BN / 4) == 0, "B loader");
};

// cp.async of 4 (or 16) bytes into shared memory, zeros where !ok (the
// ignore-src operand: the source is then not read)
__device__ __forceinline__ void cp_async4(unsigned dst, const float* src,
                                          bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %2, 0;\n"
      " cp.async.ca.shared.global [%0], [%1], 4, p;\n}\n" ::"r"(dst),
      "l"(src), "r"((unsigned)ok)
      : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned dst, const float* src,
                                           bool ok) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %2, 0;\n"
      " cp.async.cg.shared.global [%0], [%1], 16, p;\n}\n" ::"r"(dst),
      "l"(src), "r"((unsigned)ok)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void lds4(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <int BM, int BN, int R, int KS, int CPT, int STAGES>
__global__ void __launch_bounds__(
    DenseTile<BM, BN, R, KS, CPT, STAGES>::THREADS,
    512 / DenseTile<BM, BN, R, KS, CPT, STAGES>::THREADS)
conv_fp32_dense_kernel(const float* __restrict__ x,
                       const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ y,
                       const DenseShape s) {
  using T = DenseTile<BM, BN, R, KS, CPT, STAGES>;
  constexpr int BK = T::BK;
  constexpr int TM = BM / R, TN = BN / R;     // threads along pixels, channels
  constexpr int LM = TM < 8 ? TM : 8;         // a warp's lanes along pixels
  constexpr int LN = 32 / LM;                 // ... along channels
  constexpr int WM = TM / LM;                 // warps along pixels
  constexpr int H4 = R / 4;                   // 4-wide runs on each side
  constexpr int AS = BK * BM, BS = BK * BN;   // floats of a stage's tiles
  static_assert(TM % LM == 0 && TN % LN == 0, "warp layout");
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                     // [STAGES][BK][BM]
  float* const Bs = smem + STAGES * AS;       // [STAGES][BK][BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = (warp % WM) * LM + lane % LM;
  const int tn = (warp / WM) * LN + lane / LM;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: pixel a_m of the tile; channels a_g * CPG .. of each k-tile,
  // every tap of each. mask bit kh * KS + kw: that tap lies in the image.
  // a_src is the pixel's tap (0, 0) in the thread's first channel of the
  // next k-tile (outside the image where a tap is: never read there).
  const int a_m = tid % BM, a_g = tid / BM;
  unsigned mask = 0;
  const float* a_src = x;
  {
    const long long m = m0 + a_m;
    if (m < s.M) {
      const long long img = m / s.OHW;
      const int pix = (int)(m - img * s.OHW);
      const int oh = pix / s.OW, ow = pix - oh * s.OW;
      const int ih0 = oh - s.pt, iw0 = ow - s.pl;
#pragma unroll
      for (int kh = 0; kh < KS; ++kh)
#pragma unroll
        for (int kw = 0; kw < KS; ++kw)
          if ((unsigned)(ih0 + kh) < (unsigned)s.H &&
              (unsigned)(iw0 + kw) < (unsigned)s.W)
            mask |= 1u << (kh * KS + kw);
      a_src = x + img * s.C * s.HW + a_g * T::CPG * s.HW + ih0 * s.W + iw0;
    }
  }
  const unsigned sm_base = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned a_sm = sm_base + 4u * (a_g * T::CPG * T::TAPS * BM + a_m);
  const long long a_step = (long long)CPT * s.HW;

  // B loader: rows k0 .. k0 + BK - 1 of the (K, Cout) weight, columns
  // n0 .. n0 + BN - 1 (zeros past Cout). 16-byte copies: each thread's
  // column is the same in every copy; 4-byte copies where Cout % 4 != 0.
  constexpr int NV = BS / 4, NS = BS;
  constexpr int IV = (NV + T::THREADS - 1) / T::THREADS;
  constexpr int IS = (NS + T::THREADS - 1) / T::THREADS;
  const int bv_row = tid / (BN / 4), bv_col = (tid % (BN / 4)) * 4;
  const int bs_row = tid / BN, bs_col = tid % BN;
  const bool b_ok = n0 + (s.b_vec ? bv_col : bs_col) < s.Cout;
  const float* b_src =
      wt + n0 + (s.b_vec ? (long long)bv_row * s.Cout + bv_col
                         : (long long)bs_row * s.Cout + bs_col);
  const unsigned b_sm = sm_base + 4u * (STAGES * AS +
                                        (s.b_vec ? bv_row * BN + bv_col
                                                 : bs_row * BN + bs_col));
  const long long b_step = (long long)BK * s.Cout;

  auto load = [&](int slot) {
    const unsigned ad = a_sm + 4u * slot * AS;
#pragma unroll
    for (int c = 0; c < T::CPG; ++c)
#pragma unroll
      for (int t = 0; t < T::TAPS; ++t)
        cp_async4(ad + 4u * (c * T::TAPS + t) * BM,
                  a_src + c * s.HW + (t / KS) * s.W + t % KS,
                  (mask >> t) & 1u);
    a_src += a_step;
    const unsigned bd = b_sm + 4u * slot * BS;
    if (s.b_vec) {
#pragma unroll
      for (int i = 0; i < IV; ++i)
        if (NV % T::THREADS == 0 || tid + i * T::THREADS < NV)
          cp_async16(bd + 4u * i * (T::THREADS / (BN / 4)) * BN,
                     b_src + (long long)i * (T::THREADS / (BN / 4)) * s.Cout,
                     b_ok);
    } else {
#pragma unroll
      for (int i = 0; i < IS; ++i)
        if (NS % T::THREADS == 0 || tid + i * T::THREADS < NS)
          cp_async4(bd + 4u * i * (T::THREADS / BN) * BN,
                    b_src + (long long)i * (T::THREADS / BN) * s.Cout, b_ok);
    }
    b_src += b_step;
  };

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.f;

  const int KT = s.K / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load(st);
    cp_async_commit();
  }
  int slot = 0, next_slot = STAGES - 1;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of k-tile kt
    __syncthreads();               // everyone's; and k-tile kt-1 is read
    if (kt + STAGES - 1 < KT) load(next_slot);
    cp_async_commit();
    const float* const a_s = As + slot * AS + tm * 4;
    const float* const b_s = Bs + slot * BS + tn * 4;
    // two register sets: step kk + 1's fragments load during step kk's
    // FFMAs
    float a[2][R], b[2][R];
    auto frag = [&](int set, int kk) {
#pragma unroll
      for (int h = 0; h < H4; ++h) {
        lds4(a[set] + 4 * h, a_s + kk * BM + h * (BM / 2));
        lds4(b[set] + 4 * h, b_s + kk * BN + h * (BN / 2));
      }
    };
    frag(0, 0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const int cur = kk & 1;
      if (kk + 1 < BK) frag(cur ^ 1, kk + 1);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j)
          acc[i][j] = fmaf(a[cur][i], b[cur][j], acc[i][j]);
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    next_slot = next_slot + 1 == STAGES ? 0 : next_slot + 1;
  }
  cp_async_wait<0>();   // only empty groups are left; none outlives the CTA

  // epilogue, the generic route's: bias, ReLU, fp32 NCHW. Each 4-pixel
  // run starts at a multiple of 4, so it lies in one image and on a
  // 16-byte boundary of y when OH * OW is a multiple of 4.
#pragma unroll
  for (int hm = 0; hm < H4; ++hm) {
    const long long p0 = m0 + hm * (BM / 2) + tm * 4;
    if (p0 >= s.M) continue;
    const long long img0 = p0 / s.OHW;
    const long long pix0 = p0 - img0 * s.OHW;
    const bool vec = (s.OHW & 3) == 0 && p0 + 3 < s.M;
#pragma unroll
    for (int hn = 0; hn < H4; ++hn)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + hn * (BN / 2) + tn * 4 + j;
        if (co >= s.Cout) continue;
        const float b = bias != nullptr ? __ldg(bias + co) : 0.f;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[hm * 4 + i][hn * 4 + j];
          if (bias != nullptr) v[i] = v[i] + b;
          if (s.relu) v[i] = relu_f(v[i]);
        }
        if (vec) {
          *reinterpret_cast<float4*>(y + (img0 * s.Cout + co) * s.OHW +
                                     pix0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const long long p = p0 + i;
            if (p >= s.M) break;
            const long long img = p / s.OHW;
            y[(img * s.Cout + co) * s.OHW + (p - img * s.OHW)] = v[i];
          }
        }
      }
  }
}

template <int BM, int BN, int R, int KS, int CPT, int STAGES>
int launch_dense(const float* x, const float* wt, const float* bias,
                 float* y, const DenseShape& s, cudaStream_t stream) {
  using T = DenseTile<BM, BN, R, KS, CPT, STAGES>;
  static int configured[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(
        conv_fp32_dense_kernel<BM, BN, R, KS, CPT, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = 1;
  }
  const long long mt = (s.M + BM - 1) / BM;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((s.Cout + BN - 1) / BN));
  conv_fp32_dense_kernel<BM, BN, R, KS, CPT, STAGES>
      <<<grid, T::THREADS, T::SMEM, stream>>>(x, wt, bias, y, s);
  return (int)cudaGetLastError();
}

// The tiles by the index the wrapper passes (ops/conv_cuda.py FP32_TILES,
// fp32_tile): 128 x 64 with 8 x 8 per thread for the large layers, 64 x 32
// and 32 x 32 with 4 x 4 for the small ones, which need more warps in
// flight than an 8 x 8 tile leaves them. A k-tile of a 3x3 form holds 2
// or 4 input channels (18 or 36 values of k), of a 1x1 form 16; the stage
// counts fill the shared memory the four or eight CTAs an SM holds leave.
template <int KS>
int launch_tile(int tile, const float* x, const float* wt, const float* bias,
                float* y, const DenseShape& s, cudaStream_t st) {
  constexpr int C2 = KS == 3 ? 2 : 16, C4 = KS == 3 ? 4 : 16;
  switch (tile) {
    case 0: return launch_dense<128, 64, 8, KS, C2, 3>(x, wt, bias, y, s, st);
    case 1: return launch_dense<64, 32, 4, KS, C4, 4>(x, wt, bias, y, s, st);
    case 2: return launch_dense<32, 32, 4, KS, C2, 8>(x, wt, bias, y, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (N, C, H, W) fp32 NCHW, wt (groups, K, Cout/groups) fp32 with K =
// (C/groups)*KH*KW in (ci, kh, kw) order, bias (Cout) fp32 or null, all
// contiguous; y (N, Cout, OH, OW) fp32 NCHW. Pads are (top, left); the
// bottom and right pads are implied by OH and OW. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int conv_fp32_launch(const void* x, const void* wt,
                                const void* bias, void* y, int N, int C,
                                int H, int W, int Cout, int KH, int KW,
                                int OH, int OW, int sh, int sw, int pt, int pl,
                                int dh, int dw, int groups, int relu,
                                void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || OH <= 0 || OW <= 0 || sh <= 0 || sw <= 0 || dh <= 0 ||
      dw <= 0 || pt < 0 || pl < 0 || groups <= 0 || C % groups ||
      Cout % groups)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = N; s.C = C; s.H = H; s.W = W; s.Cout = Cout; s.OH = OH; s.OW = OW;
  s.KH = KH; s.KW = KW; s.sh = sh; s.sw = sw; s.pt = pt; s.pl = pl;
  s.dh = dh; s.dw = dw; s.relu = relu ? 1 : 0;
  s.Cg = C / groups; s.Ng = Cout / groups; s.KHW = KH * KW;
  s.K = s.Cg * s.KHW;
  s.OHW = (long long)OH * OW;
  s.M = (long long)N * s.OHW;
  const long long mt = (s.M + BM - 1) / BM;
  if (mt > 0x7fffffffLL || groups > 65535 || (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((s.Ng + BN - 1) / BN), (unsigned)groups);
  conv_fp32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wt, (const float*)bias, (float*)y, s);
  return (int)cudaGetLastError();
}

// Dense route. x (N, C, H, W) fp32 NCHW with C a multiple of 16, wt (1, K,
// Cout) fp32 with K = C*KH*KW in (ci, kh, kw) order, bias (Cout) fp32 or
// null, all contiguous; groups 1, stride 1, dilation 1, KH = KW = 1 or 3;
// y (N, Cout, OH, OW) fp32 NCHW. Pads are (top, left); the bottom and
// right pads are implied by OH and OW. tile: an index of the wrapper's
// FP32_TILES (0: 128 x 64, 1: 64 x 32, 2: 32 x 32), any of which gives the
// same bits. Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_fp32_dense_launch(const void* x, const void* wt,
                                      const void* bias, void* y, int N, int C,
                                      int H, int W, int Cout, int KH, int KW,
                                      int OH, int OW, int pt, int pl, int relu,
                                      int tile, void* stream) {
  if (N <= 0 || C <= 0 || C % 16 || H <= 0 || W <= 0 || Cout <= 0 ||
      KH != KW || (KH != 1 && KH != 3) || OH <= 0 || OW <= 0 || pt < 0 ||
      pl < 0 || (long long)C * H * W > 0x7fffffffLL || Cout > 65535 * 32)
    return (int)cudaErrorInvalidValue;
  DenseShape s;
  s.C = C; s.H = H; s.W = W; s.Cout = Cout; s.OH = OH; s.OW = OW;
  s.pt = pt; s.pl = pl; s.relu = relu ? 1 : 0;
  s.b_vec = Cout % 4 == 0 && ((uintptr_t)wt & 15) == 0;
  s.HW = H * W;
  s.K = C * KH * KW;
  s.OHW = (long long)OH * OW;
  s.M = (long long)N * s.OHW;
  const float* xf = (const float*)x;
  const float* wf = (const float*)wt;
  const float* bf = (const float*)bias;
  float* yf = (float*)y;
  cudaStream_t st = (cudaStream_t)stream;
  return KH == 3 ? launch_tile<3>(tile, xf, wf, bf, yf, s, st)
                 : launch_tile<1>(tile, xf, wf, bf, yf, s, st);
}
