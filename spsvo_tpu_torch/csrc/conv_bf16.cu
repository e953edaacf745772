// bf16 convolution for Hopper (sm_90a): an implicit GEMM on the tensor cores.
//
// Replaces an XLA op, not a Pallas kernel: the bf16 branch of
// spsvo_tpu/models/onnx_import.py::_conv (lines 249-269),
// lax.conv_general_dilated on bf16 operands with
// preferred_element_type=float32. That is exact bf16 products summed in
// fp32 with an fp32 result, which is what a bf16 mma with fp32 accumulators
// computes:
//   y[n, co, oh, ow] = b[co] + sum over the group's (ci, kh, kw) of
//                      bf16(x[n, ci, ih, iw]) * bf16(w[co, ci, kh, kw])
//   ih = oh * sh - pad_top + kh * dh,  iw = ow * sw - pad_left + kw * dw
// (zero outside the image), then ReLU where the graph fused one.
// x is fp32 NCHW and w fp32 OIHW exactly as the port's GraphModule holds
// them; both are rounded to bf16 (round to nearest even, as
// Tensor.to(torch.bfloat16)) while they are loaded, so no rounded copy and
// no packed weight exists that a load_state_dict could leave stale.
//
// GEMM per group g: M = N*OH*OW output pixels, N = Cout/g channels,
// K = (Cin/g)*KH*KW in (ci, kh, kw) order, which is the OIHW weight row.
// A CTA of 8 warps computes a 128 x 64 output tile; a k-tile of 32 is
// staged in shared memory as bf16 (two buffers: the next tile's global
// loads are in flight in registers while the current one is multiplied)
// and multiplied with mma.sync.m16n8k16 bf16 -> fp32, each warp 32 x 32.
// The epilogue adds the bias, applies the ReLU, stages the tile in shared
// memory and writes it along the pixels, so each warp's stores are
// contiguous. An M tile may straddle two images. K is zero-padded to the
// k-tile, so Cin = 1 (K = 9) works; depthwise and grouped convs run one
// GEMM per group on gridDim.z (right, not fast: a 64-wide N tile holds one
// channel).
//
// Batch invariance, by design: every output element is summed over K in
// one fixed order (k-tiles in order, within a tile the two k16 steps in
// order, in a fixed accumulator), with no split-K and no atomics; the tile
// configuration is one constant, never chosen from N, H or W; where an
// element lies in its tile changes nothing of its sum. So an image's output
// is the same bits at any batch size and at any offset in the batch.
//
// Bound at the trunk's shapes. superpoint_pretrained's 12 convs over 64
// images at 120x392 are 511 GFLOP: 0.52 ms at the bf16 tensor-core peak
// (989 TFLOP/s). They move 3.83 GB (fp32 inputs and weights read once,
// fp32 outputs written once): 1.14 ms at 3.35 TB/s, the larger bound. Per
// layer the bytes bound all but the 3x3 heads (128 -> 256 channels at
// 1/8 resolution), whose operations do; chip_smoke.py phase 4b computes
// both from the shapes. This first version spends its time on the scalar
// fp32 gathers of the implicit im2col (each input read 9 times by a 3x3
// conv), not on the MMAs: halo tiles in shared memory, wgmma and TMA are
// later work.
//
// It launches on the caller's stream, allocates nothing and can be
// captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
constexpr int C_BYTES = BN * CS_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

struct Shape {
  int N, C, H, W, Cout, KH, KW, OH, OW;
  int sh, sw, pt, pl, dh, dw, groups, relu;
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
                 const float* __restrict__ bias, float* __restrict__ y,
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
    if (tid < BM)
      out_base[tid] = m_ok ? (n_img * s.Cout + (long long)g * s.Ng) * OHW + pix
                           : -1;
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

  // epilogue: bias, ReLU, stage [BN][BM] in shared memory, write along pixels
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
          if (s.relu) v = (v > 0.f || v != v) ? v : 0.f;   // NaN passes
          Cs[col * CS_LD + wm + mi * 16 + gid + 8 * h] = v;
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int nl = idx / BM, ml = idx - (idx / BM) * BM;
    const long long ob = out_base[ml];
    if (ob >= 0 && n0 + nl < s.Ng)
      y[ob + (long long)(n0 + nl) * OHW] = Cs[nl * CS_LD + ml];
  }
}

}  // namespace

// x (N, C, H, W), w (Cout, C/groups, KH, KW), bias (Cout) or null, y (N,
// Cout, OH, OW), all fp32 and contiguous; pads are (top, left); the bottom
// and right pads are implied by OH and OW. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int conv_bf16_launch(const void* x, const void* w, const void* bias,
                                void* y, int N, int C, int H, int W, int Cout,
                                int KH, int KW, int OH, int OW, int sh, int sw,
                                int pt, int pl, int dh, int dw, int groups,
                                int relu, void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || Cout <= 0 || KH <= 0 ||
      KW <= 0 || OH <= 0 || OW <= 0 || sh <= 0 || sw <= 0 || dh <= 0 ||
      dw <= 0 || groups <= 0 || C % groups || Cout % groups)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = N; s.C = C; s.H = H; s.W = W; s.Cout = Cout; s.KH = KH; s.KW = KW;
  s.OH = OH; s.OW = OW; s.sh = sh; s.sw = sw; s.pt = pt; s.pl = pl;
  s.dh = dh; s.dw = dw; s.groups = groups; s.relu = relu ? 1 : 0;
  s.Cg = C / groups; s.Ng = Cout / groups; s.KHW = KH * KW;
  s.K = s.Cg * s.KHW;
  s.M = (long long)N * OH * OW;
  const long long mt = (s.M + BM - 1) / BM;
  if (mt > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((s.Ng + BN - 1) / BN), (unsigned)groups);
  conv_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)y, s);
  return (int)cudaGetLastError();
}
