// fp32 convolution for Hopper (sm_90a): an implicit GEMM on the CUDA
// cores, in fp32 FFMA.
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
// the reference keeps fp32's). One route for every form - C = 1, strides,
// dilations, groups and depthwise, asymmetric ONNX pads, 1x1 and 3x3:
//   M = N * OH * OW output pixels, N = Cout / groups, K = (C / groups) * KH * KW
// with K in (ci, kh, kw) order. A CTA computes a 64-pixel x 64-channel
// tile of one group with 256 threads, each a 4 x 4 register micro-tile (4
// consecutive pixels x 4 consecutive channels). K runs in tiles of 16
// staged through shared memory, two buffers: the next tile's loads are in
// flight in registers while the current one is multiplied. The A tile is
// gathered from the fp32 NCHW input (the implicit im2col: consecutive
// threads read consecutive output pixels), the B tile from a (groups, K,
// Cout/groups) fp32 copy of the OIHW weight that the wrapper keeps beside
// the buffer (ops/conv_cuda.py kmajor_weight). The epilogue adds the bias,
// applies the ReLU (NaN passes, as torch.relu) and writes fp32 NCHW, 16
// bytes per store where OH * OW is a multiple of 4.
//
// Batch invariance, by design: every output element is ONE accumulator,
// one fmaf chain over k = 0, 1, ..., K-1 in that order (the k-tiles in
// order, the 16 steps of a tile in order), started at 0.0f. No split of
// K, no atomics, and no choice that follows N, H or W: the tile is the same
// constant 64 x 64 x 16 for every layer. Where K is not a multiple of 16
// the chain ends with fmaf(0, 0, acc), which leaves acc as it is (but
// for the sign of a zero). So an image's output is the same bits at any
// batch size and any offset in the batch. Built without --use_fast_math
// (_build.NVCC_FLAGS), which would let the compiler reassociate the sums.
//
// What bounds it on this card: operations. superpoint_pretrained's 12
// convs at 120x392, B=64 are 5.08e11 FLOP, 7.6 ms at the H100's 67 TFLOP/s
// of non-tensor fp32; their bytes (fp32 in, weights, out) ~1.1 ms at 3.35
// TB/s. The micro-tile reads 8 floats of shared memory (two 16-byte loads)
// for 16 FFMAs, so the FMA pipes, not shared memory, are the limit; the
// design does nothing more for speed (no wgmma: fp32 has no tensor-core
// form that keeps fp32 products; 3xTF32 split products are a later
// option if their numerics are shown equal).
//
// The kernel launches on the caller's stream, allocates nothing and can be
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
