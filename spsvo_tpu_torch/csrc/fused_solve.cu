// Fused whole-solver kernel for Hopper (sm_90a): RANSAC scoring -> winner
// -> refit -> polish -> gates -> LM (-> optional GLS LM) in ONE launch per
// call, one thread-block cluster per frame.
//
// Replaces the TPU kernel spsvo_tpu/ops/solver_pallas.py::_solve_kernel
// (wrapper fused_solve). Inputs per frame f:
//   pts  (F, 16, Lp) fp32 rows: Xc(3) Xp(3) uv_pl(2) uv_pr(2) uv_cl(2)
//        uv_cr(2) chain(1) lane_weight(1)       (solver_cuda.pack_points)
//   hyp  (F, S, 12) fp32 [R row-major | t]     (precompute_hypotheses)
//   scal (F, 32) fp32 [q_pred(4) t_pred(3) frame_count(1) P_l(12) P_r(12)]
// Outputs: out (F, 20) fp32 = q(4) t(3) q_pred'(4) t_pred'(3) num_inliers
// pnp_success accel_anomaly lm_improved prior_winner num_chain, and the
// final inlier row inl (F, Lp) fp32.
//
// What bounds it on this card: neither bytes nor FLOPs. At S=256, L=128
// the work is ~1 MFLOP of scoring and ~3-4 MFLOP of LM (polish, LM, GLS:
// 18 iterations over 128 lanes and up to 4 factors), ~0.07 us at the fp32
// peak, on ~21 KB of inputs. Its time is the latency of a long chain of
// dependent steps: the scoring pass, then ~60 lane reductions with a scalar
// tail (power iteration, Shepperd, 6x6 Cholesky, boxplus, gates) between
// them. The design cuts that chain:
//  - Scoring, the one wide step, is spread over a cluster of CL=8 CTAs on
//    8 SMs: CTA r scores hypotheses [S*r/8, S*(r+1)/8); each warp takes a
//    hypothesis at a time with the lanes split across its 32 threads and
//    counts inliers with __ballot_sync/__popc. Counts are integers, so the
//    first-max argmax (count desc, index asc: warps, then CTAs in rank
//    order through distributed shared memory) does not depend on order.
//  - Everything after the winner runs on warpgroup 0 of the cluster's
//    first CTA (128 threads, lane l on thread l % 128; the other warps and
//    CTAs have exited). A lane sum is a warp butterfly, then the 4 warps'
//    partials through a double-buffered shared slot and ONE named barrier
//    (bar.sync 1, 128), added in warp order: no __syncthreads and no second
//    barrier in the chain. Lane masks are owned by their thread, so
//    updating them needs no barrier at all.
//  - One lane pass per LM iteration: the pass that evaluates the Huber
//    cost at a candidate pose also accumulates the normal equations there,
//    and both go through one 28-wide sum. If the step is accepted they are
//    the next iteration's normal equations; if it is rejected the previous
//    ones still hold (only lambda changes). Same values, half the passes.
//  - Every small loop (factors, 6x6 Cholesky, 28 sums) is unrolled with
//    compile-time indices, so the scalar tail and the per-lane Jacobians
//    stay in registers; the factors are branch-free so they interleave,
//    and a Jacobian takes one reciprocal of the depth, not six divides.
//    Wide sums use a transposing warp butterfly (31 shuffles for 28 values).
//  - The scalar tail runs redundantly and identically in all 128 threads
//    on the broadcast sums, in IEEE fp32 (sqrtf/sinf/cosf, no fast math);
//    the Cholesky divides once per pivot and multiplies by the reciprocal.
// Every sum has a fixed order, so results are bitwise identical from run
// to run. F frames are F independent clusters (grid F*8).
//
// A second entry, fused_scan_kernel (fused_scan_launch), runs the online
// hybrid's whole landmark scan in one launch, each pair's solve the same
// code on one resident cluster; a third, fused_frame_kernel
// (fused_frame_launch), one frame's whole landmark solve with its
// hypotheses drawn inside: see their notes below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;            // CTAs per frame (one cluster)
constexpr int NT = 256;          // threads per CTA (scoring)
constexpr int NWARP = NT / 32;
constexpr int WG = 128;          // the solve chain: one warpgroup
constexpr int MAX_L = 512;
constexpr int MAX_RED = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int S, Lp;
  float thr2, reproj, delta, min_inliers, dt, max_acc, ignore_fc;
  int degree, lm_iters, polish_iters, weighted;
};

struct Smem {
  float pts[16][MAX_L];
  float inl[MAX_L];       // current inlier row (lane l owned by thread l%WG)
  float cand[MAX_L];      // candidate inlier row
  float4 red[2][MAX_RED]; // per-warp partials of a warpgroup sum
  int wc[NWARP], ws[NWARP];   // per-warp scoring winners
  int cc[CL], cs[CL];         // per-CTA winners (written into rank 0)
};

// ---- warpgroup-wide fixed-order sums ---------------------------------------

struct Chain {
  Smem& sh;
  const Params& p;
  int ph;                 // which half of sh.red the next sum uses
};

__device__ __forceinline__ void wg_bar() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// Every thread of the warpgroup gets the same sums. Within a warp, fewer
// than 16 values take a butterfly each; more take a transposing butterfly (at
// offset h a lane keeps one half of its values and trades the other, so 32
// values cost 31 shuffles, not 160, and lane i ends with value i). Double
// buffering makes one barrier enough: a thread writes a half of sh.red
// again only after the next sum's barrier, which every reader of that half
// has passed. Every value is summed in a fixed order.
// One level of the transposing butterfly: values [0, 2H) -> [0, H).
template <int H>
__device__ __forceinline__ void trade_half(float (&w)[32], int lane) {
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? w[i] : w[i + H];
    const float keep = up ? w[i + H] : w[i];
    w[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
}

template <int N>
__device__ __forceinline__ void wg_sum(float (&v)[N], Chain& ch) {
  static_assert(N <= MAX_RED, "wg_sum: too many values");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* red = ch.sh.red[ch.ph];
  ch.ph ^= 1;
  if (N < 16) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[i] += __shfl_xor_sync(FULL, v[i], off);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < N; ++i)
        reinterpret_cast<float*>(&red[i])[warp] = v[i];
  } else {
    float w[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = i < N ? v[i] : 0.f;
    trade_half<16>(w, lane);
    trade_half<8>(w, lane);
    trade_half<4>(w, lane);
    trade_half<2>(w, lane);
    trade_half<1>(w, lane);
    if (lane < N) reinterpret_cast<float*>(&red[lane])[warp] = w[0];
  }
  wg_bar();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 r = red[i];
    v[i] = ((r.x + r.y) + r.z) + r.w;
  }
}

__device__ __forceinline__ float wg_sum1(float v, Chain& ch) {
  float a[1] = {v};
  wg_sum<1>(a, ch);
  return a[0];
}

// ---- scalar helpers (every thread computes the same values) ---------------

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float inv = 1.f / fmaxf(n, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] *= inv;
}

__device__ __forceinline__ void quat_to_R(const float qin[4], float R[9]) {
  float q[4] = {qin[0], qin[1], qin[2], qin[3]};
  quat_normalize(q);
  const float x = q[0], y = q[1], z = q[2], w = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  R[0] = 1.f - 2.f * (yy + zz); R[1] = 2.f * (xy - wz); R[2] = 2.f * (xz + wy);
  R[3] = 2.f * (xy + wz); R[4] = 1.f - 2.f * (xx + zz); R[5] = 2.f * (yz - wx);
  R[6] = 2.f * (xz - wy); R[7] = 2.f * (yz + wx); R[8] = 1.f - 2.f * (xx + yy);
}

// Branch-free Shepperd: candidate with the largest norm, first max wins.
__device__ __forceinline__ void matrix_to_quat(const float R[9], float q[4]) {
  const float r00 = R[0], r01 = R[1], r02 = R[2], r10 = R[3], r11 = R[4],
              r12 = R[5], r20 = R[6], r21 = R[7], r22 = R[8];
  const float tr = r00 + r11 + r22;
  const float norms[4] = {1.f + tr, 1.f + r00 - r11 - r22,
                          1.f - r00 + r11 - r22, 1.f - r00 - r11 + r22};
  // candidates stored (w, x, y, z)
  const float c[4][4] = {{norms[0], r21 - r12, r02 - r20, r10 - r01},
                         {r21 - r12, norms[1], r01 + r10, r02 + r20},
                         {r02 - r20, r01 + r10, norms[2], r12 + r21},
                         {r10 - r01, r02 + r20, r12 + r21, norms[3]}};
  float bn = norms[0];
  q[0] = c[0][1]; q[1] = c[0][2]; q[2] = c[0][3]; q[3] = c[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (norms[k] > bn) {
      bn = norms[k];
      q[0] = c[k][1]; q[1] = c[k][2]; q[2] = c[k][3]; q[3] = c[k][0];
    }
  quat_normalize(q);
}

__device__ __forceinline__ void quat_boxplus(const float q[4], const float d[3],
                                             float out[4]) {
  const float n2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const bool small = n2 < 1e-12f;
  const float norm = sqrtf(small ? 1.f : n2);
  const float k = small ? 1.f - n2 / 6.f : sinf(norm) / norm;
  const float w = small ? 1.f - n2 / 2.f : cosf(norm);
  const float ax = d[0] * k, ay = d[1] * k, az = d[2] * k, aw = w;
  const float bx = q[0], by = q[1], bz = q[2], bw = q[3];
  out[0] = aw * bx + ax * bw + ay * bz - az * by;
  out[1] = aw * by - ax * bz + ay * bw + az * bx;
  out[2] = aw * bz + ax * by - ay * bx + az * bw;
  out[3] = aw * bw - ax * bx - ay * by - az * bz;
  quat_normalize(out);
}

// Solve A x = b for the damped SPD 6x6 (lower triangle, packed row-major:
// index i*(i+1)/2 + j for j <= i) by Cholesky; one divide per pivot.
__device__ __forceinline__ void chol_solve6(const float A[21], const float b[6],
                                            float x[6]) {
  float L[6][6], inv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = A[i * (i + 1) / 2 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(s, 1e-24f));
        inv[i] = 1.f / L[i][i];
      } else {
        L[i][j] = s * inv[j];
      }
    }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// ---- per-lane math -------------------------------------------------------

__device__ __forceinline__ void project(const float* P, float X0, float X1,
                                        float X2, float& u, float& v,
                                        float& w) {
  u = P[0] * X0 + P[1] * X1 + P[2] * X2 + P[3];
  v = P[4] * X0 + P[5] * X1 + P[6] * X2 + P[7];
  w = P[8] * X0 + P[9] * X1 + P[10] * X2 + P[11];
  if (fabsf(w) < 1e-12f) w = 1e-12f;
}

// Inlier test of lane l under pose (R, t): reprojection of the current
// point into prev-left under thr2, chain mask and cheirality.
__device__ __forceinline__ bool score_lane(const Smem& sh, int l,
                                           const float* R, const float* t,
                                           const float* Pl, float thr2) {
  const float x0 = sh.pts[0][l], x1 = sh.pts[1][l], x2 = sh.pts[2][l];
  const float Xx = R[0] * x0 + R[1] * x1 + R[2] * x2 + t[0];
  const float Xy = R[3] * x0 + R[4] * x1 + R[5] * x2 + t[1];
  const float Xz = R[6] * x0 + R[7] * x1 + R[8] * x2 + t[2];
  float u, v, w;
  project(Pl, Xx, Xy, Xz, u, v, w);
  const float du = u / w - sh.pts[6][l];
  const float dv = v / w - sh.pts[7][l];
  return (du * du + dv * dv < thr2) && (sh.pts[14][l] > 0.f) && (Xz > 0.f);
}

// Writes the inlier row of (R, t) into `row`; returns its count and, in
// `n_other`, the count of row `other` (one sum for both).
__device__ __forceinline__ float score_row(Chain& ch, float* row,
                                           const float* R, const float* t,
                                           const float* Pl,
                                           const float* other = nullptr,
                                           float* n_other = nullptr) {
  float c[2] = {0.f, 0.f};
  for (int l = threadIdx.x; l < ch.p.Lp; l += WG) {
    const float m = score_lane(ch.sh, l, R, t, Pl, ch.p.thr2) ? 1.f : 0.f;
    row[l] = m;
    c[0] += m;
    if (other) c[1] += other[l];
  }
  if (!other) return wg_sum1(c[0], ch);
  wg_sum<2>(c, ch);
  *n_other = c[1];
  return c[0];
}

__device__ __forceinline__ void copy_row(Chain& ch, float* dst,
                                         const float* src) {
  for (int l = threadIdx.x; l < ch.p.Lp; l += WG) dst[l] = src[l];
}

// Weighted rigid alignment Xp ≈ R Xc + t with weights `w` (Horn, 16-step
// shifted power iteration).
__device__ __forceinline__ void horn(Chain& ch, const float* w, float q[4],
                                     float R[9], float t[3]) {
  const Smem& sh = ch.sh;
  const int Lp = ch.p.Lp;
  float ws = 0.f;
  for (int l = threadIdx.x; l < Lp; l += WG) ws += w[l];
  const float wsum = fmaxf(wg_sum1(ws, ch), 1e-9f);
  float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int l = threadIdx.x; l < Lp; l += WG) {
    const float wn = w[l] / wsum;
#pragma unroll
    for (int i = 0; i < 6; ++i) c[i] += sh.pts[i][l] * wn;
  }
  wg_sum<6>(c, ch);
  float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int l = threadIdx.x; l < Lp; l += WG) {
    const float wn = w[l] / wsum;
    float s0[3], d0[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s0[i] = sh.pts[i][l] - c[i];
      d0[i] = sh.pts[3 + i][l] - c[3 + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H[3 * i + j] += s0[i] * d0[j] * wn;
  }
  wg_sum<9>(H, ch);
  const float sxx = H[0], sxy = H[1], sxz = H[2], syx = H[3], syy = H[4],
              syz = H[5], szx = H[6], szy = H[7], szz = H[8];
  float N[4][4] = {{sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
                   {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
                   {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
                   {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz}};
  float fro2 = 0.f;
  for (int i = 0; i < 9; ++i) fro2 += H[i] * H[i];
  const float sigma = 2.f * sqrtf(fro2) + 1e-9f;
  for (int i = 0; i < 4; ++i) N[i][i] += sigma;
  float v[4] = {1.f, 1.f, 1.f, 1.f};
  for (int it = 0; it < 16; ++it) {
    float v2[4];
    for (int i = 0; i < 4; ++i)
      v2[i] = N[i][0] * v[0] + N[i][1] * v[1] + N[i][2] * v[2] + N[i][3] * v[3];
    const float n = sqrtf(v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2] +
                          v2[3] * v2[3]);
    const float inv = 1.f / fmaxf(n, 1e-20f);
    for (int i = 0; i < 4; ++i) v[i] = v2[i] * inv;
  }
  q[0] = v[1]; q[1] = v[2]; q[2] = v[3]; q[3] = v[0];   // (w,x,y,z) -> xyzw
  quat_to_R(q, R);
  for (int i = 0; i < 3; ++i)
    t[i] = c[3 + i] - (R[3 * i] * c[0] + R[3 * i + 1] * c[1] +
                       R[3 * i + 2] * c[2]);
}

// One lane pass at pose (q, t), summed over the warpgroup: acc[0..20] the
// packed lower triangle of J^T W J, acc[21..26] J^T W r, acc[27] the sum of
// Huber rho over the active factors. Factor f's inputs: f in [prev_l,
// prev_r, inv curr_l, inv curr_r]; the factor loop is unrolled, so f is a
// compile-time constant in each copy.
__device__ __forceinline__ void lm_pass(Chain& ch, const float q[4],
                                        const float t[3], const float* Pl,
                                        const float* Pr, int degree,
                                        float delta, float mask_scale,
                                        bool use_lw, float (&acc)[28]) {
  const Smem& sh = ch.sh;
  float R[9];
  quat_to_R(q, R);
  const float d2 = delta * delta;
#pragma unroll
  for (int i = 0; i < 28; ++i) acc[i] = 0.f;
  for (int l = threadIdx.x; l < ch.p.Lp; l += WG) {
    const float x0 = sh.pts[0][l], x1 = sh.pts[1][l], x2 = sh.pts[2][l];
    const float Y[3] = {R[0] * x0 + R[1] * x1 + R[2] * x2 + t[0],
                        R[3] * x0 + R[4] * x1 + R[5] * x2 + t[1],
                        R[6] * x0 + R[7] * x1 + R[8] * x2 + t[2]};
    // dY/dδ = -2 [Y - t]_x
    const float vx = Y[0] - t[0], vy = Y[1] - t[1], vz = Y[2] - t[2];
    const float dY[3][3] = {{0.f, 2.f * vz, -2.f * vy},
                            {-2.f * vz, 0.f, 2.f * vx},
                            {2.f * vy, -2.f * vx, 0.f}};
    float Z[3] = {0.f, 0.f, 0.f}, dZ[3][3] = {{0.f}};
    if (degree >= 3) {
      const float Zv[3] = {sh.pts[3][l] - t[0], sh.pts[4][l] - t[1],
                           sh.pts[5][l] - t[2]};
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Z[i] = R[i] * Zv[0] + R[3 + i] * Zv[1] + R[6 + i] * Zv[2];
      // dZ/dδ = 2 R^T [Xp - t]_x
      const float cZ[3][3] = {{0.f, -Zv[2], Zv[1]},
                              {Zv[2], 0.f, -Zv[0]},
                              {-Zv[1], Zv[0], 0.f}};
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int m = 0; m < 3; ++m)
          dZ[i][m] = 2.f * (R[i] * cZ[0][m] + R[3 + i] * cZ[1][m] +
                            R[6 + i] * cZ[2][m]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (f >= degree) break;
      float mf = sh.inl[l] * mask_scale;  // GLS weight on backward factors
      if (use_lw && f >= 2) mf *= sh.pts[15][l];
      // Branch-free, so the four factors interleave; an inactive factor adds
      // exact zeros (a select, not a product: J may be inf at depth ~0).
      const bool on = mf != 0.f;
      const bool fwd = f < 2;
      const float* P = (f == 0 || f == 2) ? Pl : Pr;
      float X[3], dX[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        X[i] = fwd ? Y[i] : Z[i];
#pragma unroll
        for (int m = 0; m < 3; ++m) dX[i][m] = fwd ? dY[i][m] : dZ[i][m];
      }
      float u, v, w;
      project(P, X[0], X[1], X[2], u, v, w);
      const float pi0 = u / w, pi1 = v / w;
      const float r0 = pi0 - sh.pts[6 + 2 * f][l];
      const float r1 = pi1 - sh.pts[7 + 2 * f][l];
      const float s = r0 * r0 + r1 * r1;
      const float rho =
          s <= d2 ? s : 2.f * delta * sqrtf(fmaxf(s, 1e-20f)) - d2;
      acc[27] += on ? rho * mf : 0.f;
      const float iw = __frcp_rn(w);
      float JA[2][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        JA[0][c] = (P[c] - pi0 * P[8 + c]) * iw;
        JA[1][c] = (P[4 + c] - pi1 * P[8 + c]) * iw;
      }
      float J[2][6];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int m = 0; m < 3; ++m)
          J[r][m] = JA[r][0] * dX[0][m] + JA[r][1] * dX[1][m] +
                    JA[r][2] * dX[2][m];
#pragma unroll
        for (int m = 0; m < 3; ++m)
          J[r][3 + m] = fwd ? JA[r][m]
                            : -(JA[r][0] * R[3 * m] + JA[r][1] * R[3 * m + 1] +
                                JA[r][2] * R[3 * m + 2]);
      }
      const float nrm = sqrtf(r0 * r0 + r1 * r1);
      const float wh = fminf(1.f, delta / fmaxf(nrm, 1e-12f)) * mf;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b) {
          const float h = wh * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
          acc[a * (a + 1) / 2 + b] += on ? h : 0.f;
        }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float g = wh * (J[0][a] * r0 + J[1][a] * r1);
        acc[21 + a] += on ? g : 0.f;
      }
    }
  }
  wg_sum<28>(acc, ch);
}

// Trace-unrolled LM (lm.refine_pose semantics, without the final revert:
// the caller applies it). Updates q, t; returns `improved`. The cost of a
// candidate and the normal equations there come from one lm_pass.
__device__ __forceinline__ bool lm_iterations(Chain& ch, float q[4],
                                              float t[3], const float* Pl,
                                              const float* Pr, int degree,
                                              float delta, int iters,
                                              float mask_scale, bool use_lw) {
  float S[28];
  lm_pass(ch, q, t, Pl, Pr, degree, delta, mask_scale, use_lw, S);
  const float c0 = 0.5f * S[27];
  float cost = c0, lam = 1e-4f;
  for (int it = 0; it < iters; ++it) {
    float A[21], g[6];
#pragma unroll
    for (int i = 0; i < 21; ++i) A[i] = S[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int d = i * (i + 1) / 2 + i;
      A[d] = S[d] + lam * S[d] + 1e-9f;
      g[i] = S[21 + i];
    }
    float step[6];
    chol_solve6(A, g, step);
    const float dr[3] = {-step[0], -step[1], -step[2]};
    float q_new[4];
    quat_boxplus(q, dr, q_new);
    const float t_new[3] = {t[0] - step[3], t[1] - step[4], t[2] - step[5]};
    float Sn[28];
    lm_pass(ch, q_new, t_new, Pl, Pr, degree, delta, mask_scale, use_lw, Sn);
    const float cost_new = 0.5f * Sn[27];
    if (cost_new < cost) {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = q_new[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = t_new[i];
#pragma unroll
      for (int i = 0; i < 28; ++i) S[i] = Sn[i];
      lam = fmaxf(lam * 0.5f, 1e-9f);
      cost = cost_new;
    } else {
      lam = fminf(lam * 4.f, 1e6f);
    }
  }
  return cost < c0;
}

// The solve after the winner (`hw`, its [R | t] row; `maxc`, its count), on
// warpgroup 0 of the frame's first CTA.
__device__ __forceinline__ void solve_chain(Chain& ch, const float* hw,
                                            int maxc, const float* scal,
                                            float* out, float* inl_g) {
  Smem& sh = ch.sh;
  const Params& p = ch.p;
  const int tid = threadIdx.x;
  float q_pred[4], t_pred[3], Pl[12], Pr[12];
  for (int i = 0; i < 4; ++i) q_pred[i] = scal[i];
  for (int i = 0; i < 3; ++i) t_pred[i] = scal[4 + i];
  const float fc = scal[7];
#pragma unroll
  for (int i = 0; i < 12; ++i) { Pl[i] = scal[8 + i]; Pr[i] = scal[20 + i]; }

  // ---- prior lane vs winner (sampled lanes win ties) ---------------------
  float R[9], t[3];
  quat_to_R(q_pred, R);
  const float count_prior = score_row(ch, sh.cand, R, t_pred, Pl);
  const bool sampled = (float)maxc >= count_prior;
  if (sampled) {
    for (int i = 0; i < 9; ++i) R[i] = hw[i];
    for (int i = 0; i < 3; ++i) t[i] = hw[9 + i];
    score_row(ch, sh.inl, R, t, Pl);
  } else {
    for (int i = 0; i < 3; ++i) t[i] = t_pred[i];
    copy_row(ch, sh.inl, sh.cand);
  }

  // ---- refit (2x weighted Horn) + polish ----------------------------------
  for (int rep = 0; rep < 2; ++rep) {
    float q2[4], R2[9], t2[3];
    horn(ch, sh.inl, q2, R2, t2);
    float n1;
    const float n2 = score_row(ch, sh.cand, R2, t2, Pl, sh.inl, &n1);
    if (n2 >= n1 && n1 > 0.f) {   // zero-inlier guard
      for (int i = 0; i < 9; ++i) R[i] = R2[i];
      for (int i = 0; i < 3; ++i) t[i] = t2[i];
      copy_row(ch, sh.inl, sh.cand);
    }
  }
  float q_raw[4], t_raw[3];
  matrix_to_quat(R, q_raw);
  for (int i = 0; i < 3; ++i) t_raw[i] = t[i];
  {
    // polish: degree-1 LM on the prev-left factor, delta = reproj threshold
    float q_p[4] = {q_raw[0], q_raw[1], q_raw[2], q_raw[3]};
    float t_p[3] = {t_raw[0], t_raw[1], t_raw[2]};
    const bool improved = lm_iterations(ch, q_p, t_p, Pl, Pl, 1, p.reproj,
                                        p.polish_iters, 1.f, false);
    if (!improved) {
      for (int i = 0; i < 4; ++i) q_p[i] = q_raw[i];
      for (int i = 0; i < 3; ++i) t_p[i] = t_raw[i];
    }
    float R_p[9];
    quat_to_R(q_p, R_p);
    float n1;
    const float np_ = score_row(ch, sh.cand, R_p, t_p, Pl, sh.inl, &n1);
    if (np_ >= n1 && n1 > 0.f) {
      for (int i = 0; i < 4; ++i) q_raw[i] = q_p[i];
      for (int i = 0; i < 3; ++i) t_raw[i] = t_p[i];
      copy_row(ch, sh.inl, sh.cand);
    }
  }
  float sums[2] = {0.f, 0.f};
  for (int l = tid; l < p.Lp; l += WG) {
    sums[0] += sh.inl[l];
    sums[1] += sh.pts[14][l];
  }
  wg_sum<2>(sums, ch);
  const float num = sums[0], num_chain = sums[1];
  const bool success = num >= p.min_inliers;

  // ---- gates ---------------------------------------------------------------
  const float e0 = t_raw[0] - t_pred[0], e1 = t_raw[1] - t_pred[1],
              e2 = t_raw[2] - t_pred[2];
  const float accel = sqrtf(e0 * e0 + e1 * e1 + e2 * e2) / p.dt;
  const bool anomaly = (fc > p.ignore_fc) && (accel > p.max_acc);
  const bool use_pred = !success || anomaly;
  const bool do_opt = !use_pred;
  float q[4], tt[3], q_pn[4], t_pn[3];
  for (int i = 0; i < 4; ++i) {
    q[i] = use_pred ? q_pred[i] : q_raw[i];
    q_pn[i] = do_opt ? q_raw[i] : q_pred[i];
  }
  for (int i = 0; i < 3; ++i) {
    tt[i] = use_pred ? t_pred[i] : t_raw[i];
    t_pn[i] = do_opt ? t_raw[i] : t_pred[i];
  }

  // ---- LM refinement, then the optional GLS pass --------------------------
  bool lm_improved = false;
  const float opt = do_opt ? 1.f : 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    const bool weighted = pass == 1;
    if (p.degree <= 0 || p.lm_iters <= 0) break;
    if (weighted && !(p.weighted && p.degree >= 3)) break;
    float q_l[4] = {q[0], q[1], q[2], q[3]};
    float t_l[3] = {tt[0], tt[1], tt[2]};
    const bool improved = lm_iterations(ch, q_l, t_l, Pl, Pr, p.degree,
                                        p.delta, p.lm_iters, opt, weighted);
    if (improved && do_opt) {
      for (int i = 0; i < 4; ++i) q[i] = q_l[i];
      for (int i = 0; i < 3; ++i) tt[i] = t_l[i];
    }
    if (!weighted) lm_improved = improved && do_opt;
  }

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) { out[i] = q[i]; out[7 + i] = q_pn[i]; }
    for (int i = 0; i < 3; ++i) { out[4 + i] = tt[i]; out[11 + i] = t_pn[i]; }
    out[14] = num;
    out[15] = success ? 1.f : 0.f;
    out[16] = anomaly ? 1.f : 0.f;
    out[17] = lm_improved ? 1.f : 0.f;
    out[18] = sampled ? 0.f : 1.f;
    out[19] = num_chain;
  }
  for (int l = tid; l < p.Lp; l += WG) inl_g[l] = sh.inl[l];
}

// RANSAC scoring over the cluster, on the point tile in each CTA's shared
// memory: CTA `rank` scores hypotheses [S*rank/CL, S*(rank+1)/CL) of `hyp`,
// a warp per hypothesis, and writes its first-max winner into rank 0's
// cc/cs through distributed shared memory; then the cluster syncs. With
// kOwn, `hyp` holds only the CTA's share, in its shared memory, and each
// CTA also copies its winner's row into rank 0's `crow[rank]`.
template <bool kOwn = false>
__device__ __forceinline__ void score_cluster(Smem& sh, const Params& p,
                                              const float* __restrict__ hyp,
                                              const float* Pl,
                                              cg::cluster_group& cluster,
                                              int rank,
                                              float* crow = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // ---- this CTA's share of the S hypotheses: a warp per hypothesis -------
  const int s_lo = p.S * rank / CL, s_hi = p.S * (rank + 1) / CL;
  int best_c = -1, best_s = 0x7fffffff;
  for (int s = s_lo + warp; s < s_hi; s += NWARP) {   // s increasing
    float h[12];
#pragma unroll
    for (int i = 0; i < 12; ++i)
      h[i] = kOwn ? hyp[12 * (s - s_lo) + i] : __ldg(hyp + 12 * s + i);
    int c = 0;
    for (int l = lane; l < p.Lp; l += 128) {   // Lp % 128 == 0
      bool m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m[u] = score_lane(sh, l + 32 * u, h, h + 9, Pl, p.thr2);
#pragma unroll
      for (int u = 0; u < 4; ++u) c += __popc(__ballot_sync(FULL, m[u]));
    }
    if (c > best_c) { best_c = c; best_s = s; }   // first max
  }
  if (lane == 0) { sh.wc[warp] = best_c; sh.ws[warp] = best_s; }
  __syncthreads();
  if (tid == 0) {
    int c = sh.wc[0], s = sh.ws[0];
    for (int w = 1; w < NWARP; ++w)
      if (sh.wc[w] > c || (sh.wc[w] == c && sh.ws[w] < s)) {
        c = sh.wc[w];
        s = sh.ws[w];
      }
    cluster.map_shared_rank(sh.cc, 0)[rank] = c;
    cluster.map_shared_rank(sh.cs, 0)[rank] = s;
    if (kOwn && c >= 0) {
      float* dst = cluster.map_shared_rank(crow, 0) + 12 * rank;
      for (int i = 0; i < 12; ++i) dst[i] = hyp[12 * (s - s_lo) + i];
    }
  }
  cluster.sync();
}

// On rank 0 after score_cluster: the first-max argmax over the CTAs'
// winners, in rank (= index) order.
__device__ __forceinline__ void cluster_winner(const Smem& sh, int& maxc,
                                               int& j) {
  maxc = sh.cc[0];
  j = sh.cs[0];
  for (int r = 1; r < CL; ++r)
    if (sh.cc[r] > maxc || (sh.cc[r] == maxc && sh.cs[r] < j)) {
      maxc = sh.cc[r];
      j = sh.cs[r];
    }
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
fused_solve_kernel(const float* __restrict__ pts_g,
                   const float* __restrict__ hyp_g,
                   const float* __restrict__ scal_g, float* __restrict__ out_g,
                   float* __restrict__ inl_g, Params p) {
  __shared__ Smem sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int f = blockIdx.x / CL;
  const int tid = threadIdx.x;
  const float* pts = pts_g + (long long)f * 16 * p.Lp;
  const float* hyp = hyp_g + (long long)f * p.S * 12;
  const float* scal = scal_g + (long long)f * 32;

  for (int i = tid; i < 16 * p.Lp; i += NT) sh.pts[i / p.Lp][i % p.Lp] = pts[i];
  float Pl[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) Pl[i] = scal[8 + i];
  cluster.sync();   // points visible; every CTA of the cluster is running
  score_cluster(sh, p, hyp, Pl, cluster, rank);
  if (rank != 0 || tid >= WG) return;
  int maxc, j;
  cluster_winner(sh, maxc, j);
  Chain ch{sh, p, 0};
  solve_chain(ch, hyp + 12 * j, maxc, scal, out_g + (long long)f * 20,
              inl_g + (long long)f * p.Lp);
}

// ---- the persistent landmark scan ---------------------------------------
//
// The online hybrid's scan over P frame pairs (parallel/sharding.py,
// scan_step in the landmark-kernel branch) in ONE launch: one cluster walks
// the pairs in order, the carry (prior, frame count, landmarks) stays on the
// chip. A pair's solve is fused_solve_kernel's body on the pair's tile; what
// ran as ~220 PyTorch ops around each launch (landmark substitution, the
// splice of the tile, the scalars, fusion, the scatter to keypoint slots)
// runs here between the solves. The steps are serial (pair f needs pair
// f-1's prior and landmarks), so the design keeps one cluster resident:
//  - The landmarks, (x, y, z, track length) per keypoint slot (K x 16 bytes),
//    live in rank 0's shared memory; every CTA gathers them at its pair's
//    lanes through distributed shared memory while it loads its tile.
//  - Per pair: cluster.sync (last pair's landmarks complete), tile load with
//    the substitution, scoring (score_cluster, which ends in a second
//    cluster.sync), then rank 0's warpgroup 0 alone: the chain, the fusion
//    of its lanes and the scatter; the other CTAs wait at the next sync.
// Fusion and scatter repeat solver.fuse_landmarks / scatter_landmarks; the
// fusion rounds every product and sum on its own (the _rn intrinsics), as
// PyTorch's elementwise kernels do, with the two small matrix products as
// FMA chains in index order, as cuBLAS computes them: on the H100 the scan
// then equals the per-pair loop bit for bit. What bounds it is the chain's
// latency, as in the per-pair entry: a pair takes ~0.075 ms against that
// entry's 0.069, the rest the tile load with the gather, the fusion and two
// cluster syncs. The scoring reads no substituted row, so the 7 idle CTAs
// could score the next pair during the chain; not done.

constexpr int MAX_K = 8192;      // landmark slots (dynamic shared memory)

struct ScanParams {
  int L, K, max_age;             // lanes of a pair, keypoint slots, cap
  float gate2;                   // squared fusion gate (px^2)
};

struct ScanCarry {               // rank 0's, besides the landmark slots
  int len[MAX_L];                // lane track length after substitution
  float scal[32];                // q_pred t_pred frame_count P_l P_r
  float res[20];                 // the pair's output row
};

// se3.quat_to_matrix as PyTorch computes it on this card: normalise (its
// CUDA norm of 4 values sums the squares as (q0^2 + q2^2) + (q1^2 + q3^2)),
// then each entry.
__device__ __forceinline__ void quat_to_R_rn(const float qin[4], float R[9]) {
  const float n2 = __fadd_rn(
      __fadd_rn(__fmul_rn(qin[0], qin[0]), __fmul_rn(qin[2], qin[2])),
      __fadd_rn(__fmul_rn(qin[1], qin[1]), __fmul_rn(qin[3], qin[3])));
  const float n = fmaxf(__fsqrt_rn(n2), 1e-12f);
  const float x = __fdiv_rn(qin[0], n), y = __fdiv_rn(qin[1], n),
              z = __fdiv_rn(qin[2], n), w = __fdiv_rn(qin[3], n);
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), xz = __fmul_rn(x, z), yz = __fmul_rn(y, z);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y), wz = __fmul_rn(w, z);
  R[0] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(yy, zz)));
  R[1] = __fmul_rn(2.f, __fsub_rn(xy, wz));
  R[2] = __fmul_rn(2.f, __fadd_rn(xz, wy));
  R[3] = __fmul_rn(2.f, __fadd_rn(xy, wz));
  R[4] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, zz)));
  R[5] = __fmul_rn(2.f, __fsub_rn(yz, wx));
  R[6] = __fmul_rn(2.f, __fsub_rn(xz, wy));
  R[7] = __fmul_rn(2.f, __fadd_rn(yz, wx));
  R[8] = __fsub_rn(1.f, __fmul_rn(2.f, __fadd_rn(xx, yy)));
}

// triangulation.project: [X 1] P^T, the depth clamped, then the divides;
// returns the squared distance to (u0, v0).
__device__ __forceinline__ float reproj2_rn(const float* P, const float X[3],
                                            float u0, float v0) {
  float uvw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    uvw[i] = __fadd_rn(fmaf(X[2], P[4 * i + 2],
                            fmaf(X[1], P[4 * i + 1],
                                 __fmul_rn(X[0], P[4 * i]))),
                       P[4 * i + 3]);
  const float w = fabsf(uvw[2]) < 1e-12f ? 1e-12f : uvw[2];
  const float du = __fsub_rn(__fdiv_rn(uvw[0], w), u0);
  const float dv = __fsub_rn(__fdiv_rn(uvw[1], w), v0);
  return __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
}

// solver.fuse_landmarks + scatter_landmarks on warpgroup 0 of rank 0, from
// the pair's output row c.res and final inlier row: the landmark slots are
// zeroed, then each lane's fused point and length land at its slot sel[l].
template <typename Slot>
__device__ __forceinline__ void fuse_scatter(const Smem& sh,
                                             const ScanCarry& c,
                                             float4* lms,
                                             const Slot* __restrict__ sel,
                                             const ScanParams& sp) {
  const int tid = threadIdx.x;
  float R[9];
  quat_to_R_rn(c.res, R);
  const float t[3] = {c.res[4], c.res[5], c.res[6]};
  const bool use_pred = !(c.res[15] > 0.f) || (c.res[16] > 0.f);
  const float* Pl = c.scal + 8;
  const float* Pr = c.scal + 20;
  for (int k = tid; k < sp.K; k += WG) lms[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  wg_bar();
  for (int l = tid; l < sp.L; l += WG) {
    const float d[3] = {__fsub_rn(sh.pts[3][l], t[0]),
                        __fsub_rn(sh.pts[4][l], t[1]),
                        __fsub_rn(sh.pts[5][l], t[2])};
    float x[3];   // R^T (X_prev - t)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      x[j] = fmaf(d[2], R[6 + j], fmaf(d[1], R[3 + j], __fmul_rn(d[0], R[j])));
    const float e2l = reproj2_rn(Pl, x, sh.pts[10][l], sh.pts[11][l]);
    const float e2r = reproj2_rn(Pr, x, sh.pts[12][l], sh.pts[13][l]);
    const bool chain = sh.pts[14][l] > 0.f;
    // max(e2l, e2r) < gate2, NaN failing as in torch.maximum
    const bool ok = e2l < sp.gate2 && e2r < sp.gate2 && x[2] > 0.f &&
                    isfinite(x[0]) &&
                    isfinite(x[1]) && isfinite(x[2]);
    const bool fuse = !use_pred && sh.inl[l] > 0.f && chain && ok;
    const int ll = c.len[l];
    const float w = (float)min(ll, sp.max_age);
    const float w1 = __fadd_rn(w, 1.f);
    float4 v;
    v.x = fuse ? __fdiv_rn(__fadd_rn(__fmul_rn(w, x[0]), sh.pts[0][l]), w1)
               : sh.pts[0][l];
    v.y = fuse ? __fdiv_rn(__fadd_rn(__fmul_rn(w, x[1]), sh.pts[1][l]), w1)
               : sh.pts[1][l];
    v.z = fuse ? __fdiv_rn(__fadd_rn(__fmul_rn(w, x[2]), sh.pts[2][l]), w1)
               : sh.pts[2][l];
    int len = fuse ? min(ll + 1, sp.max_age) : 1;
    if (!chain) {
      v.x = v.y = v.z = 0.f;
      len = 0;
    }
    v.w = __int_as_float(len);
    lms[sel[l]] = v;
  }
}

// The tile, with the carried landmarks in rows 3-5 where a track exists
// (solver.substitute_landmarks) and, for the GLS pass, the clamped track
// length in row 15 (solver_cuda.splice_points); `lm(k)` is slot k's
// landmark (x, y, z, track length as int bits). With `keep_len` each
// lane's length after substitution goes to c.len.
template <class Lookup>
__device__ __forceinline__ void load_substituted(Smem& sh, ScanCarry& c,
                                                 const float* pts,
                                                 const int* inter,
                                                 const Params& p,
                                                 const ScanParams& sp,
                                                 bool keep_len, Lookup lm) {
  for (int l = threadIdx.x; l < p.Lp; l += NT) {
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) v[r] = pts[r * p.Lp + l];
    if (l < sp.L) {
      const int fi = inter[l];
      const float4 m = lm(max(fi, 0));
      const int clen = __float_as_int(m.w);
      const bool has = fi >= 0 && clen > 0 && v[14] > 0.f && isfinite(m.x) &&
                       isfinite(m.y) && isfinite(m.z);
      if (has) {
        v[3] = m.x;
        v[4] = m.y;
        v[5] = m.z;
      }
      const int ll = has ? clen : 1;
      if (keep_len) c.len[l] = ll;
      if (p.weighted) v[15] = (float)min(ll, sp.max_age);
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) sh.pts[r][l] = v[r];
  }
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
fused_scan_kernel(const float* __restrict__ pts_g,
                  const float* __restrict__ hyp_g,
                  const int* __restrict__ inter_g,
                  const int* __restrict__ sel_g,
                  const float* __restrict__ scal0, float* __restrict__ out_g,
                  float* __restrict__ inl_g, float* __restrict__ lm_pts,
                  int* __restrict__ lm_len, int pairs, Params p,
                  ScanParams sp) {
  __shared__ Smem sh;
  __shared__ ScanCarry c;
  extern __shared__ float4 lms[];   // landmark slots (rank 0's are read)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  float Pl[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) Pl[i] = scal0[8 + i];
  if (rank == 0) {
    if (tid < 32) c.scal[tid] = scal0[tid];
    for (int k = tid; k < sp.K; k += NT)
      lms[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* lm0 = cluster.map_shared_rank(lms, 0);

  for (int f = 0; f < pairs; ++f) {
    cluster.sync();   // the last pair's landmarks are complete in rank 0
    const float* pts = pts_g + (long long)f * 16 * p.Lp;
    const float* hyp = hyp_g + (long long)f * p.S * 12;
    const int* inter = inter_g + (long long)f * sp.L;
    load_substituted(sh, c, pts, inter, p, sp, rank == 0,
                     [&](int k) { return lm0[k]; });
    __syncthreads();
    score_cluster(sh, p, hyp, Pl, cluster, rank);
    if (rank != 0 || tid >= WG) continue;

    int maxc, j;
    cluster_winner(sh, maxc, j);
    Chain ch{sh, p, 0};
    solve_chain(ch, hyp + 12 * j, maxc, c.scal, c.res,
                inl_g + (long long)f * p.Lp);
    wg_bar();
    fuse_scatter(sh, c, lms, sel_g + (long long)f * sp.L, sp);
    if (tid < 20) out_g[(long long)f * 20 + tid] = c.res[tid];
    if (tid < 7) c.scal[tid] = c.res[7 + tid];   // q_pred', t_pred'
    if (tid == 7) c.scal[7] += 1.f;               // frame count
  }
  if (rank == 0 && tid < WG) {   // the landmarks after the last pair
    wg_bar();
    for (int k = tid; k < sp.K; k += WG) {
      const float4 v = lms[k];
      lm_pts[3 * k] = v.x;
      lm_pts[3 * k + 1] = v.y;
      lm_pts[3 * k + 2] = v.z;
      lm_len[k] = __float_as_int(v.w);
    }
  }
}

// ---- the per-frame landmark solve ---------------------------------------
//
// A frame's landmark solve (solver.solve_with_landmarks per frame, where
// solver.fused_frame_route holds) in ONE launch: what ran as ~330 PyTorch
// ops around the per-frame entry (substitution, the Gumbel top-3 sampling
// and the Horn solves of precompute_hypotheses on the substituted prep, the
// pose inverse, fusion, the scatter to keypoint slots) runs inside it. Unlike
// the scan, the hypotheses are drawn after substitution (Horn reads the
// carried landmarks), so each CTA draws its own share of the S rows:
//  - every CTA loads the tile and substitutes the carried landmarks, read
//    from global memory (load_substituted, the scan's);
//  - CTA `rank` draws rows [S*rank/CL, S*(rank+1)/CL): a warp per row takes
//    the top 3 of where(chain, 0, -inf) + gumbel over the L lanes in the
//    order of torch.sort(descending, stable) (NaN first, ties to the lower
//    index) by a butterfly merge of per-lane top-3 lists; then a thread per
//    row runs Horn on the three pairs (horn3_rn). Rows stay in the CTA's
//    shared memory, where score_cluster reads them, and go to hyp_g;
//  - scoring, the chain with its GLS pass, fusion and the scatter are the
//    other entries' code; each CTA hands its winner's row to rank 0.
// Horn rounds as the op-by-op composition does on this card: every product
// and sum on its own (_rn intrinsics), the sums over the three points and
// the norms in the order of PyTorch's CUDA reductions, and the batched
// products as cuBLAS sums them: a matrix product (H) as one FMA chain in
// index order, a matrix-vector product as two FMA chains over the halves
// of the index, (a0 b0 + a1 b1) + (a2 b2 + a3 b3). Bound, as
// the other entries: the chain's latency; the sampling and Horn add one
// ~16-step serial chain per thread, the scoring's and fusion's lane passes
// stay as they were.

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);   // torch.clamp: NaN propagates
}

// torch.sort's descending stable order: NaN first, then larger keys, equal
// keys by lower index.
__device__ __forceinline__ bool sorts_before(float a, int ia, float b,
                                             int ib) {
  const bool an = a != a, bn = b != b;
  if (an != bn) return an;
  if (!an && a != b) return a > b;
  return ia < ib;
}

struct Top3 {
  float k[3];
  int i[3];
};

__device__ __forceinline__ void top3_insert(Top3& t, float k, int i) {
  if (!sorts_before(k, i, t.k[2], t.i[2])) return;
  if (sorts_before(k, i, t.k[1], t.i[1])) {
    t.k[2] = t.k[1];
    t.i[2] = t.i[1];
    if (sorts_before(k, i, t.k[0], t.i[0])) {
      t.k[1] = t.k[0];
      t.i[1] = t.i[0];
      t.k[0] = k;
      t.i[0] = i;
    } else {
      t.k[1] = k;
      t.i[1] = i;
    }
  } else {
    t.k[2] = k;
    t.i[2] = i;
  }
}

// pnp._horn on three point pairs with unit weights (src: rows 0-2 of the
// tile at the lanes, dst: the substituted rows 3-5), then [R | t] as
// precompute_hypotheses packs it.
__device__ __forceinline__ void horn3_rn(const Smem& sh, const int idx[3],
                                         float row[12]) {
  const float wn = __fdiv_rn(1.f, 3.f);   // w / sum(w), w = 1
  float src[3][3], dst[3][3];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      src[n][i] = sh.pts[i][idx[n]];
      dst[n][i] = sh.pts[3 + i][idx[n]];
    }
  // centroids: a sum over 3 strided values, ((x0 + x1) + x2)
  float cs[3], cd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    cs[i] = __fadd_rn(__fadd_rn(__fmul_rn(src[0][i], wn),
                                __fmul_rn(src[1][i], wn)),
                      __fmul_rn(src[2][i], wn));
    cd[i] = __fadd_rn(__fadd_rn(__fmul_rn(dst[0][i], wn),
                                __fmul_rn(dst[1][i], wn)),
                      __fmul_rn(dst[2][i], wn));
  }
  // H = einsum(src0, dst0, wn): dst0 * wn first, then a batched product
  // over the 3 points
  float s0[3][3], d0w[3][3];
#pragma unroll
  for (int n = 0; n < 3; ++n)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s0[n][i] = __fsub_rn(src[n][i], cs[i]);
      d0w[n][i] = __fmul_rn(__fsub_rn(dst[n][i], cd[i]), wn);
    }
  float H[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      H[3 * i + j] = fmaf(s0[2][i], d0w[2][j],
                          fmaf(s0[1][i], d0w[1][j],
                               __fmul_rn(s0[0][i], d0w[0][j])));
  float sq[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) sq[k] = __fmul_rn(H[k], H[k]);
  // the Frobenius norm: 9 values over 8 lanes (lane 0 adds its second
  // value), then the shuffles at offsets 4, 2, 1
  const float fro2 = __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[8]), sq[4]),
                __fadd_rn(sq[2], sq[6])),
      __fadd_rn(__fadd_rn(sq[1], sq[5]), __fadd_rn(sq[3], sq[7])));
  const float sigma = __fadd_rn(__fmul_rn(2.f, __fsqrt_rn(fro2)), 1e-9f);
  const float sxx = H[0], sxy = H[1], sxz = H[2], syx = H[3], syy = H[4],
              syz = H[5], szx = H[6], szy = H[7], szz = H[8];
  float N[4][4] = {
      {__fadd_rn(__fadd_rn(sxx, syy), szz), __fsub_rn(syz, szy),
       __fsub_rn(szx, sxz), __fsub_rn(sxy, syx)},
      {__fsub_rn(syz, szy), __fsub_rn(__fsub_rn(sxx, syy), szz),
       __fadd_rn(sxy, syx), __fadd_rn(szx, sxz)},
      {__fsub_rn(szx, sxz), __fadd_rn(sxy, syx),
       __fsub_rn(__fadd_rn(-sxx, syy), szz), __fadd_rn(syz, szy)},
      {__fsub_rn(sxy, syx), __fadd_rn(szx, sxz), __fadd_rn(syz, szy),
       __fadd_rn(__fsub_rn(-sxx, syy), szz)}};
#pragma unroll
  for (int i = 0; i < 4; ++i) N[i][i] = __fadd_rn(N[i][i], sigma);
  float v[4] = {1.f, 1.f, 1.f, 1.f};
  for (int it = 0; it < 16; ++it) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = __fadd_rn(fmaf(N[i][1], v[1], __fmul_rn(N[i][0], v[0])),
                       fmaf(N[i][3], v[3], __fmul_rn(N[i][2], v[2])));
    // a norm of 4 values: (w0^2 + w2^2) + (w1^2 + w3^2)
    const float n2 =
        __fadd_rn(__fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[2], w[2])),
                  __fadd_rn(__fmul_rn(w[1], w[1]), __fmul_rn(w[3], w[3])));
    const float n = clamp_min(__fsqrt_rn(n2), 1e-20f);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __fdiv_rn(w[i], n);
  }
  const float q[4] = {v[1], v[2], v[3], v[0]};   // (w,x,y,z) -> xyzw
  quat_to_R_rn(q, row);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    row[9 + i] = __fsub_rn(
        cd[i], __fadd_rn(fmaf(row[3 * i + 1], cs[1],
                              __fmul_rn(row[3 * i], cs[0])),
                         __fmul_rn(row[3 * i + 2], cs[2])));
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
fused_frame_kernel(const float* __restrict__ pts,
                   const int* __restrict__ inter,
                   const long long* __restrict__ sel,
                   const float* __restrict__ gumbel,
                   const float* __restrict__ lm_in_pts,
                   const int* __restrict__ lm_in_len,
                   const float* __restrict__ scal, float* __restrict__ hyp_g,
                   float* __restrict__ out_g, float* __restrict__ inl_g,
                   float* __restrict__ lm_pts, int* __restrict__ lm_len,
                   Params p, ScanParams sp) {
  __shared__ Smem sh;
  __shared__ ScanCarry c;
  __shared__ float crow[CL * 12];   // each CTA's winning row (rank 0's)
  extern __shared__ float4 dyn[];   // landmark slots, then hypothesis rows
  float4* lms = dyn;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s_lo = p.S * rank / CL, rows = p.S * (rank + 1) / CL - s_lo;
  float* hrow = reinterpret_cast<float*>(dyn + sp.K);
  int* hidx = reinterpret_cast<int*>(hrow + 12 * ((p.S + CL - 1) / CL));
  if (rank == 0 && tid < 32) c.scal[tid] = scal[tid];
  load_substituted(sh, c, pts, inter, p, sp, rank == 0, [&](int k) {
    return make_float4(lm_in_pts[3 * k], lm_in_pts[3 * k + 1],
                       lm_in_pts[3 * k + 2], __int_as_float(lm_in_len[k]));
  });
  __syncthreads();

  // ---- this CTA's hypotheses: the top 3 of each row, a warp per row -----
  for (int r = warp; r < rows; r += NWARP) {
    const float* g = gumbel + (long long)(s_lo + r) * sp.L;
    Top3 t{{-INFINITY, -INFINITY, -INFINITY},
           {0x7fffffff, 0x7fffffff, 0x7fffffff}};
    for (int l = lane; l < sp.L; l += 32)   // index increasing
      top3_insert(t, __fadd_rn(sh.pts[14][l] > 0.f ? 0.f : -INFINITY, g[l]),
                  l);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      float k[3];
      int i[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        k[m] = __shfl_xor_sync(FULL, t.k[m], off);
        i[m] = __shfl_xor_sync(FULL, t.i[m], off);
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) top3_insert(t, k[m], i[m]);
    }
    if (lane < 3) hidx[3 * r + lane] = t.i[lane];
  }
  __syncthreads();
  for (int r = tid; r < rows; r += NT) {
    float row[12];
    horn3_rn(sh, hidx + 3 * r, row);
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      hrow[12 * r + i] = row[i];
      hyp_g[12 * (long long)(s_lo + r) + i] = row[i];
    }
  }
  float Pl[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) Pl[i] = scal[8 + i];
  cluster.sync();   // rows in place; every CTA of the cluster is running
  score_cluster<true>(sh, p, hrow, Pl, cluster, rank, crow);
  if (tid >= WG || rank != 0) return;   // rank 0's warpgroup 0 goes on

  int maxc, j, wr = 0;
  cluster_winner(sh, maxc, j);
  while (sh.cs[wr] != j) ++wr;   // the CTA that holds row j
  Chain ch{sh, p, 0};
  solve_chain(ch, crow + 12 * wr, maxc, c.scal, c.res, inl_g);
  wg_bar();
  fuse_scatter(sh, c, lms, sel, sp);
  if (tid < 20) out_g[tid] = c.res[tid];
  wg_bar();
  for (int k = tid; k < sp.K; k += WG) {
    const float4 v = lms[k];
    lm_pts[3 * k] = v.x;
    lm_pts[3 * k + 1] = v.y;
    lm_pts[3 * k + 2] = v.z;
    lm_len[k] = __float_as_int(v.w);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Device pointers are
// allocated by the caller; one cluster of CL CTAs per frame.
extern "C" int fused_solve_launch(const void* pts, const void* hyp,
                                  const void* scal, void* out, void* inl,
                                  int F, int S, int Lp, float thr2,
                                  float reproj, float delta, float min_inliers,
                                  float dt, float max_acc, float ignore_fc,
                                  int degree, int lm_iters, int polish_iters,
                                  int weighted, void* stream) {
  if (F <= 0 || S <= 0 || Lp <= 0 || Lp > MAX_L || Lp % WG)
    return (int)cudaErrorInvalidValue;
  Params p{S, Lp, thr2, reproj, delta, min_inliers, dt, max_acc, ignore_fc,
           degree, lm_iters, polish_iters, weighted};
  fused_solve_kernel<<<F * CL, NT, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)hyp, (const float*)scal, (float*)out,
      (float*)inl, p);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = success). One cluster of CL
// CTAs walks the `pairs` pairs; inter and sel are int32 (pairs, L), lm_pts
// (K, 3) and lm_len (K,) the landmarks after the last pair.
extern "C" int fused_scan_launch(const void* pts, const void* hyp,
                                 const void* inter, const void* sel,
                                 const void* scal0, void* out, void* inl,
                                 void* lm_pts, void* lm_len, int pairs, int S,
                                 int Lp, int L, int K, float thr2,
                                 float reproj, float delta, float min_inliers,
                                 float dt, float max_acc, float ignore_fc,
                                 int degree, int lm_iters, int polish_iters,
                                 int weighted, float gate2, int max_age,
                                 void* stream) {
  if (pairs <= 0 || S <= 0 || Lp <= 0 || Lp > MAX_L || Lp % WG || L <= 0 ||
      L > Lp || K <= 0 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  Params p{S, Lp, thr2, reproj, delta, min_inliers, dt, max_acc, ignore_fc,
           degree, lm_iters, polish_iters, weighted};
  ScanParams sp{L, K, max_age, gate2};
  const int dyn = K * (int)sizeof(float4);
  // the default limit of dynamic shared memory is 48 KB less the static
  // ~40 KB: raised once (the first launch runs before any graph capture)
  static int dyn_set = 0;
  if (dyn > dyn_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
    dyn_set = dyn;
  }
  fused_scan_kernel<<<CL, NT, dyn, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)hyp, (const int*)inter,
      (const int*)sel, (const float*)scal0, (float*)out, (float*)inl,
      (float*)lm_pts, (int*)lm_len, pairs, p, sp);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 = success). One cluster of CL
// CTAs solves one frame: inter (L,) int32 and sel (L,) int64 the lanes'
// previous-frame and keypoint slots, gumbel (S, L), lm_in_pts (K, 3) and
// lm_in_len (K,) the carried landmarks; hyp (S, 12), out (20,), inl (Lp,),
// lm_pts (K, 3) and lm_len (K,) the outputs.
extern "C" int fused_frame_launch(const void* pts, const void* inter,
                                  const void* sel, const void* gumbel,
                                  const void* lm_in_pts,
                                  const void* lm_in_len, const void* scal,
                                  void* hyp, void* out, void* inl,
                                  void* lm_pts, void* lm_len, int S, int Lp,
                                  int L, int K, float thr2, float reproj,
                                  float delta, float min_inliers, float dt,
                                  float max_acc, float ignore_fc, int degree,
                                  int lm_iters, int polish_iters, int weighted,
                                  float gate2, int max_age, void* stream) {
  if (S <= 0 || Lp <= 0 || Lp > MAX_L || Lp % WG || L < 3 || L > Lp ||
      K <= 0 || K > MAX_K)
    return (int)cudaErrorInvalidValue;
  Params p{S, Lp, thr2, reproj, delta, min_inliers, dt, max_acc, ignore_fc,
           degree, lm_iters, polish_iters, weighted};
  ScanParams sp{L, K, max_age, gate2};
  const int dyn = K * (int)sizeof(float4) + ((S + CL - 1) / CL) * 15 * 4;
  static int dyn_set = 0;   // raised once, as for the scan entry
  if (dyn > dyn_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
    dyn_set = dyn;
  }
  fused_frame_kernel<<<CL, NT, dyn, (cudaStream_t)stream>>>(
      (const float*)pts, (const int*)inter, (const long long*)sel,
      (const float*)gumbel, (const float*)lm_in_pts, (const int*)lm_in_len,
      (const float*)scal, (float*)hyp, (float*)out, (float*)inl,
      (float*)lm_pts, (int*)lm_len, p, sp);
  return (int)cudaGetLastError();
}
