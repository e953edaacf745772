// Fused whole-solver kernel for Hopper (sm_90a): RANSAC scoring -> winner
// -> refit -> polish -> gates -> LM (-> optional GLS LM) in ONE launch per
// frame.
//
// Replaces the TPU kernel spsvo_tpu/ops/solver_pallas.py::_solve_kernel
// (wrapper fused_solve). Inputs per frame f (one CTA each):
//   pts  (F, 16, Lp) fp32 rows: Xc(3) Xp(3) uv_pl(2) uv_pr(2) uv_cl(2)
//        uv_cr(2) chain(1) lane_weight(1)       (solver_cuda.pack_points)
//   hyp  (F, S, 12) fp32 [R row-major | t]     (precompute_hypotheses)
//   scal (F, 32) fp32 [q_pred(4) t_pred(3) frame_count(1) P_l(12) P_r(12)]
// Outputs: out (F, 20) fp32 = q(4) t(3) q_pred'(4) t_pred'(3) num_inliers
// pnp_success accel_anomaly lm_improved prior_winner num_chain, and the
// final inlier row inl (F, Lp) fp32.
//
// What bounds it on this card: nothing in bytes or FLOPs. At S=256, L=128
// the whole solve is ~10^6 flops on 8 KB of points; its cost is the chain of
// dependent block-wide reductions (the LM normal equations, Horn sums,
// inlier counts, Huber costs) and the scalar tail between them. Op by op
// it is hundreds of tiny launches per frame; here it is one. Design: 256
// threads; every point row lives in shared memory. Scoring: thread s scores
// hypothesis s against all lanes and keeps its own count (no reduction).
// The first-max argmax over S and every lane sum use a fixed-order tree
// (warp butterfly, then the per-warp partials summed in warp order), so
// results are identical from run to run. The scalar tail (power iteration,
// Shepperd, 6x6 Cholesky, boxplus, lambda schedule, gates) runs redundantly
// and identically in every thread on broadcast sums, in fp32 with sqrtf /
// sinf / cosf (no fast math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
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
  float inl[MAX_L];       // current inlier row
  float cand[MAX_L];      // candidate inlier row
  float red[MAX_RED][NWARP];
  float res[MAX_RED];
  int argc[NWARP], argi[NWARP];
};

// ---- block-wide fixed-order sums ------------------------------------------

template <int N>
__device__ void block_sum(float (&v)[N], Smem& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_xor_sync(FULL, v[i], off);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) sh.red[i][warp] = v[i];
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += sh.red[threadIdx.x][w];
    sh.res[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = sh.res[i];
  __syncthreads();
}

__device__ float block_sum1(float v, Smem& sh) {
  float a[1] = {v};
  block_sum<1>(a, sh);
  return a[0];
}

// ---- scalar helpers (every thread computes the same values) ---------------

__device__ void quat_normalize(float q[4]) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float inv = 1.f / fmaxf(n, 1e-12f);
  for (int i = 0; i < 4; ++i) q[i] *= inv;
}

__device__ void quat_to_R(const float qin[4], float R[9]) {
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
__device__ void matrix_to_quat(const float R[9], float q[4]) {
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
  int best = 0;
  for (int k = 1; k < 4; ++k)
    if (norms[k] > norms[best]) best = k;
  q[0] = c[best][1]; q[1] = c[best][2]; q[2] = c[best][3]; q[3] = c[best][0];
  quat_normalize(q);
}

__device__ void quat_boxplus(const float q[4], const float d[3], float out[4]) {
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
// index i*(i+1)/2 + j for j <= i) by Cholesky.
__device__ void chol_solve6(const float A[21], const float b[6], float x[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j <= i; ++j) {
      float s = A[i * (i + 1) / 2 + j];
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) L[i][i] = sqrtf(fmaxf(s, 1e-24f));
      else L[i][j] = s / L[j][j];
    }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
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

// Writes the inlier row of (R, t) into `row`; returns its count.
__device__ float score_row(Smem& sh, float* row, const float* R,
                           const float* t, const float* Pl, const Params& p) {
  float c = 0.f;
  for (int l = threadIdx.x; l < p.Lp; l += NT) {
    const float m = score_lane(sh, l, R, t, Pl, p.thr2) ? 1.f : 0.f;
    row[l] = m;
    c += m;
  }
  return block_sum1(c, sh);
}

// Weighted rigid alignment Xp ≈ R Xc + t with weights `w` (Horn, 16-step
// shifted power iteration).
__device__ void horn(Smem& sh, const float* w, const Params& p, float q[4],
                     float R[9], float t[3]) {
  float ws = 0.f;
  for (int l = threadIdx.x; l < p.Lp; l += NT) ws += w[l];
  const float wsum = fmaxf(block_sum1(ws, sh), 1e-9f);
  float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int l = threadIdx.x; l < p.Lp; l += NT) {
    const float wn = w[l] / wsum;
    for (int i = 0; i < 6; ++i) c[i] += sh.pts[i][l] * wn;
  }
  block_sum<6>(c, sh);
  float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int l = threadIdx.x; l < p.Lp; l += NT) {
    const float wn = w[l] / wsum;
    float s0[3], d0[3];
    for (int i = 0; i < 3; ++i) {
      s0[i] = sh.pts[i][l] - c[i];
      d0[i] = sh.pts[3 + i][l] - c[3 + i];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) H[3 * i + j] += s0[i] * d0[j] * wn;
  }
  block_sum<9>(H, sh);
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

// Per-factor inputs: factor f in [prev_l, prev_r, inv curr_l, inv curr_r].
__device__ __forceinline__ int uv_row(int f) { return 6 + 2 * f; }

// Lane weight of factor f: mask * (GLS weight for the backward factors).
__device__ __forceinline__ float factor_mask(const Smem& sh, int l, int f,
                                             float mask_scale, bool use_lw) {
  float m = sh.inl[l] * mask_scale;
  if (use_lw && f >= 2) m *= sh.pts[15][l];
  return m;
}

// 0.5 * sum of Huber rho over active factors at pose (q, t).
__device__ float huber_cost(Smem& sh, const float q[4], const float t[3],
                            const float* Pl, const float* Pr, int degree,
                            float delta, float mask_scale, bool use_lw,
                            const Params& p) {
  float R[9];
  quat_to_R(q, R);
  const float d2 = delta * delta;
  float acc = 0.f;
  for (int l = threadIdx.x; l < p.Lp; l += NT) {
    for (int f = 0; f < degree; ++f) {
      const float m = factor_mask(sh, l, f, mask_scale, use_lw);
      if (m == 0.f) continue;
      float X0, X1, X2;
      if (f < 2) {
        const float x0 = sh.pts[0][l], x1 = sh.pts[1][l], x2 = sh.pts[2][l];
        X0 = R[0] * x0 + R[1] * x1 + R[2] * x2 + t[0];
        X1 = R[3] * x0 + R[4] * x1 + R[5] * x2 + t[1];
        X2 = R[6] * x0 + R[7] * x1 + R[8] * x2 + t[2];
      } else {
        const float z0 = sh.pts[3][l] - t[0], z1 = sh.pts[4][l] - t[1],
                    z2 = sh.pts[5][l] - t[2];
        X0 = R[0] * z0 + R[3] * z1 + R[6] * z2;
        X1 = R[1] * z0 + R[4] * z1 + R[7] * z2;
        X2 = R[2] * z0 + R[5] * z1 + R[8] * z2;
      }
      const float* P = (f == 0 || f == 2) ? Pl : Pr;
      float u, v, w;
      project(P, X0, X1, X2, u, v, w);
      const float r0 = u / w - sh.pts[uv_row(f)][l];
      const float r1 = v / w - sh.pts[uv_row(f) + 1][l];
      const float s = r0 * r0 + r1 * r1;
      const float rho =
          s <= d2 ? s : 2.f * delta * sqrtf(fmaxf(s, 1e-20f)) - d2;
      acc += rho * m;
    }
  }
  return 0.5f * block_sum1(acc, sh);
}

// Trace-unrolled LM (lm.refine_pose semantics, without the final revert:
// the caller applies it). Updates q, t; returns `improved`.
__device__ bool lm_iterations(Smem& sh, float q[4], float t[3],
                              const float* Pl, const float* Pr, int degree,
                              float delta, int iters, float mask_scale,
                              bool use_lw, const Params& p) {
  const float c0 =
      huber_cost(sh, q, t, Pl, Pr, degree, delta, mask_scale, use_lw, p);
  float cost = c0, lam = 1e-4f;
  for (int it = 0; it < iters; ++it) {
    float R[9];
    quat_to_R(q, R);
    float acc[27];   // 21 packed lower-triangle H entries, then 6 of g
    for (int i = 0; i < 27; ++i) acc[i] = 0.f;
    for (int l = threadIdx.x; l < p.Lp; l += NT) {
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
        for (int i = 0; i < 3; ++i)
          Z[i] = R[i] * Zv[0] + R[3 + i] * Zv[1] + R[6 + i] * Zv[2];
        // dZ/dδ = 2 R^T [Xp - t]_x
        const float cZ[3][3] = {{0.f, -Zv[2], Zv[1]},
                                {Zv[2], 0.f, -Zv[0]},
                                {-Zv[1], Zv[0], 0.f}};
        for (int i = 0; i < 3; ++i)
          for (int m = 0; m < 3; ++m)
            dZ[i][m] = 2.f * (R[i] * cZ[0][m] + R[3 + i] * cZ[1][m] +
                              R[6 + i] * cZ[2][m]);
      }
      for (int f = 0; f < degree; ++f) {
        const float mf = factor_mask(sh, l, f, mask_scale, use_lw);
        if (mf == 0.f) continue;
        const bool fwd = f < 2;
        const float* X = fwd ? Y : Z;
        const float(*dX)[3] = fwd ? dY : dZ;
        const float* P = (f == 0 || f == 2) ? Pl : Pr;
        float u, v, w;
        project(P, X[0], X[1], X[2], u, v, w);
        const float pi0 = u / w, pi1 = v / w;
        const float r0 = pi0 - sh.pts[uv_row(f)][l];
        const float r1 = pi1 - sh.pts[uv_row(f) + 1][l];
        float JA[2][3];
        for (int c = 0; c < 3; ++c) {
          JA[0][c] = (P[c] - pi0 * P[8 + c]) / w;
          JA[1][c] = (P[4 + c] - pi1 * P[8 + c]) / w;
        }
        float J[2][6];
        for (int r = 0; r < 2; ++r) {
          for (int m = 0; m < 3; ++m)
            J[r][m] = JA[r][0] * dX[0][m] + JA[r][1] * dX[1][m] +
                      JA[r][2] * dX[2][m];
          for (int m = 0; m < 3; ++m)
            J[r][3 + m] = fwd ? JA[r][m]
                              : -(JA[r][0] * R[3 * m] + JA[r][1] * R[3 * m + 1] +
                                  JA[r][2] * R[3 * m + 2]);
        }
        const float nrm = sqrtf(r0 * r0 + r1 * r1);
        const float wh = fminf(1.f, delta / fmaxf(nrm, 1e-12f)) * mf;
        int k = 0;
        for (int a = 0; a < 6; ++a)
          for (int b = 0; b <= a; ++b, ++k)
            acc[k] += wh * (J[0][a] * J[0][b] + J[1][a] * J[1][b]);
        for (int a = 0; a < 6; ++a)
          acc[21 + a] += wh * (J[0][a] * r0 + J[1][a] * r1);
      }
    }
    block_sum<27>(acc, sh);
    float A[21];
    for (int i = 0; i < 21; ++i) A[i] = acc[i];
    for (int i = 0; i < 6; ++i) {
      const int d = i * (i + 1) / 2 + i;
      A[d] = acc[d] + lam * acc[d] + 1e-9f;
    }
    float step[6];
    chol_solve6(A, acc + 21, step);
    const float dr[3] = {-step[0], -step[1], -step[2]};
    float q_new[4];
    quat_boxplus(q, dr, q_new);
    const float t_new[3] = {t[0] - step[3], t[1] - step[4], t[2] - step[5]};
    const float cost_new = huber_cost(sh, q_new, t_new, Pl, Pr, degree, delta,
                                      mask_scale, use_lw, p);
    const bool accept = cost_new < cost;
    if (accept) {
      for (int i = 0; i < 4; ++i) q[i] = q_new[i];
      for (int i = 0; i < 3; ++i) t[i] = t_new[i];
      lam = fmaxf(lam * 0.5f, 1e-9f);
      cost = cost_new;
    } else {
      lam = fminf(lam * 4.f, 1e6f);
    }
  }
  return cost < c0;
}

__global__ void __launch_bounds__(NT)
fused_solve_kernel(const float* __restrict__ pts_g,
                   const float* __restrict__ hyp_g,
                   const float* __restrict__ scal_g, float* __restrict__ out_g,
                   float* __restrict__ inl_g, Params p) {
  __shared__ Smem sh;
  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const float* pts = pts_g + (long long)f * 16 * p.Lp;
  const float* hyp = hyp_g + (long long)f * p.S * 12;
  const float* scal = scal_g + (long long)f * 32;

  for (int i = tid; i < 16 * p.Lp; i += NT) sh.pts[i / p.Lp][i % p.Lp] = pts[i];
  __syncthreads();

  float q_pred[4], t_pred[3], Pl[12], Pr[12];
  for (int i = 0; i < 4; ++i) q_pred[i] = scal[i];
  for (int i = 0; i < 3; ++i) t_pred[i] = scal[4 + i];
  const float fc = scal[7];
  for (int i = 0; i < 12; ++i) { Pl[i] = scal[8 + i]; Pr[i] = scal[20 + i]; }

  // ---- score the S sampled hypotheses: thread s owns hypothesis s --------
  int best_c = -1, best_s = 0x7fffffff;
  for (int s = tid; s < p.S; s += NT) {
    const float* h = hyp + 12 * s;
    int c = 0;
    for (int l = 0; l < p.Lp; ++l)
      c += score_lane(sh, l, h, h + 9, Pl, p.thr2) ? 1 : 0;
    if (c > best_c) { best_c = c; best_s = s; }   // s increasing: first max
  }
  // first-max argmax: lexicographic (count desc, index asc)
  for (int off = 16; off > 0; off >>= 1) {
    const int oc = __shfl_xor_sync(FULL, best_c, off);
    const int os = __shfl_xor_sync(FULL, best_s, off);
    if (oc > best_c || (oc == best_c && os < best_s)) { best_c = oc; best_s = os; }
  }
  if ((tid & 31) == 0) { sh.argc[tid >> 5] = best_c; sh.argi[tid >> 5] = best_s; }
  __syncthreads();
  int maxc = sh.argc[0], j = sh.argi[0];
  for (int w = 1; w < NWARP; ++w)
    if (sh.argc[w] > maxc || (sh.argc[w] == maxc && sh.argi[w] < j)) {
      maxc = sh.argc[w];
      j = sh.argi[w];
    }
  __syncthreads();

  // ---- prior lane vs winner (sampled lanes win ties) ---------------------
  float R[9], t[3];
  quat_to_R(q_pred, R);
  const float count_prior = score_row(sh, sh.cand, R, t_pred, Pl, p);
  const bool sampled = (float)maxc >= count_prior;
  if (sampled) {
    const float* h = hyp + 12 * j;
    for (int i = 0; i < 9; ++i) R[i] = h[i];
    for (int i = 0; i < 3; ++i) t[i] = h[9 + i];
    score_row(sh, sh.inl, R, t, Pl, p);
  } else {
    for (int i = 0; i < 3; ++i) t[i] = t_pred[i];
    for (int l = tid; l < p.Lp; l += NT) sh.inl[l] = sh.cand[l];
    __syncthreads();
  }

  // ---- refit (2x weighted Horn) + polish ----------------------------------
  for (int rep = 0; rep < 2; ++rep) {
    float q2[4], R2[9], t2[3];
    horn(sh, sh.inl, p, q2, R2, t2);
    const float n2 = score_row(sh, sh.cand, R2, t2, Pl, p);
    float ni = 0.f;
    for (int l = tid; l < p.Lp; l += NT) ni += sh.inl[l];
    const float n1 = block_sum1(ni, sh);
    if (n2 >= n1 && n1 > 0.f) {   // zero-inlier guard
      for (int i = 0; i < 9; ++i) R[i] = R2[i];
      for (int i = 0; i < 3; ++i) t[i] = t2[i];
      for (int l = tid; l < p.Lp; l += NT) sh.inl[l] = sh.cand[l];
      __syncthreads();
    }
  }
  float q_raw[4], t_raw[3];
  matrix_to_quat(R, q_raw);
  for (int i = 0; i < 3; ++i) t_raw[i] = t[i];
  {
    // polish: degree-1 LM on the prev-left factor, delta = reproj threshold
    float q_p[4] = {q_raw[0], q_raw[1], q_raw[2], q_raw[3]};
    float t_p[3] = {t_raw[0], t_raw[1], t_raw[2]};
    const bool improved = lm_iterations(sh, q_p, t_p, Pl, Pl, 1, p.reproj,
                                        p.polish_iters, 1.f, false, p);
    if (!improved) {
      for (int i = 0; i < 4; ++i) q_p[i] = q_raw[i];
      for (int i = 0; i < 3; ++i) t_p[i] = t_raw[i];
    }
    float R_p[9];
    quat_to_R(q_p, R_p);
    const float np_ = score_row(sh, sh.cand, R_p, t_p, Pl, p);
    float ni = 0.f;
    for (int l = tid; l < p.Lp; l += NT) ni += sh.inl[l];
    const float n1 = block_sum1(ni, sh);
    if (np_ >= n1 && n1 > 0.f) {
      for (int i = 0; i < 4; ++i) q_raw[i] = q_p[i];
      for (int i = 0; i < 3; ++i) t_raw[i] = t_p[i];
      for (int l = tid; l < p.Lp; l += NT) sh.inl[l] = sh.cand[l];
      __syncthreads();
    }
  }
  float ni = 0.f, nc = 0.f;
  for (int l = tid; l < p.Lp; l += NT) { ni += sh.inl[l]; nc += sh.pts[14][l]; }
  float sums[2] = {ni, nc};
  block_sum<2>(sums, sh);
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
    const bool improved = lm_iterations(sh, q_l, t_l, Pl, Pr, p.degree,
                                        p.delta, p.lm_iters, opt, weighted, p);
    if (improved && do_opt) {
      for (int i = 0; i < 4; ++i) q[i] = q_l[i];
      for (int i = 0; i < 3; ++i) tt[i] = t_l[i];
    }
    if (!weighted) lm_improved = improved && do_opt;
  }

  if (tid == 0) {
    float* o = out_g + (long long)f * 20;
    for (int i = 0; i < 4; ++i) { o[i] = q[i]; o[7 + i] = q_pn[i]; }
    for (int i = 0; i < 3; ++i) { o[4 + i] = tt[i]; o[11 + i] = t_pn[i]; }
    o[14] = num;
    o[15] = success ? 1.f : 0.f;
    o[16] = anomaly ? 1.f : 0.f;
    o[17] = lm_improved ? 1.f : 0.f;
    o[18] = sampled ? 0.f : 1.f;
    o[19] = num_chain;
  }
  for (int l = tid; l < p.Lp; l += NT) inl_g[(long long)f * p.Lp + l] = sh.inl[l];
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Device pointers are
// allocated by the caller; one CTA per frame.
extern "C" int fused_solve_launch(const void* pts, const void* hyp,
                                  const void* scal, void* out, void* inl,
                                  int F, int S, int Lp, float thr2,
                                  float reproj, float delta, float min_inliers,
                                  float dt, float max_acc, float ignore_fc,
                                  int degree, int lm_iters, int polish_iters,
                                  int weighted, void* stream) {
  if (F <= 0 || S <= 0 || Lp <= 0 || Lp > MAX_L)
    return (int)cudaErrorInvalidValue;
  Params p{S, Lp, thr2, reproj, delta, min_inliers, dt, max_acc, ignore_fc,
           degree, lm_iters, polish_iters, weighted};
  fused_solve_kernel<<<F, NT, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)hyp, (const float*)scal, (float*)out,
      (float*)inl, p);
  return (int)cudaGetLastError();
}
