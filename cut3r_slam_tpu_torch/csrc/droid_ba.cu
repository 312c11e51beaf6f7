// DROID's dense bundle adjustment, one Gauss-Newton step on the card.
//
// Replaces no TPU kernel: the JAX package's BA (cut3r_slam_tpu/ops/ba.py)
// is plain XLA. Added because the port's plain step
// (ops/ba.py::bundle_adjust on the CPU) runs ~250 small torch operators a
// step on the card, batched 2x6 / 6x6 cuBLAS products over every pixel of
// every edge and a dense Schur product over an E that is mostly zero
// blocks. The design follows DROID-SLAM's own CUDA BA
// (princeton-vl/DROID-SLAM, src/droid_kernels.cu): each edge's Jacobians
// are reduced inside one block, and the Schur complement is formed from
// the nonzero blocks of E only.
//
// The mathematics is the plain step's (ops/ba.py): the residuals
// (target - coords) * valid * ev, the weights 0.001 * (valid * weight) * ev,
// Ji = -Jj Ad(g_ij), Jz = Jp (t, 1), validity Z > MIN_DEPTH; the damping
// H + diag(ep + lm * diag H); C = (sum Ck + eta) + 1e-7, Q = 1 / C; the
// Schur solve with its guards (a failed factorization or a non-finite dx
// gives dx = 0, so dz = Q w; a non-finite dz is 0); the SE(3) retraction
// exp(dx) * g of the free poses and the disparity clamp (> 10 -> 0,
// at least 0.001); the depth covariance diag(Q) + ||L^-1 E Q||^2 by column
// on the step that asks for it (NaN where the factorization failed).
//
// What bounds it on the H100: memory. Per step it writes and reads back
// each edge's per-pixel E terms (2 x 6 floats a pixel, ~43 MB at 290 edges
// of 48x64) and the dense E blocks (P x P0 x 6 x HW floats, ~28 MB), which
// the Schur product then reads from L2 about as often as a block row has
// nonzero blocks. The FP32 operations (~1 GFLOP a step) come second; the
// Cholesky factor of the 6P x 6P Schur complement runs in one block and is
// bound by its P sequential block columns, two block barriers each.
//
// Launches, all on the caller's stream, no host read, no floating-point
// atomics (every sum is taken in a fixed order, so a rerun is bitwise):
// 0. ba_plan_kernel (a call's first step), one thread per edge: the output
//    cell of each per-edge contribution (ops/ba.py::ba_plan).
// 1. ba_edge_kernel, one block per edge: the relative pose once, then each
//    thread's pixels in registers (projection, validity, residual, Ji, Jj,
//    Jz); the edge's 6x6 blocks Hii, Hij, Hji, Hjj and vectors vi, vj,
//    reduced by warp shuffles then across warps in warp order; per pixel
//    Ei, Ej (6 each), Ck and wk.
// 2. ba_gather_kernel: the per-edge terms summed into the dense H (P x P
//    blocks), v, E (P x P0 blocks), C and w (P0 frames) by the plan: each
//    output cell's contributions are found by warp ballots over the plan
//    and added in ascending contribution order; every output element is
//    written (zero where no contribution lands), with each E block's
//    contribution count (nzE) beside it.
// 3. ba_schur_kernel, one block per pair b <= a of free frames and one per
//    right-hand-side row: S_ab = H_ab (damped) - sum over the depth frames
//    k with nonzero E_ak and E_bk of E_ak Q_k E_bk^T, and
//    rhs_a = v_a - sum_k E_ak Q_k w_k.
// 4. ba_solve_kernel, one block: a blocked Cholesky factor of S bordered
//    by the right-hand side (so the forward substitution comes with it),
//    in shared memory when it fits, the back substitution, the guards and
//    the pose retraction.
// 5. ba_update_kernel, one thread per depth pixel: dz = Q (w - E^T dx),
//    zeroed where not finite, and the disparity retraction.
// 6. ba_cov_kernel (the covariance step only), one thread per depth pixel:
//    forward substitution of the pixel's column of E Q through L.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MIN_DEPTH = 0.2f;     // geometry/projective.py
constexpr unsigned FULL = 0xffffffffu;
constexpr int EDGE_THREADS = 256;
constexpr int EDGE_WARPS = EDGE_THREADS / 32;
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_WARPS = GATHER_THREADS / 32;
constexpr int GATHER_PER = 8;         // elements a lane sums (E, C rows)
constexpr int GATHER_CHUNK = GATHER_THREADS * GATHER_PER;
constexpr int SCHUR_THREADS = 256;
constexpr int SCHUR_WARPS = SCHUR_THREADS / 32;
constexpr int SOLVE_THREADS = 1024;
constexpr int UPDATE_THREADS = 256;
constexpr int COV_THREADS = 32;
constexpr int NACC = 90;              // Hii 21, Hij 36, Hjj 21, vi 6, vj 6

// the upper triangle (a <= b) of a 6x6 block, row by row
__constant__ int UT_A[21] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                             2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ int UT_B[21] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                             2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// geometry/quaternion.py, xyzw
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float out[3]) {
  float t[3], c[3];
  cross3(q, v, t);
  t[0] *= 2.0f;
  t[1] *= 2.0f;
  t[2] *= 2.0f;
  cross3(q, t, c);
  for (int k = 0; k < 3; ++k) out[k] = v[k] + q[3] * t[k] + c[k];
}

__device__ __forceinline__ void quat_multiply(const float a[4],
                                              const float b[4], float o[4]) {
  o[0] = a[3] * b[0] + a[0] * b[3] + a[1] * b[2] - a[2] * b[1];
  o[1] = a[3] * b[1] - a[0] * b[2] + a[1] * b[3] + a[2] * b[0];
  o[2] = a[3] * b[2] + a[0] * b[1] - a[1] * b[0] + a[2] * b[3];
  o[3] = a[3] * b[3] - a[0] * b[0] - a[1] * b[1] - a[2] * b[2];
}

__device__ __forceinline__ void quat_normalize(float q[4]) {
  float s = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3] +
                  1e-24f);
  for (int k = 0; k < 4; ++k) q[k] = q[k] / s;
}

__device__ __forceinline__ void quat_to_matrix(const float q[4],
                                               float R[3][3]) {
  float x = q[0], y = q[1], z = q[2], w = q[3];
  float xx = x * x, yy = y * y, zz = z * z;
  float xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
}

// geometry/lie.py::se3_retr: exp(xi) * g, xi = [tau, phi]
__device__ void se3_retract(const float xi[6], const float g[7],
                            float out[7]) {
  const float* tau = xi;
  const float* phi = xi + 3;
  float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  float th = sqrtf(fmaxf(th2, 1e-24f));
  bool small = th2 < 1e-8f;
  float k = small ? 0.5f - th2 / 48.0f : sinf(0.5f * th) / th;
  float qe[4] = {phi[0] * k, phi[1] * k, phi[2] * k,
                 small ? 1.0f - th2 / 8.0f : cosf(0.5f * th)};
  float a = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / th2;
  float b = small ? 1.0f / 6.0f - th2 / 120.0f : (th - sinf(th)) / (th2 * th);
  float c1[3], c2[3];
  cross3(phi, tau, c1);
  cross3(phi, c1, c2);
  float te[3];
  for (int m = 0; m < 3; ++m) te[m] = tau[m] + a * c1[m] + b * c2[m];
  // se3_mul(exp, g)
  float rt[3];
  quat_rotate(qe, g, rt);
  for (int m = 0; m < 3; ++m) out[m] = te[m] + rt[m];
  float q[4];
  quat_multiply(qe, g + 3, q);
  quat_normalize(q);
  for (int m = 0; m < 4; ++m) out[3 + m] = q[m];
}

// ---------------------------------------------------------------------------
// 0. the plan (ops/ba.py::ba_plan is its plain version): the output cell of
// each of the 9E per-edge contributions, -1 where it is dropped
// ---------------------------------------------------------------------------
__global__ void ba_plan_kernel(const long long* __restrict__ ii,
                               const long long* __restrict__ jj, int E,
                               int fixedp, int P0, int* __restrict__ cells) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long P = P0 - fixedp, i = ii[e], ai = i - fixedp,
                  aj = jj[e] - fixedp;
  const bool fi = ai >= 0 && ai < P, fj = aj >= 0 && aj < P,
             ki = i >= 0 && i < P0;
  cells[e] = fi ? (int)(ai * P + ai) : -1;
  cells[E + e] = fi && fj ? (int)(ai * P + aj) : -1;
  cells[2 * E + e] = fi && fj ? (int)(aj * P + ai) : -1;
  cells[3 * E + e] = fj ? (int)(aj * P + aj) : -1;
  cells[4 * E + e] = fi ? (int)ai : -1;
  cells[5 * E + e] = fj ? (int)aj : -1;
  cells[6 * E + e] = fi && ki ? (int)(ai * P0 + i) : -1;
  cells[7 * E + e] = fj && ki ? (int)(aj * P0 + i) : -1;
  cells[8 * E + e] = ki ? (int)i : -1;
}

// ---------------------------------------------------------------------------
// 1. per-edge terms
// HB (4, E, 36): Hii, Hij, Hji, Hjj; VB (2, E, 6): vi, vj;
// EB (2, E, 6, HW): Ei, Ej; CW (E, 2, HW): Ck, wk.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(EDGE_THREADS)
ba_edge_kernel(const float* __restrict__ poses,
               const float* __restrict__ disps,
               const float* __restrict__ intr,
               const float2* __restrict__ target,
               const float2* __restrict__ weight,
               const float* __restrict__ ev,
               const long long* __restrict__ ii,
               const long long* __restrict__ jj, int E, int P0, int HW,
               int wd, float* __restrict__ HB, float* __restrict__ VB,
               float* __restrict__ EB, float* __restrict__ CW) {
  __shared__ float red[EDGE_WARPS][NACC];
  const int e = blockIdx.x;
  if (e >= E) return;
  // an edge out of the window reads frame 0 and weighs nothing (the plan
  // drops its cells too)
  const bool inside = ii[e] >= 0 && ii[e] < P0 && jj[e] >= 0 && jj[e] < P0;
  const int i = inside ? (int)ii[e] : 0, j = inside ? (int)jj[e] : 0;
  // g_ij = g_j * g_i^-1 (se3_mul(gj, se3_inv(gi))), then se3_matrix
  const float* gi = poses + 7 * i;
  const float* gj = poses + 7 * j;
  float qinv[4] = {-gi[3], -gi[4], -gi[5], gi[6]};
  float tinv[3];
  quat_rotate(qinv, gi, tinv);
  for (int m = 0; m < 3; ++m) tinv[m] = -tinv[m];
  float rt[3];
  quat_rotate(gj + 3, tinv, rt);
  float t[3] = {gj[0] + rt[0], gj[1] + rt[1], gj[2] + rt[2]};
  float q[4];
  quat_multiply(gj + 3, qinv, q);
  quat_normalize(q);
  quat_normalize(q);
  float R[3][3];
  quat_to_matrix(q, R);
  // hat(t) R, the adjoint's upper-right block
  float tR[3][3];
  for (int c = 0; c < 3; ++c) {
    tR[0][c] = -t[2] * R[1][c] + t[1] * R[2][c];
    tR[1][c] = t[2] * R[0][c] - t[0] * R[2][c];
    tR[2][c] = -t[1] * R[0][c] + t[0] * R[1][c];
  }
  const float fxi = intr[4 * i], fyi = intr[4 * i + 1];
  const float cxi = intr[4 * i + 2], cyi = intr[4 * i + 3];
  const float fxj = intr[4 * j], fyj = intr[4 * j + 1];
  const float cxj = intr[4 * j + 2], cyj = intr[4 * j + 3];
  const float evf = inside ? ev[e] : 0.0f;
  const float* di = disps + (size_t)i * HW;
  const float2* tg = target + (size_t)e * HW;
  const float2* wt = weight + (size_t)e * HW;
  float* Ei = EB + (size_t)e * 6 * HW;
  float* Ej = EB + ((size_t)E + e) * 6 * HW;
  float* Ck = CW + (size_t)e * 2 * HW;
  float* wk = Ck + HW;

  float acc[NACC];
#pragma unroll
  for (int m = 0; m < NACC; ++m) acc[m] = 0.0f;

  for (int p = threadIdx.x; p < HW; p += EDGE_THREADS) {
    const float u = (float)(p % wd), v = (float)(p / wd);
    const float x = (u - cxi) / fxi, y = (v - cyi) / fyi;
    const float d = di[p];
    const float X = R[0][0] * x + R[0][1] * y + R[0][2] + d * t[0];
    const float Y = R[1][0] * x + R[1][1] * y + R[1][2] + d * t[1];
    const float Z = R[2][0] * x + R[2][1] * y + R[2][2] + d * t[2];
    const float Zc = Z < 0.5f * MIN_DEPTH ? 1.0f : Z;
    const float id = 1.0f / Zc;
    const float cu = fxj * (X * id) + cxj, cv = fyj * (Y * id) + cyj;
    const float valid = Z > MIN_DEPTH ? 1.0f : 0.0f;
    const float2 tv = tg[p], wv = wt[p];
    const float r0 = (tv.x - cu) * valid * evf, r1 = (tv.y - cv) * valid * evf;
    const float w0 = 0.001f * (valid * wv.x) * evf;
    const float w1 = 0.001f * (valid * wv.y) * evf;
    // Jp rows (a, 0, b, 0) and (0, a, b, 0)
    const float a0 = fxj * id, b0 = -fxj * X * id * id;
    const float a1 = fyj * id, b1 = -fyj * Y * id * id;
    const float Jj0[6] = {a0 * d, 0.0f, b0 * d, b0 * Y, a0 * Z - b0 * X,
                          -a0 * Y};
    const float Jj1[6] = {0.0f, a1 * d, b1 * d, -a1 * Z + b1 * Y, -b1 * X,
                          a1 * X};
    float Ji0[6], Ji1[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Ji0[c] = -(Jj0[0] * R[0][c] + Jj0[1] * R[1][c] + Jj0[2] * R[2][c]);
      Ji1[c] = -(Jj1[0] * R[0][c] + Jj1[1] * R[1][c] + Jj1[2] * R[2][c]);
      Ji0[3 + c] = -(Jj0[0] * tR[0][c] + Jj0[1] * tR[1][c] +
                     Jj0[2] * tR[2][c] + Jj0[3] * R[0][c] +
                     Jj0[4] * R[1][c] + Jj0[5] * R[2][c]);
      Ji1[3 + c] = -(Jj1[0] * tR[0][c] + Jj1[1] * tR[1][c] +
                     Jj1[2] * tR[2][c] + Jj1[3] * R[0][c] +
                     Jj1[4] * R[1][c] + Jj1[5] * R[2][c]);
    }
    const float z0 = a0 * t[0] + b0 * t[2], z1 = a1 * t[1] + b1 * t[2];
    float wi0[6], wi1[6], wj0[6], wj1[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      wi0[c] = w0 * Ji0[c];
      wi1[c] = w1 * Ji1[c];
      wj0[c] = w0 * Jj0[c];
      wj1[c] = w1 * Jj1[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        const int m = 6 * a - a * (a - 1) / 2 + (b - a);   // UT_A / UT_B
        acc[m] += wi0[a] * Ji0[b] + wi1[a] * Ji1[b];
        acc[57 + m] += wj0[a] * Jj0[b] + wj1[a] * Jj1[b];
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b)
        acc[21 + 6 * a + b] += wi0[a] * Jj0[b] + wi1[a] * Jj1[b];
      acc[78 + a] += wi0[a] * r0 + wi1[a] * r1;
      acc[84 + a] += wj0[a] * r0 + wj1[a] * r1;
      Ei[a * HW + p] = wi0[a] * z0 + wi1[a] * z1;
      Ej[a * HW + p] = wj0[a] * z0 + wj1[a] * z1;
    }
    Ck[p] = w0 * z0 * z0 + w1 * z1 * z1;
    wk[p] = w0 * r0 * z0 + w1 * r1 * z1;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < NACC; ++m) {
    const float s = warp_sum(acc[m]);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int m = threadIdx.x;
  if (m >= NACC) return;
  float s = 0.0f;
  for (int w = 0; w < EDGE_WARPS; ++w) s += red[w][m];
  if (m < 21) {
    const int a = UT_A[m], b = UT_B[m];
    float* o = HB + (size_t)e * 36;
    o[6 * a + b] = s;
    o[6 * b + a] = s;
  } else if (m < 57) {
    const int a = (m - 21) / 6, b = (m - 21) % 6;
    HB[((size_t)E + e) * 36 + 6 * a + b] = s;
    HB[((size_t)2 * E + e) * 36 + 6 * b + a] = s;
  } else if (m < 78) {
    const int a = UT_A[m - 57], b = UT_B[m - 57];
    float* o = HB + ((size_t)3 * E + e) * 36;
    o[6 * a + b] = s;
    o[6 * b + a] = s;
  } else if (m < 84) {
    VB[(size_t)e * 6 + (m - 78)] = s;
  } else {
    VB[((size_t)E + e) * 6 + (m - 84)] = s;
  }
}

// ---------------------------------------------------------------------------
// 2. the gather by the plan
// ---------------------------------------------------------------------------

// Sums, into the PER elements base + k * stride + lane (k < PER) of an
// output row, the rows src[c] (row width `width`) of every contribution
// c < n whose plan cell is `cell`, in ascending c. Every lane of the warp
// takes part (the ballots), whatever its elements. Returns the count.
template <int PER>
__device__ __forceinline__ int gather_rows(const int* __restrict__ cells,
                                           int n, int cell,
                                           const float* __restrict__ src,
                                           long long width, long long base,
                                           int stride, float acc[PER]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.0f;
  int count = 0;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int c = c0 + lane;
    unsigned hit = __ballot_sync(FULL, c < n && cells[c] == cell);
    count += __popc(hit);
    while (hit) {
      const int b = __ffs(hit) - 1;
      hit &= hit - 1;
      const float* row = src + (long long)(c0 + b) * width;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const long long x = base + (long long)k * stride + lane;
        if (x < width) acc[k] += row[x];
      }
    }
  }
  return count;
}

// Blocks: [0, nbE) E blocks (cell, chunk); [nbE, nbE + nbC) C / w
// (frame, chunk); then H cells and v cells, a warp each.
__global__ void __launch_bounds__(GATHER_THREADS)
ba_gather_kernel(const int* __restrict__ cells, int E, int P, int P0, int HW,
                 const float* __restrict__ HB, const float* __restrict__ VB,
                 const float* __restrict__ EB, const float* __restrict__ CW,
                 const float* __restrict__ eta, float* __restrict__ H,
                 float* __restrict__ v, float* __restrict__ Ed,
                 int* __restrict__ nzE, float* __restrict__ Q,
                 float* __restrict__ w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wE = 6LL * HW, wC = 2LL * HW;
  const int chE = (int)((wE + GATHER_CHUNK - 1) / GATHER_CHUNK);
  const int chC = (int)((wC + GATHER_CHUNK - 1) / GATHER_CHUNK);
  const int nbE = P * P0 * chE, nbC = P0 * chC;
  const int nbH = (P * P + GATHER_WARPS - 1) / GATHER_WARPS;
  int b = blockIdx.x;
  const int* cH = cells;
  const int* cV = cells + 4 * E;
  const int* cE = cells + 6 * E;
  const int* cC = cells + 8 * E;
  float acc[GATHER_PER];
  if (b < nbE) {
    const int cell = b / chE, chunk = b % chE;
    const long long base = (long long)chunk * GATHER_CHUNK + warp * 32 *
                           GATHER_PER;
    const int n = gather_rows<GATHER_PER>(cE, 2 * E, cell, EB, wE, base, 32,
                                          acc);
    float* o = Ed + (long long)cell * wE;
#pragma unroll
    for (int k = 0; k < GATHER_PER; ++k) {
      const long long x = base + k * 32 + lane;
      if (x < wE) o[x] = acc[k];
    }
    if (chunk == 0 && threadIdx.x == 0) nzE[cell] = n;
    return;
  }
  b -= nbE;
  if (b < nbC) {
    const int k0 = b / chC, chunk = b % chC;
    const long long base = (long long)chunk * GATHER_CHUNK + warp * 32 *
                           GATHER_PER;
    gather_rows<GATHER_PER>(cC, E, k0, CW, wC, base, 32, acc);
#pragma unroll
    for (int k = 0; k < GATHER_PER; ++k) {
      const long long x = base + k * 32 + lane;
      if (x < HW) {
        const long long at = (long long)k0 * HW + x;
        Q[at] = 1.0f / ((acc[k] + eta[at]) + 1e-7f);
      } else if (x < wC) {
        w[(long long)k0 * HW + (x - HW)] = acc[k];
      }
    }
    return;
  }
  b -= nbC;
  if (b < nbH) {
    const int cell = b * GATHER_WARPS + warp;
    if (cell >= P * P) return;      // a whole warp
    float a2[2];
    gather_rows<2>(cH, 4 * E, cell, HB, 36, 0, 32, a2);
    H[(long long)cell * 36 + lane] = a2[0];
    if (lane < 4) H[(long long)cell * 36 + 32 + lane] = a2[1];
    return;
  }
  b -= nbH;
  const int cell = b * GATHER_WARPS + warp;
  if (cell >= P) return;
  float a1[1];
  gather_rows<1>(cV, 2 * E, cell, VB, 6, 0, 32, a1);
  if (lane < 6) v[(long long)cell * 6 + lane] = a1[0];
}

// ---------------------------------------------------------------------------
// 3. the Schur complement over the nonzero E blocks
// ---------------------------------------------------------------------------
// grid (P + 1, P): block (b, a) with b <= a forms S_ab and S_ba; b == P the
// right-hand side of row a; the others return at once.
__global__ void __launch_bounds__(SCHUR_THREADS)
ba_schur_kernel(const float* __restrict__ H, const float* __restrict__ v,
                const float* __restrict__ Ed, const int* __restrict__ nzE,
                const float* __restrict__ Q, const float* __restrict__ w,
                int P, int P0, int HW, float ep, float lm,
                float* __restrict__ S, float* __restrict__ rhs) {
  __shared__ float red[SCHUR_WARPS][36];
  const int b = blockIdx.x, a = blockIdx.y;
  if (a >= P || (b < P && b > a)) return;
  const bool side = b == P;
  const int n = 6 * P;
  const long long wE = 6LL * HW;
  float acc[36];
#pragma unroll
  for (int m = 0; m < 36; ++m) acc[m] = 0.0f;
  for (int k = 0; k < P0; ++k) {
    if (nzE[a * P0 + k] == 0 || (!side && nzE[b * P0 + k] == 0)) continue;
    const float* ea = Ed + (long long)(a * P0 + k) * wE;
    const float* eb = side ? nullptr : Ed + (long long)(b * P0 + k) * wE;
    const float* qk = Q + (long long)k * HW;
    const float* wk = w + (long long)k * HW;
    for (int p = threadIdx.x; p < HW; p += SCHUR_THREADS) {
      const float qq = qk[p];
      float tq[6];
#pragma unroll
      for (int d = 0; d < 6; ++d) tq[d] = ea[d * HW + p] * qq;
      if (side) {
        const float ww = wk[p];
#pragma unroll
        for (int d = 0; d < 6; ++d) acc[d] += tq[d] * ww;
      } else {
        float eB[6];
#pragma unroll
        for (int d = 0; d < 6; ++d) eB[d] = eb[d * HW + p];
#pragma unroll
        for (int d1 = 0; d1 < 6; ++d1)
#pragma unroll
          for (int d2 = 0; d2 < 6; ++d2) acc[6 * d1 + d2] += tq[d1] * eB[d2];
      }
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < 36; ++m) {
    const float s = warp_sum(acc[m]);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int m = threadIdx.x;
  if (m >= (side ? 6 : 36)) return;
  float s = 0.0f;
  for (int wp = 0; wp < SCHUR_WARPS; ++wp) s += red[wp][m];
  if (side) {
    rhs[6 * a + m] = v[6 * a + m] - s;
    return;
  }
  const int d1 = m / 6, d2 = m % 6;
  float h = H[(long long)(a * P + b) * 36 + m];
  if (a == b && d1 == d2) h = h + (ep + lm * h);
  const float val = h - s;
  S[(long long)(6 * a + d1) * n + 6 * b + d2] = val;
  if (a != b) S[(long long)(6 * b + d2) * n + 6 * a + d1] = val;
}

// ---------------------------------------------------------------------------
// 4. the factor, the solve, the guards and the pose retraction (one block)
// ---------------------------------------------------------------------------
// packed lower-triangle index (n stays far below 46,340)
__host__ __device__ __forceinline__ int tri(int r, int c) {
  return r * (r + 1) / 2 + c;
}

// After the factor and the solves (x, n floats, valid when ok_factor),
// every thread of the block: the guards (a failed factor or a non-finite x
// gives dx = 0), the status (0, or 1 for a failed factor) and the poses,
// exp(dx) * g for the free ones, copied for the fixed.
__device__ void solve_finish(int n, bool ok_factor, const float* x,
                             const float* __restrict__ poses_in,
                             float* __restrict__ poses_out, int P0,
                             int fixedp, float* __restrict__ dx,
                             int* __restrict__ status) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    bool finite = true;
    if (ok_factor)
      for (int r = lane; r < n; r += 32) finite = finite && isfinite(x[r]);
    const bool ok = ok_factor && __all_sync(FULL, finite);
    for (int r = lane; r < n; r += 32) dx[r] = ok ? x[r] : 0.0f;
    if (lane == 0) *status = ok_factor ? 0 : 1;
  }
  __syncthreads();
  for (int f = tid; f < P0; f += blockDim.x) {
    const float* g = poses_in + 7 * f;
    float* o = poses_out + 7 * f;
    if (f < fixedp) {
      for (int m = 0; m < 7; ++m) o[m] = g[m];
    } else {
      float xi[6];
      for (int m = 0; m < 6; ++m) xi[m] = dx[6 * (f - fixedp) + m];
      se3_retract(xi, g, o);
    }
  }
}

__device__ __forceinline__ int tri_row(int t) {
  int r = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (tri(r, 0) > t) --r;
  while (tri(r + 1, 0) <= t) ++r;
  return r;
}

// A blocked right-looking Cholesky of S bordered by rhs as its last row n,
// [[S, .], [rhs^T, .]], in blocks of one pose (6 columns): the factor's
// rows 0..n-1 are L and its row n is y = L^-1 rhs. Per block column, two
// block barriers: (1) every thread factors the 6x6 diagonal block in its
// registers (the same reads, so the same factor and the same verdict on
// it), and a thread per row below it solves the row's 6 entries against
// it; (2) a warp per row applies the block's rank-6 update to the trailing
// rows, while thread 0 stores the diagonal block's factor. Then x = L^-T y
// a block at a time from the last (six warps form the block's right-hand
// side, one thread solves the 6x6). The packed rows 0..n live in shared
// memory when `in_smem`, else in place in Lp ((n + 1) (n + 2) / 2
// floats); dynamic shared memory: x, the block's right-hand side (n + 6),
// then the rows when `in_smem`.
__global__ void __launch_bounds__(SOLVE_THREADS)
ba_solve_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
                int n, int in_smem, const float* __restrict__ poses_in,
                float* __restrict__ poses_out, int P0, int fixedp,
                float* __restrict__ Lp, float* __restrict__ dx,
                int* __restrict__ status) {
  extern __shared__ float sm[];
  float* x = sm;
  float* sb = sm + n;
  float* A = in_smem ? sm + n + 6 : Lp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = SOLVE_THREADS / 32;
  for (int t = tid; t < tri(n + 1, 0); t += SOLVE_THREADS) {
    const int r = tri_row(t), c = t - tri(r, 0);
    A[t] = r < n ? S[(long long)r * n + c] : (c < n ? rhs[c] : 0.0f);
  }
  __syncthreads();
  bool ok_factor = true;
  for (int J = 0; J < n; J += 6) {
    float L[6][6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) L[a][b] = A[tri(J + a, J + b)];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float d = L[j][j];
#pragma unroll
      for (int c = 0; c < j; ++c) d -= L[j][c] * L[j][c];
      ok_factor = ok_factor && d > 0.0f;    // not positive definite, or NaN
      L[j][j] = sqrtf(d);
#pragma unroll
      for (int r = j + 1; r < 6; ++r) {
        float v = L[r][j];
#pragma unroll
        for (int c = 0; c < j; ++c) v -= L[r][c] * L[j][c];
        L[r][j] = v / L[j][j];
      }
    }
    if (!ok_factor) break;      // uniform: every thread factored the same
    for (int r = J + 6 + tid; r <= n; r += SOLVE_THREADS) {
      float* ar = A + tri(r, J);
      float l[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float v = ar[j];
#pragma unroll
        for (int c = 0; c < j; ++c) v -= l[c] * L[j][c];
        l[j] = v / L[j][j];
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) ar[j] = l[j];
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b) A[tri(J + a, J + b)] = L[a][b];
    }
    for (int r = J + 6 + warp; r <= n; r += nwarps) {
      const float* lr = A + tri(r, J);
      const float l0 = lr[0], l1 = lr[1], l2 = lr[2], l3 = lr[3],
                  l4 = lr[4], l5 = lr[5];
      const int last = r < n ? r : n - 1;
      float* ar = A + tri(r, 0);
      for (int c = J + 6 + lane; c <= last; c += 32) {
        const float* lc = A + tri(c, J);
        ar[c] -= l0 * lc[0] + l1 * lc[1] + l2 * lc[2] + l3 * lc[3] +
                 l4 * lc[4] + l5 * lc[5];
      }
    }
    __syncthreads();
  }
  if (ok_factor) {
    const float* y = A + tri(n, 0);
    for (int J = n - 6; J >= 0; J -= 6) {
      if (warp < 6) {
        const int c = J + warp;
        float v = 0.0f;
        for (int r = J + 6 + lane; r < n; r += 32) v += A[tri(r, c)] * x[r];
        v = warp_sum(v);
        if (lane == 0) sb[warp] = y[c] - v;
      }
      __syncthreads();
      if (tid == 0) {
        for (int j = J + 5; j >= J; --j) {
          float v = sb[j - J];
          for (int r = j + 1; r < J + 6; ++r) v -= A[tri(r, j)] * x[r];
          x[j] = v / A[tri(j, j)];
        }
      }
      __syncthreads();
    }
  }
  if (in_smem)
    for (int t = tid; t < tri(n, 0); t += SOLVE_THREADS) Lp[t] = A[t];
  __syncthreads();
  solve_finish(n, ok_factor, x, poses_in, poses_out, P0, fixedp, dx, status);
}

// ---------------------------------------------------------------------------
// 5. dz and the disparity retraction; 6. the depth covariance
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(UPDATE_THREADS)
ba_update_kernel(const float* __restrict__ Ed, const int* __restrict__ nzE,
                 const float* __restrict__ Q, const float* __restrict__ w,
                 const float* __restrict__ dx,
                 const float* __restrict__ disps_in,
                 float* __restrict__ disps_out, int P, int P0, int HW) {
  const long long t = (long long)blockIdx.x * UPDATE_THREADS + threadIdx.x;
  if (t >= (long long)P0 * HW) return;
  const int k = (int)(t / HW), p = (int)(t % HW);
  float s = 0.0f;
  for (int a = 0; a < P; ++a) {
    if (nzE[a * P0 + k] == 0) continue;
    const float* e = Ed + (long long)(a * P0 + k) * 6 * HW + p;
#pragma unroll
    for (int d = 0; d < 6; ++d) s += e[(long long)d * HW] * dx[6 * a + d];
  }
  float dz = Q[t] * (w[t] - s);
  if (!isfinite(dz)) dz = 0.0f;
  float dn = disps_in[t] + dz;
  if (dn > 10.0f) dn = 0.0f;
  if (dn < 0.001f) dn = 0.001f;
  disps_out[t] = dn;
}

// dynamic shared memory: n x COV_THREADS floats (each lane's column)
__global__ void __launch_bounds__(COV_THREADS)
ba_cov_kernel(const float* __restrict__ Ed, const int* __restrict__ nzE,
              const float* __restrict__ Q, const float* __restrict__ Lp,
              const int* __restrict__ status, int P, int P0, int HW,
              float* __restrict__ dzcov) {
  extern __shared__ float yc[];
  const int lane = threadIdx.x;
  const long long t = (long long)blockIdx.x * COV_THREADS + lane;
  if (t >= (long long)P0 * HW) return;
  if (*status != 0) {
    dzcov[t] = __int_as_float(0x7fc00000);   // NaN, as the plain step
    return;
  }
  const int k = (int)(t / HW), p = (int)(t % HW);
  const float q = Q[t];
  const int n = 6 * P;
  float sq = 0.0f;
  for (int r = 0; r < n; ++r) {
    const int a = r / 6, d = r % 6;
    const float eq = nzE[a * P0 + k]
        ? Ed[((long long)(a * P0 + k) * 6 + d) * HW + p] * q : 0.0f;
    const float* Lr = Lp + tri(r, 0);
    float s = 0.0f;
    for (int c = 0; c < r; ++c) s += Lr[c] * yc[c * COV_THREADS + lane];
    const float yr = (eq - s) / Lr[r];
    yc[r * COV_THREADS + lane] = yr;
    sq += yr * yr;
  }
  dzcov[t] = sq + q;
}

int g_smem_optin = -1;    // the device's largest dynamic shared memory

}  // namespace

// One Gauss-Newton step (ops/ba.py::_bundle_adjust_cuda allocates every
// buffer; shapes in ops/ba.py::_step_work). Launches five kernels, and the
// plan's first with `plan` (a call's first step) and the covariance's last
// with `with_cov` (its last), whatever the sizes (an empty grid is
// launched as one block that returns). Returns the first CUDA error, 0
// when none.
extern "C" int droid_ba_step(
    const float* poses_in, float* poses_out, const float* disps_in,
    float* disps_out, const float* intr, const float* target,
    const float* weight, const float* ev, const float* eta,
    const long long* ii, const long long* jj, int* cells, int E, int P0,
    int fixedp, int ht, int wd, float ep, float lm, int plan, int with_cov,
    float* HB, float* VB, float* EB, float* CW, float* H, float* v,
    float* Ed, int* nzE, float* Q, float* w, float* S, float* rhs,
    float* Lp, float* dx, int* status, float* dzcov,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int HW = ht * wd, P = P0 - fixedp, n = 6 * P;
  if (E < 0 || P0 <= 0 || P < 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  if (g_smem_optin < 0) {
    int dev = 0, most = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    g_smem_optin = most;
    cudaFuncSetAttribute(ba_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    cudaFuncSetAttribute(ba_cov_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  }
  if (plan) {
    ba_plan_kernel<<<E > 0 ? (E + 255) / 256 : 1, 256, 0, s>>>(ii, jj, E,
                                                              fixedp, P0,
                                                              cells);
  }
  ba_edge_kernel<<<E > 0 ? E : 1, EDGE_THREADS, 0, s>>>(
      poses_in, disps_in, intr, reinterpret_cast<const float2*>(target),
      reinterpret_cast<const float2*>(weight), ev, ii, jj, E, P0, HW, wd, HB,
      VB, EB, CW);
  const long long wE = 6LL * HW, wC = 2LL * HW;
  const long long chE = (wE + GATHER_CHUNK - 1) / GATHER_CHUNK;
  const long long chC = (wC + GATHER_CHUNK - 1) / GATHER_CHUNK;
  const long long nb = (long long)P * P0 * chE + P0 * chC +
                       ((long long)P * P + GATHER_WARPS - 1) / GATHER_WARPS +
                       (P + GATHER_WARPS - 1) / GATHER_WARPS;
  ba_gather_kernel<<<(unsigned)nb, GATHER_THREADS, 0, s>>>(
      cells, E, P, P0, HW, HB, VB, EB, CW, eta, H, v, Ed, nzE, Q, w);
  ba_schur_kernel<<<dim3(P + 1, P > 0 ? P : 1), SCHUR_THREADS, 0, s>>>(
      H, v, Ed, nzE, Q, w, P, P0, HW, ep, lm, S, rhs);
  const size_t vec_bytes = sizeof(float) * ((size_t)n + 6);
  const size_t tri_bytes = sizeof(float) * (size_t)tri(n + 1, 0);
  // 1 KB of the opt-in left for the kernel's static shared memory
  const int in_smem = vec_bytes + tri_bytes + 1024 <= (size_t)g_smem_optin;
  ba_solve_kernel<<<1, SOLVE_THREADS, vec_bytes + (in_smem ? tri_bytes : 0),
                    s>>>(S, rhs, n, in_smem, poses_in, poses_out, P0, fixedp,
                         Lp, dx, status);
  const long long pix = (long long)P0 * HW;
  ba_update_kernel<<<(unsigned)((pix + UPDATE_THREADS - 1) / UPDATE_THREADS),
                     UPDATE_THREADS, 0, s>>>(Ed, nzE, Q, w, dx, disps_in,
                                             disps_out, P, P0, HW);
  if (with_cov) {
    ba_cov_kernel<<<(unsigned)((pix + COV_THREADS - 1) / COV_THREADS),
                    COV_THREADS, sizeof(float) * (size_t)n * COV_THREADS, s>>>(
        Ed, nzE, Q, Lp, status, P, P0, HW, dzcov);
  }
  return (int)cudaGetLastError();
}
