// Tile-blend BACKWARD kernel (K2).
//
// Replaces the TPU kernel cut3r_slam_tpu/ops/gs_raster_pallas.py::
// _blend_bwd_kernel, launched there by _blend_entries_bwd through
// pl.pallas_call.
//
// What it computes: the cotangent dA (R, K, 16) of the packed entries
// given the cotangents of the forward's outputs, gO (R, 256, 8) and
// gd / gmd / gT (R, 256), in ONE reverse pass over the 32-entry chunks:
//   b_i      = A_i[0:8] . gO + gd t_i
//   S_i      = sum_{j > i} alpha_j T_j b_j                (suffix)
//   dalpha_i = T_i b_i - (S_i + gT T_final) / (1 - alpha_i)
//   dpower_i = dalpha_i alpha_raw_i  (0 where clamped at 0.99 or rejected)
//   dt_i     = gd alpha_i T_i + gmd [i is the median contributor]
//   dA_i     = sum over pixels of [alpha T gO, dpower (1, x, y, x^2, y^2,
//              xy) in rows 7..12, dt (1, x, y) in rows 13..15]
// The median contributor is the last entry passing median_gate, i.e. the
// first one met walking backwards.
//
// What bounds it on the H100: per (entry, pixel) pair, the forward
// recompute and, for a kept pair, the cotangent terms and the 18 products
// of the per-entry sums (chip_smoke.py bound_ms: operation-bound, FP32).
// What it must avoid: reducing each entry's 16 sums over the tile with
// warp-shuffle trees (80 dependent shuffles per entry and warp), keeping
// 32 entries' state in registers (spills, low occupancy) and running the
// exp of a kept pair twice.
//
// Design: one block of 256 threads per tile row, walking the chunks that
// the forward reached (tchk > 0 for some pixel) back to front. Per chunk:
// 1. the next chunk's 32 entries (2 KB) are copied with cp.async into the
//    other half of a double buffer while this chunk is processed;
// 2. each pixel-thread re-runs the chunk's forward from its saved inbound
//    T (skipping the entries that a per-warp bound rejects at all of the
//    warp's pixels, gs_blend_common.cuh entry_may_pass), storing each
//    entry's inbound T (0 unless blended) and alpha_raw in shared memory
//    (no exp is run twice), then walks the chunk backwards
//    (suffix sum S, median search: serial per pixel) and overwrites those
//    slots with the three per-entry weights X = [aT | dpower | dt],
//    entries-major with a padded row (257 floats: conflict-free both for
//    the pixel-thread writes and for the entry-lane reads below);
// 3. the per-entry sums are ONE contraction over pixels, as the TPU
//    kernel's merged [aT | dpower | dt] x [gO | power basis | depth basis]
//    einsum: lane j of warp w owns entry j and sums its 16 channels over
//    the warp's 32 pixels, reading X[j][p] (one bank per lane) and gO[p]
//    (a broadcast float4 pair, staged once per row), with the bases
//    (1, x, y, x^2, y^2, xy) computed from p; pixels with no blended entry
//    in the chunk are skipped (a ballot mask). That is 17 FMAs and one add
//    per (entry, pixel): channel 7 takes both aT gO_7 and dpower;
// 4. the 8 warps' partial sums meet in shared memory (reusing X) and one
//    pass writes the chunk's dA rows. Each entry belongs to one row: no
//    atomics.
// The contraction runs on the CUDA cores in exact FP32 FMAs: every product
// is the f32 product, as under the TPU kernel's Precision.HIGHEST; only
// the order of the f32 sums differs (32 pixels per lane, then 8 partials).
// A TF32 tensor-core contraction would need the 3-pass hi/lo split to
// reach that, and the product is thin (32 entries x 16 channels, 768
// deep, 31 of the 48 basis columns zero): loading and splitting the
// mma.sync fragments would cost about as many instructions as the FMAs
// they replace, so the CUDA cores keep it simple and exact.
// Shared memory: 3 x 32 x 257 floats (X) + gO (8 KB) + the entry double
// buffer (4 KB) + the chunk count = 110,992 B, dynamic, so that two
// blocks fit on an SM.
#include "gs_blend_common.cuh"

using namespace gsb;

namespace {

constexpr int LD = PX + 1;                              // padded X row
constexpr int X_FLOATS = CHUNK * LD;
constexpr size_t BWD_SMEM = sizeof(float) * (3 * X_FLOATS + PX * NOUT
                                             + 2 * CHUNK * NCH)
                            + 16;                        // + the chunk count

}  // namespace

__global__ void __launch_bounds__(PX, 2)
gs_blend_bwd_kernel(const float* __restrict__ A,
                    const int* __restrict__ extent, int K, int nC,
                    const float* __restrict__ tchk,
                    const float* __restrict__ tleft,
                    const float* __restrict__ gO,
                    const float* __restrict__ gd,
                    const float* __restrict__ gmd,
                    const float* __restrict__ gT,
                    float* __restrict__ dA) {
  extern __shared__ __align__(16) float smem[];
  float4* sA = reinterpret_cast<float4*>(smem);            // [2][CHUNK*4]
  float4* sGO = sA + 2 * CHUNK * (NCH / 4);                // [PX][2]
  float* X0 = reinterpret_cast<float*>(sGO + PX * 2);      // Tb, then aT
  float* X1 = X0 + X_FLOATS;                               // ar, then dpower
  float* X2 = X1 + X_FLOATS;                               // dt
  int* s_nact = reinterpret_cast<int*>(X2 + X_FLOATS);
  float* part = X0;                     // [WARPS][16][33] after the sums

  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const int ext = min(max(extent[row], 0), K);
  const float4* Arow =
      reinterpret_cast<const float4*>(A) + (size_t)row * K * (NCH / 4);
  float* dArow = dA + (size_t)row * K * NCH;
  const float* tchk_row = tchk + (size_t)row * nC * PX;

  const size_t px = (size_t)row * PX + p;
  float go[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) go[k] = gO[px * NOUT + k];
  sGO[2 * p] = make_float4(go[0], go[1], go[2], go[3]);
  sGO[2 * p + 1] = make_float4(go[4], go[5], go[6], go[7]);
  const float g_d = gd[px];
  const float g_md = gmd[px];
  const float gTT = gT[px] * tleft[px];

  // chunks the forward reached form a prefix (tchk > 0 for some pixel)
  const int nc_ext = (ext + CHUNK - 1) / CHUNK;
  int na = 0;
#pragma unroll 4
  for (int c = 0; c < nc_ext; ++c)
    if (tchk_row[(size_t)c * PX + p] > 0.0f) na = c + 1;
  if (p == 0) *s_nact = 0;
  __syncthreads();
  na = __reduce_max_sync(0xffffffffu, na);
  if (lane == 0) atomicMax(s_nact, na);
  __syncthreads();
  const int n_act = *s_nact;

  // entries past the last reached chunk or the extent get zero cotangent
  {
    const int lo = min(n_act * CHUNK, ext);
    float4* d4 = reinterpret_cast<float4*>(dArow);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = lo * (NCH / 4) + p; i < K * (NCH / 4); i += PX) d4[i] = z;
  }
  if (n_act == 0) return;

  float S = 0.0f;
  bool med_found = false;
  stage_entries(sA, Arow, (n_act - 1) * CHUNK, min(n_act * CHUNK, ext), p,
                PX);
  float T_in = tchk_row[(size_t)(n_act - 1) * PX + p];
  for (int c = n_act - 1; c >= 0; --c) {
    const int base = c * CHUNK;
    const int n = min(CHUNK, ext - base);
    const float4* buf = sA + ((n_act - 1 - c) & 1) * CHUNK * (NCH / 4);
    float T_prev = 0.0f;
    if (c > 0) {
      stage_entries(sA + ((n_act - c) & 1) * CHUNK * (NCH / 4), Arow,
                    base - CHUNK, base, p, PX);
      T_prev = tchk_row[(size_t)(c - 1) * PX + p];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // B1: chunk c staged; X free

    // forward recompute from the inbound T: inbound T (0 unless blended)
    // and alpha_raw per entry into X0 / X1; lane j first bounds entry j
    // over the warp's two rows, and entries that pass at none of its
    // pixels are rejected without the per-pixel test
    {
      bool may = false;
      if (lane < n) {
        const float4* e = buf + lane * (NCH / 4);
        may = entry_may_pass(e[1], e[2], e[3], (float)(2 * warp), 2);
      }
      const unsigned cand = __ballot_sync(0xffffffffu, may);
      float T = T_in;
      bool act = T > 0.0f;
      for (int j = 0; j < n; ++j) {
        float tb = 0.0f, arv = 0.0f;
        if (act && ((cand >> j) & 1u)) {
          const float4* e = buf + j * (NCH / 4);
          float ar, ac;
          if (entry_alpha(entry_power(e[1], e[2], e[3], x, y), ar, ac)) {
            const float Tn = __fmul_rn(T, 1.0f - ac);
            if (Tn < T_MIN) {
              act = false;
            } else {
              tb = T;
              arv = ar;
              T = Tn;
            }
          }
        }
        X0[j * LD + p] = tb;
        X1[j * LD + p] = arv;
      }
    }

    // reverse walk: X0 <- aT, X1 <- dpower, X2 <- dt
    bool any = false;
    for (int j = n - 1; j >= 0; --j) {
      const float tb = X0[j * LD + p];
      float aT = 0.0f, dpw = 0.0f, dt = 0.0f;
      if (tb > 0.0f) {
        any = true;
        const float ar = X1[j * LD + p];
        const float4* e = buf + j * (NCH / 4);
        const float4 v0 = e[0], v1 = e[1], v3 = e[3];
        const float ac = fminf(ALPHA_MAX, ar);
        aT = __fmul_rn(ac, tb);
        const float t = entry_depth(v3, x, y);
        float b = g_d * t;
        b = fmaf(v0.x, go[0], b);
        b = fmaf(v0.y, go[1], b);
        b = fmaf(v0.z, go[2], b);
        b = fmaf(v0.w, go[3], b);
        b = fmaf(v1.x, go[4], b);
        b = fmaf(v1.y, go[5], b);
        b = fmaf(v1.z, go[6], b);
        b = fmaf(v1.w, go[7], b);
        const float dalpha = tb * b - (S + gTT) / (1.0f - ac);
        const bool bm = median_gate(tb) && aT > 0.0f;
        const bool is_med = bm && !med_found;
        med_found = med_found || bm;
        dt = g_d * aT + (is_med ? g_md : 0.0f);
        dpw = (ar < ALPHA_MAX) ? dalpha * ar : 0.0f;
        S = fmaf(aT, b, S);
      }
      X0[j * LD + p] = aT;
      X1[j * LD + p] = dpw;
      X2[j * LD + p] = dt;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, any);
    __syncthreads();                    // B2: X complete

    // contraction over this warp's 32 pixels; lane = entry
    float acc[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) acc[k] = 0.0f;
    if (lane < n) {
      unsigned m = mask;
      while (m) {
        const int q = warp * 32 + __ffs(m) - 1;
        m &= m - 1;
        const float xq = (float)(q % TILE), yq = (float)(q / TILE);
        const float a = X0[lane * LD + q];
        const float d = X1[lane * LD + q];
        const float t = X2[lane * LD + q];
        const float4 g0 = sGO[2 * q], g1 = sGO[2 * q + 1];
        acc[0] = fmaf(a, g0.x, acc[0]);
        acc[1] = fmaf(a, g0.y, acc[1]);
        acc[2] = fmaf(a, g0.z, acc[2]);
        acc[3] = fmaf(a, g0.w, acc[3]);
        acc[4] = fmaf(a, g1.x, acc[4]);
        acc[5] = fmaf(a, g1.y, acc[5]);
        acc[6] = fmaf(a, g1.z, acc[6]);
        acc[7] = fmaf(a, g1.w, acc[7]) + d;
        acc[8] = fmaf(d, xq, acc[8]);
        acc[9] = fmaf(d, yq, acc[9]);
        acc[10] = fmaf(d, xq * xq, acc[10]);
        acc[11] = fmaf(d, yq * yq, acc[11]);
        acc[12] = fmaf(d, xq * yq, acc[12]);
        acc[13] += t;
        acc[14] = fmaf(t, xq, acc[14]);
        acc[15] = fmaf(t, yq, acc[15]);
      }
    }
    __syncthreads();                    // B3: X read; reuse it for partials
    if (lane < n) {
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        part[(warp * NCH + k) * 33 + lane] = acc[k];
    }
    __syncthreads();                    // B4: partials complete
    for (int i = p; i < n * NCH; i += PX) {
      const int j = i / NCH, k = i % NCH;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[(w * NCH + k) * 33 + j];
      dArow[(size_t)(base + j) * NCH + k] = s;
    }
    T_in = T_prev;
  }
}

extern "C" int gs_blend_bwd(const float* A, const int* extent, int R, int K,
                            int nC, const float* tchk, const float* tleft,
                            const float* gO, const float* gd,
                            const float* gmd, const float* gT, float* dA,
                            void* stream) {
  if (R <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      gs_blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gs_blend_bwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return (int)err;
  gs_blend_bwd_kernel<<<R, PX, BWD_SMEM, (cudaStream_t)stream>>>(
      A, extent, K, nC, tchk, tleft, gO, gd, gmd, gT, dA);
  return (int)cudaGetLastError();
}
