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
// Design (first, simple version): one block of 256 threads per tile row,
// one thread per pixel. For each chunk, back to front, every thread
// re-runs the chunk's forward from the saved inbound T (tchk) keeping the
// per-entry T in registers (the chunk loops are fully unrolled), then
// walks the chunk backwards. The 16 per-entry sums over the 256 pixels
// are warp-shuffle reductions (skipped for warps with no contributing
// pixel) into shared memory, then a sum over the 8 warps. Each entry
// belongs to exactly one row, so dA needs no atomics.
//
// Bound on the H100: per (entry, pixel) pair visited, the forward
// recompute (13 FLOPs and one MUFU exp for a rejected entry, 16 for a kept
// one) plus, for a kept entry, the cotangent terms, 16 products and their
// 16 sums into the reduction (85 FLOPs in all, FMA = 2, and a MUFU
// reciprocal), against 64 B per entry read and 64 B written:
// operation-bound (chip_smoke.py bound_ms). The 80 shuffles per entry and
// warp are the cost this version does not yet avoid (a transposed
// reduction or a tensor-core contraction over the pixel axis is later
// work).
#include "gs_blend_common.cuh"

using namespace gsb;

__global__ void __launch_bounds__(PX)
gs_blend_bwd_kernel(const float* __restrict__ A,
                    const int* __restrict__ extent, int K, int nC,
                    const float* __restrict__ tchk,
                    const float* __restrict__ tleft,
                    const float* __restrict__ gO,
                    const float* __restrict__ gd,
                    const float* __restrict__ gmd,
                    const float* __restrict__ gT,
                    float* __restrict__ dA) {
  __shared__ float sA[CHUNK * NCH];
  __shared__ float part[WARPS][CHUNK][NCH];
  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const int ext = min(max(extent[row], 0), K);
  const float* Arow = A + (size_t)row * K * NCH;
  float* dArow = dA + (size_t)row * K * NCH;

  const size_t px = (size_t)row * PX + p;
  float go[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) go[k] = gO[px * NOUT + k];
  const float g_d = gd[px];
  const float g_md = gmd[px];
  const float gTT = gT[px] * tleft[px];

  // entries past the extent were never blended: zero cotangent
  for (int i = ext * NCH + p; i < K * NCH; i += PX) dArow[i] = 0.0f;

  float S = 0.0f;
  bool med_found = false;
  const int n_chunks = (ext + CHUNK - 1) / CHUNK;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int base = c * CHUNK;
    const int n = min(CHUNK, ext - base);
    __syncthreads();
    for (int i = p; i < CHUNK * NCH; i += PX)
      sA[i] = (i < n * NCH) ? Arow[(size_t)base * NCH + i] : 0.0f;
    __syncthreads();

    // forward recompute of this chunk from its inbound T
    float Tb[CHUNK];
    unsigned kept = 0u;
    {
      float T = tchk[((size_t)row * nC + c) * PX + p];
      bool act = T > 0.0f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        Tb[j] = 0.0f;
        if (act && j < n) {
          const float* a = sA + j * NCH;
          const float ac = fminf(ALPHA_MAX, expf(entry_power(a, x, y)));
          if (ac >= ALPHA_MIN) {
            const float Tn = __fmul_rn(T, 1.0f - ac);
            if (Tn < T_MIN) {
              act = false;
            } else {
              Tb[j] = T;
              kept |= 1u << j;
              T = Tn;
            }
          }
        }
      }
    }

    // reverse walk
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      if (j >= n) continue;                       // uniform over the block
      float v[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) v[k] = 0.0f;
      const bool on = (kept >> j) & 1u;
      if (on) {
        const float* a = sA + j * NCH;
        const float ar = expf(entry_power(a, x, y));
        const float ac = fminf(ALPHA_MAX, ar);
        const float tb = Tb[j];
        const float aT = __fmul_rn(ac, tb);
        const float t = entry_depth(a, x, y);
        float b = g_d * t;
#pragma unroll
        for (int k = 0; k < NOUT; ++k) b = fmaf(a[k], go[k], b);
        const float dalpha = tb * b - (S + gTT) / (1.0f - ac);
        const bool bm = median_gate(tb) && aT > 0.0f;
        const bool is_med = bm && !med_found;
        med_found = med_found || bm;
        const float dt = g_d * aT + (is_med ? g_md : 0.0f);
        const float dpw = (ar < ALPHA_MAX) ? dalpha * ar : 0.0f;
        S = fmaf(aT, b, S);
#pragma unroll
        for (int k = 0; k < NOUT; ++k) v[k] = aT * go[k];
        v[7] += dpw;
        v[8] = dpw * x;
        v[9] = dpw * y;
        v[10] = dpw * (x * x);
        v[11] = dpw * (y * y);
        v[12] = dpw * (x * y);
        v[13] = dt;
        v[14] = dt * x;
        v[15] = dt * y;
      }
      if (__any_sync(0xffffffffu, on)) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NCH; ++k) part[warp][j][k] = v[k];
      }
    }
    __syncthreads();
    for (int i = p; i < n * NCH; i += PX) {
      const int j = i / NCH, k = i % NCH;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[w][j][k];
      dArow[(size_t)base * NCH + i] = s;
    }
  }
}

extern "C" int gs_blend_bwd(const float* A, const int* extent, int R, int K,
                            int nC, const float* tchk, const float* tleft,
                            const float* gO, const float* gd,
                            const float* gmd, const float* gT, float* dA,
                            void* stream) {
  if (R <= 0) return 0;
  gs_blend_bwd_kernel<<<R, PX, 0, (cudaStream_t)stream>>>(
      A, extent, K, nC, tchk, tleft, gO, gd, gmd, gT, dA);
  return (int)cudaGetLastError();
}
