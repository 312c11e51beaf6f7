// Tile-blend FORWARD kernel (K1).
//
// Replaces the TPU kernel cut3r_slam_tpu/ops/gs_raster_pallas.py::
// _blend_fwd_kernel (with its helpers _chunk_blend / _batch_chunks),
// launched there by _blend_call through pl.pallas_call.
//
// What it computes, per 16x16 tile row r and pixel p, front to back over
// the row's depth-sorted entries e < extent[r]:
//   alpha = min(0.99, exp(power_e(p)))    (log-opacity and mask in q0)
//   alpha < 1/255          -> entry skipped, T unchanged
//   T * (1 - alpha) < T_MIN -> the pixel stops; this entry is NOT blended
//   else: O += alpha T A[0:8]; dsum += alpha T t_e(p);
//         mdep = t_e(p) if median_gate(T); T *= 1 - alpha
// Outputs O (R, 256, 8), dsum/mdep/tleft (R, 256) and, when tchk is not
// null, the residual of the one-pass reverse backward: tchk (R, nC, 256)
// holds each 32-entry chunk's inbound T for pixels still blending, and 0
// for pixels that already stopped and for chunks never reached.
//
// Design (first, simple version): one block of 256 threads per tile row,
// one thread per pixel; each chunk's 32 x 16 entry floats are staged in
// shared memory and every thread walks them sequentially. The block stops
// early once no pixel is still blending (__syncthreads_or).
//
// Bound on the H100: per (entry, pixel) pair a pixel visits, a rejected
// entry (alpha < 1/255, most pairs) costs the power polynomial, the exp's
// scale, the clamp and the test (13 FLOPs, FMA = 2) and one MUFU exp; a
// blended one adds the T update, 9 FMA accumulations and the median gate
// (43 FLOPs). Against 64 B per entry read once this is operation-bound:
// ~0.022 ms for one full-occupancy 512x384 view at the 67 TFLOP/s FP32
// peak, with the exp unit (16 per clock per SM) close behind, vs ~0.014
// ms for its bytes at 3.35 TB/s (chip_smoke.py bound_ms).
// This version leaves the sequential per-pixel walk on the CUDA cores;
// making it fast (TMA staging, a persistent grid, wider per-thread pixel
// blocking) is later work.
#include "gs_blend_common.cuh"

using namespace gsb;

__global__ void __launch_bounds__(PX)
gs_blend_fwd_kernel(const float* __restrict__ A,
                    const int* __restrict__ extent, int K, int nC,
                    float* __restrict__ O, float* __restrict__ dsum,
                    float* __restrict__ mdep, float* __restrict__ tleft,
                    float* __restrict__ tchk) {
  __shared__ float sA[CHUNK * NCH];
  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const int ext = min(max(extent[row], 0), K);
  const float* Arow = A + (size_t)row * K * NCH;

  float T = 1.0f;
  bool done = false;
  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
  float ds = 0.0f, md = 0.0f;

  const int n_chunks = (ext + CHUNK - 1) / CHUNK;
  int c = 0;
  while (c < n_chunks) {
    if (tchk != nullptr)
      tchk[((size_t)row * nC + c) * PX + p] = done ? 0.0f : T;
    const int base = c * CHUNK;
    const int n = min(CHUNK, ext - base);
    __syncthreads();
    for (int i = p; i < CHUNK * NCH; i += PX)
      sA[i] = (i < n * NCH) ? Arow[(size_t)base * NCH + i] : 0.0f;
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float* a = sA + j * NCH;
        const float ar = expf(entry_power(a, x, y));
        const float ac = fminf(ALPHA_MAX, ar);
        if (ac < ALPHA_MIN) continue;            // rejected: T unchanged
        const float Tn = __fmul_rn(T, 1.0f - ac);
        if (Tn < T_MIN) {                        // stop, entry not blended
          done = true;
          break;
        }
        const float aT = __fmul_rn(ac, T);
#pragma unroll
        for (int k = 0; k < NOUT; ++k) acc[k] = fmaf(aT, a[k], acc[k]);
        const float t = entry_depth(a, x, y);
        ds = fmaf(aT, t, ds);
        if (median_gate(T) && aT > 0.0f) md = t;
        T = Tn;
      }
    }
    ++c;
    if (!__syncthreads_or(!done)) break;         // every pixel stopped
  }
  if (tchk != nullptr)
    for (; c < nC; ++c) tchk[((size_t)row * nC + c) * PX + p] = 0.0f;

  const size_t px = (size_t)row * PX + p;
#pragma unroll
  for (int k = 0; k < NOUT; ++k) O[px * NOUT + k] = acc[k];
  dsum[px] = ds;
  mdep[px] = md;
  tleft[px] = T;
}

extern "C" int gs_blend_fwd(const float* A, const int* extent, int R, int K,
                            int nC, float* O, float* dsum, float* mdep,
                            float* tleft, float* tchk, void* stream) {
  if (R <= 0) return 0;
  gs_blend_fwd_kernel<<<R, PX, 0, (cudaStream_t)stream>>>(
      A, extent, K, nC, O, dsum, mdep, tleft, tchk);
  return (int)cudaGetLastError();
}
