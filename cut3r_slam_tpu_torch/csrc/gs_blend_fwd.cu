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
// What bounds it on the H100: per (entry, pixel) pair a pixel visits, a
// rejected entry (alpha < 1/255, most pairs: 69.0 M of 82.6 M for one
// full-occupancy 512x384 view) costs the power polynomial and the test; a
// blended one adds the exp, the T update, 9 FMA accumulations and the
// median gate. Against 64 B per entry read once this is operation-bound
// (chip_smoke.py bound_ms), so the time goes to the per-entry overhead
// around the 13-FLOP reject test.
//
// Design: one block of 256 threads per tile row, one thread per pixel;
// warp w owns tile rows 2w and 2w + 1. Entries are staged 128 at a time
// (8 KB) with cp.async into a double buffer: stage s + 1 is in flight
// while stage s is walked, with one barrier to publish a stage and one
// early-stop vote (__syncthreads_or) per stage: 8 barriers for a
// 512-entry row, where synchronous 32-entry staging needs 48. The
// reject path, most pairs, is cut at two levels: per 32 entries, each
// lane bounds one entry's power over the warp's two rows
// (entry_may_pass) and a ballot leaves the warp only the entries that may
// pass somewhere in its rows; per pixel, the power alone rejects without
// the exp where it can (entry_alpha). Neither cut changes a decision.
// Entries are read from shared memory as float4. tchk is written at each
// 32-entry boundary a pixel reaches; everything after a pixel's stop or
// the block's early exit is zeroed at the end. (Two pixels per thread,
// which halves the shared reads per pair, measured no faster: the shared
// reads are not what bounds it.)
#include "gs_blend_common.cuh"

using namespace gsb;

namespace {

constexpr int STAGE = 128;            // entries per staged batch (4 chunks)

}  // namespace

__global__ void __launch_bounds__(PX)
gs_blend_fwd_kernel(const float* __restrict__ A,
                    const int* __restrict__ extent, int K, int nC,
                    float* __restrict__ O, float* __restrict__ dsum,
                    float* __restrict__ mdep, float* __restrict__ tleft,
                    float* __restrict__ tchk) {
  __shared__ __align__(16) float4 sA[2][STAGE * NCH / 4];
  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const float x = (float)(p % TILE);
  const float y = (float)(p / TILE);
  const float y_warp = (float)(2 * (p >> 5));   // first of the warp's rows
  const int ext = min(max(extent[row], 0), K);
  const float4* Arow =
      reinterpret_cast<const float4*>(A) + (size_t)row * K * (NCH / 4);
  float* tchk_px =
      tchk == nullptr ? nullptr : tchk + (size_t)row * nC * PX + p;

  float T = 1.0f;
  bool done = false;
  float acc[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) acc[k] = 0.0f;
  float ds = 0.0f, md = 0.0f;

  const int n_stages = (ext + STAGE - 1) / STAGE;
  int c = 0;                           // next tchk chunk this thread writes
  if (n_stages > 0) stage_entries(sA[0], Arow, 0, min(STAGE, ext), p, PX);
  for (int s = 0; s < n_stages; ++s) {
    const int e0 = s * STAGE;
    if (s + 1 < n_stages) {
      stage_entries(sA[(s + 1) & 1], Arow, e0 + STAGE,
                    min(e0 + 2 * STAGE, ext), p, PX);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                   // stage s is in shared memory
    const float4* buf = sA[s & 1];
    const int n = min(STAGE, ext - e0);
    for (int cb = 0; cb < n; cb += CHUNK) {
      if (__all_sync(0xffffffffu, done)) break;      // the warp stopped
      if (tchk_px != nullptr) tchk_px[(size_t)c * PX] = done ? 0.0f : T;
      ++c;
      // lane l bounds entry cb + l over the warp's rows
      bool may = false;
      if (cb + lane < n) {
        const float4* e = buf + (cb + lane) * (NCH / 4);
        may = entry_may_pass(e[1], e[2], e[3], y_warp, 2);
      }
      unsigned cand = __ballot_sync(0xffffffffu, may);
      if (done) cand = 0u;
      while (cand) {
        const float4* e = buf + (cb + __ffs(cand) - 1) * (NCH / 4);
        cand &= cand - 1;
        const float4 v1 = e[1], v2 = e[2], v3 = e[3];
        float ar, ac;
        if (!entry_alpha(entry_power(v1, v2, v3, x, y), ar, ac)) continue;
        const float Tn = __fmul_rn(T, 1.0f - ac);
        if (Tn < T_MIN) {              // stop; this entry is not blended
          done = true;
          break;
        }
        const float aT = __fmul_rn(ac, T);
        const float4 v0 = e[0];
        acc[0] = fmaf(aT, v0.x, acc[0]);
        acc[1] = fmaf(aT, v0.y, acc[1]);
        acc[2] = fmaf(aT, v0.z, acc[2]);
        acc[3] = fmaf(aT, v0.w, acc[3]);
        acc[4] = fmaf(aT, v1.x, acc[4]);
        acc[5] = fmaf(aT, v1.y, acc[5]);
        acc[6] = fmaf(aT, v1.z, acc[6]);
        acc[7] = fmaf(aT, v1.w, acc[7]);
        const float t = entry_depth(v3, x, y);
        ds = fmaf(aT, t, ds);
        if (median_gate(T) && aT > 0.0f) md = t;
        T = Tn;
      }
    }
    // every pixel stopped: no later stage can change anything
    if (!__syncthreads_or(!done)) break;
  }
  cp_async_wait<0>();                  // a prefetch left by the early exit

  if (tchk_px != nullptr)
    for (; c < nC; ++c) tchk_px[(size_t)c * PX] = 0.0f;
  const size_t g = (size_t)row * PX + p;
#pragma unroll
  for (int k = 0; k < NOUT; ++k) O[g * NOUT + k] = acc[k];
  dsum[g] = ds;
  mdep[g] = md;
  tleft[g] = T;
}

extern "C" int gs_blend_fwd(const float* A, const int* extent, int R, int K,
                            int nC, float* O, float* dsum, float* mdep,
                            float* tleft, float* tchk, void* stream) {
  if (R <= 0) return 0;
  gs_blend_fwd_kernel<<<R, PX, 0, (cudaStream_t)stream>>>(
      A, extent, K, nC, O, dsum, mdep, tleft, tchk);
  return (int)cudaGetLastError();
}
