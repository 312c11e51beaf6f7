// Shared per-entry math and staging helpers of the tile-blend forward
// (gs_blend_fwd.cu) and backward (gs_blend_bwd.cu) kernels.
//
// Packed entry layout (ops/gs_raster_cuda.py::_assemble_A), 16 floats per
// entry, tile-local pixel coordinates x = p % 16, y = p / 16:
//   0..2 rgb, 3..5 normal, 6 weight-one, 7 q0 (log-opacity and the entry
//   mask folded in), 8..12 q1..q5, 13..15 t0..t2
//   power = q0 + q1 x + q2 y + q3 x^2 + q4 y^2 + q5 xy
//   t     = t0 + t1 x + t2 y
// An entry is read from shared memory as four float4: v0 = floats 0..3,
// v1 = 4..7 (q0 in .w), v2 = 8..11 (q1..q4), v3 = 12..15 (q5, t0..t2). The
// reject test needs v1, v2 and v3 only.
//
// The backward re-runs the forward's per-entry decisions (alpha reject,
// T_MIN stop, median gate) from the saved chunk-entry transmittance, so
// both kernels evaluate them through these functions with explicit
// fmaf/__fmul_rn: the compiler may not contract them differently in the
// two kernels.
#pragma once

#include <cuda_runtime.h>

namespace gsb {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;   // pixels per tile
constexpr int NCH = 16;           // packed channels per entry
constexpr int NOUT = 8;           // accumulated channels (A rows 0..7)
constexpr int CHUNK = 32;         // entries per tchk residual chunk
constexpr int WARPS = PX / 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_MIN = 1e-4f;
// exp(power) < 1/255 for certain below this: log(1/255) = -5.5413, and the
// 0.009 margin is far above expf's few-ulp error, so skipping the exp here
// takes exactly the decision the exp would.
constexpr float POWER_REJECT = -5.55f;
// median_gate (ops/gs_raster.py): floor(Tb * 2^12) > floor((0.5 + 1e-4) * 2^12)
constexpr float MEDIAN_Q = 4096.0f;
constexpr float MEDIAN_FLOOR = 2048.0f;

__device__ __forceinline__ float entry_power(float4 v1, float4 v2, float4 v3,
                                             float x, float y) {
  float p = fmaf(v2.x, x, v1.w);
  p = fmaf(v2.y, y, p);
  p = fmaf(v2.z, x * x, p);
  p = fmaf(v2.w, y * y, p);
  return fmaf(v3.x, x * y, p);
}

__device__ __forceinline__ float entry_depth(float4 v3, float x, float y) {
  return fmaf(v3.w, y, fmaf(v3.z, x, v3.y));
}

// The alpha reject: true when the entry passes (alpha >= 1/255), with
// ar = exp(power) and ac = min(0.99, ar).
__device__ __forceinline__ bool entry_alpha(float power, float& ar,
                                            float& ac) {
  if (power < POWER_REJECT) return false;
  ar = expf(power);
  ac = fminf(ALPHA_MAX, ar);
  return ac >= ALPHA_MIN;
}

// Whether the entry may pass the alpha reject at some pixel of the tile
// rows y0 .. y0 + nrows - 1 (all 16 columns). False only when every such
// pixel's power is below POWER_REJECT by more than a rounding margin: per
// row, the power is a concave quadratic in x (q3 = -c0 / 2 < 0), bounded
// by its maximum over x in [0, 15]. The margin (1e-3 of the sum of the
// terms' magnitudes) is thousands of times the few-ulp error of either
// evaluation, so a culled entry is one the per-pixel test rejects at every
// pixel of the rows: culling changes no decision. A non-concave or
// non-finite entry is never culled.
__device__ __forceinline__ bool entry_may_pass(float4 v1, float4 v2,
                                               float4 v3, float y0,
                                               int nrows) {
  const float q0 = v1.w, q1 = v2.x, q2 = v2.y, q3 = v2.z, q4 = v2.w,
              q5 = v3.x;
  if (!(q3 < 0.0f)) return true;
  const float mag = fabsf(q0) + 15.0f * (fabsf(q1) + fabsf(q2))
                    + 225.0f * (fabsf(q3) + fabsf(q4) + fabsf(q5));
  const float thr = POWER_REJECT - 1e-3f * (mag + 1.0f);
  const float inv = -0.5f / q3;
  for (int r = 0; r < nrows; ++r) {
    const float y = y0 + (float)r;
    const float b = fmaf(q5, y, q1);                    // d/dx at x = 0
    const float c = fmaf(q4, y * y, fmaf(q2, y, q0));
    const float xs = fminf(15.0f, fmaxf(0.0f, b * inv));
    if (!(fmaf(fmaf(q3, xs, b), xs, c) < thr)) return true;
  }
  return false;
}

__device__ __forceinline__ bool median_gate(float Tb) {
  return floorf(__fmul_rn(Tb, MEDIAN_Q)) > MEDIAN_FLOOR;
}

// Asynchronous 16-byte global -> shared copies (cp.async, bypassing L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage entries [e0, e1) of a row (float4 view) into shared memory.
__device__ __forceinline__ void stage_entries(float4* dst,
                                              const float4* __restrict__ row,
                                              int e0, int e1, int tid,
                                              int nthreads) {
  const int n4 = (e1 - e0) * (NCH / 4);
  const float4* src = row + (size_t)e0 * (NCH / 4);
  for (int i = tid; i < n4; i += nthreads) cp_async16(dst + i, src + i);
  cp_async_commit();
}

}  // namespace gsb
