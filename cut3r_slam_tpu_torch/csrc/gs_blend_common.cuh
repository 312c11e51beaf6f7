// Shared per-entry math of the tile-blend forward (gs_blend_fwd.cu) and
// backward (gs_blend_bwd.cu) kernels.
//
// Packed entry layout (ops/gs_raster_cuda.py::_assemble_A), 16 floats per
// entry, tile-local pixel coordinates x = p % 16, y = p / 16:
//   0..2 rgb, 3..5 normal, 6 weight-one, 7 q0 (log-opacity and the entry
//   mask folded in), 8..12 q1..q5, 13..15 t0..t2
//   power = q0 + q1 x + q2 y + q3 x^2 + q4 y^2 + q5 xy
//   t     = t0 + t1 x + t2 y
//
// The backward re-runs the forward's per-entry decisions (alpha reject,
// T_MIN stop) from the saved chunk-entry transmittance, so both kernels
// evaluate them through these functions with explicit fmaf/__fmul_rn:
// the compiler may not contract them differently in the two kernels.
#pragma once

#include <cuda_runtime.h>

namespace gsb {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;   // pixels per tile = threads per block
constexpr int NCH = 16;           // packed channels per entry
constexpr int NOUT = 8;           // accumulated channels (A rows 0..7)
constexpr int CHUNK = 32;         // entries staged per shared-memory batch
constexpr int WARPS = PX / 32;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_MIN = 1e-4f;
// median_gate (ops/gs_raster.py): floor(Tb * 2^12) > floor((0.5 + 1e-4) * 2^12)
constexpr float MEDIAN_Q = 4096.0f;
constexpr float MEDIAN_FLOOR = 2048.0f;

__device__ __forceinline__ float entry_power(const float* a, float x,
                                             float y) {
  float p = fmaf(a[8], x, a[7]);
  p = fmaf(a[9], y, p);
  p = fmaf(a[10], x * x, p);
  p = fmaf(a[11], y * y, p);
  return fmaf(a[12], x * y, p);
}

__device__ __forceinline__ float entry_depth(const float* a, float x,
                                             float y) {
  return fmaf(a[15], y, fmaf(a[14], x, a[13]));
}

__device__ __forceinline__ bool median_gate(float Tb) {
  return floorf(__fmul_rn(Tb, MEDIAN_Q)) > MEDIAN_FLOOR;
}

}  // namespace gsb
