// Pack-gather BACKWARD kernel (K3).
//
// The render packs each tile row's entries by gathering per-Gaussian
// attribute rows: G = raw[entry_gauss], raw (N, 16) with N = V * P rows
// (ops/gs_raster_cuda.py::_pack_rows), G (E, 16) with E = V * n_tiles * K
// entries. This kernel is that gather's backward: given dG (E, 16),
//   dRaw[r] = sum of dG[e] over the masked-in entries e with
//             entry_gauss[e] == r, added from +0.0f in ascending e,
// which is the order of torch's stable-sorted indexing backward, so the
// result is bitwise that backward's (a masked-out entry's cotangent is
// exactly zero: its q0 carries -1e30, so the blend rejects it; adding a
// zero to a sum that starts at +0.0f changes no bit).
//
// What bounds it on the H100: memory. It reads the masked-in entries'
// 64-byte cotangent rows and the index arrays and writes every row of dRaw.
// What it must avoid: torch's backward sorts all E indices and gives each
// distinct index to one thread group, which walks the index's duplicates
// serially; every unused tile slot points at its view's Gaussian 0, so one
// group per view walks hundreds of thousands of zero rows. Masked-out
// entries are skipped here before anything is built.
//
// Design, two launches on the caller's stream (no host read):
// 1. list build, one thread per entry: a masked-in entry takes a slot of
//    its row's list (capacity `cap`, the binning's max_dup: a Gaussian
//    lands in at most that many tiles of a view) with an integer
//    atomicAdd on the row's count; the slot order is arbitrary;
// 2. row sum, four threads per row (a float4 of channels each): the row's
//    n <= cap positions are taken in ascending order by repeated selection
//    of the least position above the last one (n^2 reads of a 64-byte
//    list from L1; at the mapping shape n averages 1.2 a row), each adding
//    its dG float4 in that order; every row is stored, empty ones as
//    zeros, so dRaw needs no memset. A row counted past `cap` scans the
//    entries instead, in ascending order, until it has met its count: only
//    bins that do not come from the binning (where a Gaussian fills more
//    than max_dup slots of a view) take that branch.
// Every sum is a chain of FP32 adds in ascending e: no floating-point
// atomics, so no run-to-run nondeterminism.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCH = 16;                 // packed channels per entry
constexpr int QUADS = NCH / 4;          // float4 per row
constexpr int LIST_THREADS = 256;
constexpr int ROW_THREADS = 256;

__global__ void __launch_bounds__(LIST_THREADS)
gs_pack_list_kernel(const long long* __restrict__ eg,
                    const uint8_t* __restrict__ em, int E, int cap,
                    int* __restrict__ cnt, int* __restrict__ list) {
  int e = blockIdx.x * LIST_THREADS + threadIdx.x;
  if (e >= E || !em[e]) return;
  long long r = eg[e];
  int slot = atomicAdd(cnt + r, 1);
  if (slot < cap) list[r * cap + slot] = e;
}

__global__ void __launch_bounds__(ROW_THREADS)
gs_pack_rows_kernel(const float4* __restrict__ dG,
                    const long long* __restrict__ eg,
                    const uint8_t* __restrict__ em, int E,
                    const int* __restrict__ cnt,
                    const int* __restrict__ list, long long n_rows, int cap,
                    float4* __restrict__ dRaw) {
  long long t = (long long)blockIdx.x * ROW_THREADS + threadIdx.x;
  long long r = t / QUADS;
  int q = (int)(t % QUADS);
  if (r >= n_rows) return;
  int n = cnt[r];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > cap) {
    for (int e = 0, found = 0; e < E && found < n; ++e) {
      if (!em[e] || eg[e] != r) continue;
      float4 g = dG[(long long)e * QUADS + q];
      acc.x += g.x;
      acc.y += g.y;
      acc.z += g.z;
      acc.w += g.w;
      ++found;
    }
    dRaw[r * QUADS + q] = acc;
    return;
  }
  const int* L = list + r * cap;
  int last = -1;
  for (int k = 0; k < n; ++k) {
    int next = 0x7fffffff;
    for (int j = 0; j < n; ++j) {
      int p = L[j];
      if (p > last && p < next) next = p;
    }
    float4 g = dG[(long long)next * QUADS + q];
    acc.x += g.x;
    acc.y += g.y;
    acc.z += g.z;
    acc.w += g.w;
    last = next;
  }
  dRaw[r * QUADS + q] = acc;
}

}  // namespace

// work: int32 scratch of n_rows * (1 + cap) elements
// (ops/gs_raster_cuda.py::_pack_work_ints): the row counts and the row
// lists. dG and dRaw are 16-byte aligned.
extern "C" int gs_pack_bwd(const float* dG, const long long* eg,
                           const uint8_t* em, int E, long long n_rows,
                           int cap, int* work, float* dRaw, void* stream) {
  if (n_rows <= 0) return 0;
  if (cap <= 0 || E < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int* cnt = work;
  int* list = cnt + n_rows;
  cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * n_rows, s);
  if (err != cudaSuccess) return (int)err;
  if (E > 0) {
    gs_pack_list_kernel<<<(E + LIST_THREADS - 1) / LIST_THREADS,
                          LIST_THREADS, 0, s>>>(eg, em, E, cap, cnt, list);
  }
  long long threads = n_rows * QUADS;
  gs_pack_rows_kernel<<<(unsigned)((threads + ROW_THREADS - 1) / ROW_THREADS),
                        ROW_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(dG), eg, em, E, cnt, list, n_rows,
      cap, reinterpret_cast<float4*>(dRaw));
  return (int)cudaGetLastError();
}
