// Per-pair gradient rows -> per-Gaussian gradients, for Hopper (sm_90a),
// behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_cumsum_pairs_pallas and
// the boundary differences of _route_to_table around it.  On the TPU the
// pair rows are gathered into emission-slot order, cumsummed along the pairs
// in one sequential grid (carrying the running total from block to block),
// and each Gaussian's gradient is csum[end - 1] - csum[start - 1]: the sum of
// its rows over its contiguous emission slots [offsets[g], offsets[g] +
// counts[g]).  Hopper blocks run in no order, so a carried scan would need
// several passes; this kernel computes the same per-Gaussian sums directly.
//
// Design.  One warp per (view, Gaussian).  Its lanes walk the Gaussian's
// slots (clipped to the budget P), map each slot to its sorted position
// through pos_of_slot (P marks a dropped slot, which adds nothing), and add
// that pair's row; a butterfly of shuffles then sums the lanes in a fixed
// order and lane r writes row r.  No atomics, no dependence on P: it runs at
// every budget, and two runs give bitwise-identical sums.  It routes the
// rows of K2 and K4 (slot map: pos_of_slot_of over the exact stream) and of
// K5 (the padded stream's q_of_slot).
//
// What bounds it.  The bytes: each kept pair row is read once (through a
// gather), each slot's position once, the offsets and counts, and the table
// of gradients written once; the adds are a few per byte.  Most Gaussians
// hold a handful of slots, so most lanes of a warp idle: the warp-level
// shuffles, not the memory, are the cost above the bound.  Packing several
// Gaussians into one warp is later work.

#include <cuda_runtime.h>

namespace {

constexpr int MIN_REC = 8;           // 7 geometry rows + 1..9 colours
constexpr int MAX_REC = 16;
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

// The row count is a template parameter: each lane keeps R accumulators in
// registers, and a runtime R would cost every launch the widest (16).
template <int R>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) route_pairs_kernel(
    const float* __restrict__ d_rows,       // (V, P, R) per-pair rows
    const int* __restrict__ pos_of_slot,    // (V, P) slot -> sorted position
    const int* __restrict__ offsets,        // (V, N) first emission slot
    const int* __restrict__ counts,         // (V, N) emitted pairs
    float* __restrict__ d_table,            // (V, N, R) per-Gaussian rows
    int V, int N, int P) {
  const long long item =
      static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(V) * N) return;  // whole warp leaves
  const int lane = threadIdx.x & 31;
  const int v = static_cast<int>(item / N);
  const int lo = offsets[item];
  const int hi = min(lo + counts[item], P);
  const float* rows_v = d_rows + static_cast<size_t>(v) * P * R;
  const int* pos_v = pos_of_slot + static_cast<size_t>(v) * P;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  for (int s = lo + lane; s < hi; s += 32) {
    const int p = pos_v[s];
    if (p < P) {
      const float* row = rows_v + static_cast<size_t>(p) * R;
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += row[r];
    }
  }
  float out = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
    if (lane == r) out = x;
  }
  if (lane < R) d_table[static_cast<size_t>(item) * R + lane] = out;
}

}  // namespace

extern "C" {

// Launches the routing on `stream`: one warp per (view, Gaussian), R rows of
// 8..16 (7 + C, C of 1..9).  Returns cudaGetLastError() (0 on success).
int splatpu_route_pairs(const void* d_rows, const void* pos_of_slot,
                        const void* offsets, const void* counts, void* d_table,
                        int V, int N, int P, int R, void* stream) {
  if (V < 1 || N < 1 || P < 1 || R < MIN_REC || R > MAX_REC)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * N;
  const long long blocks = (items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<const float*>(d_rows);
  const auto pos = static_cast<const int*>(pos_of_slot);
  const auto off = static_cast<const int*>(offsets);
  const auto cnt = static_cast<const int*>(counts);
  const auto out = static_cast<float*>(d_table);
#define SPLATPU_LAUNCH(NR)                                                                   \
  case NR:                                                                                   \
    route_pairs_kernel<NR><<<grid, WARPS_PER_BLOCK * 32, 0, s>>>(rows, pos, off, cnt, out, V, \
                                                                 N, P);                      \
    break;
  switch (R) {
    SPLATPU_LAUNCH(8) SPLATPU_LAUNCH(9) SPLATPU_LAUNCH(10) SPLATPU_LAUNCH(11) SPLATPU_LAUNCH(12)
    SPLATPU_LAUNCH(13) SPLATPU_LAUNCH(14) SPLATPU_LAUNCH(15) SPLATPU_LAUNCH(16)
  }
#undef SPLATPU_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
