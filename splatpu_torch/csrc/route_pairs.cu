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
// every budget, and two runs give bitwise-identical sums.
//
// What bounds it.  The bytes: each kept pair row is read once (through a
// gather), each slot's position once, the offsets and counts, and the table
// of gradients written once; the adds are a few per byte.  Most Gaussians
// hold a handful of slots, so most lanes of a warp idle: the warp-level
// shuffles, not the memory, are the cost above the bound.  Packing several
// Gaussians into one warp is later work.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_REC = 12;          // 7 geometry rows + up to 5 colours
constexpr int WARPS_PER_BLOCK = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32) route_pairs_kernel(
    const float* __restrict__ d_rows,       // (V, P, R) per-pair rows
    const int* __restrict__ pos_of_slot,    // (V, P) slot -> sorted position
    const int* __restrict__ offsets,        // (V, N) first emission slot
    const int* __restrict__ counts,         // (V, N) emitted pairs
    float* __restrict__ d_table,            // (V, N, R) per-Gaussian rows
    int V, int N, int P, int R) {
  const long long item =
      static_cast<long long>(blockIdx.x) * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(V) * N) return;  // whole warp leaves
  const int lane = threadIdx.x & 31;
  const int v = static_cast<int>(item / N);
  const int lo = offsets[item];
  const int hi = min(lo + counts[item], P);
  const float* rows_v = d_rows + static_cast<size_t>(v) * P * R;
  const int* pos_v = pos_of_slot + static_cast<size_t>(v) * P;

  float acc[MAX_REC];
#pragma unroll
  for (int r = 0; r < MAX_REC; ++r) acc[r] = 0.0f;
  for (int s = lo + lane; s < hi; s += 32) {
    const int p = pos_v[s];
    if (p < P) {
      const float* row = rows_v + static_cast<size_t>(p) * R;
#pragma unroll
      for (int r = 0; r < MAX_REC; ++r)
        if (r < R) acc[r] += row[r];
    }
  }
  float out = 0.0f;
#pragma unroll
  for (int r = 0; r < MAX_REC; ++r) {
    if (r < R) {
      float x = acc[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
      if (lane == r) out = x;
    }
  }
  if (lane < R) d_table[static_cast<size_t>(item) * R + lane] = out;
}

}  // namespace

extern "C" {

// Launches the routing on `stream`: one warp per (view, Gaussian), R rows of
// 1..12.  Returns cudaGetLastError() (0 on success).
int splatpu_route_pairs(const void* d_rows, const void* pos_of_slot,
                        const void* offsets, const void* counts, void* d_table,
                        int V, int N, int P, int R, void* stream) {
  if (V < 1 || N < 1 || P < 1 || R < 1 || R > MAX_REC)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = static_cast<long long>(V) * N;
  const long long blocks = (items + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  route_pairs_kernel<<<static_cast<unsigned>(blocks), WARPS_PER_BLOCK * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_rows), static_cast<const int*>(pos_of_slot),
      static_cast<const int*>(offsets), static_cast<const int*>(counts),
      static_cast<float*>(d_table), V, N, P, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
