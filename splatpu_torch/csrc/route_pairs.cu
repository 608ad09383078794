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
// Two slot semantics, one per pair stream (a template flag):
//   exact (K2, K4): the slot map is pos_of_slot, (V, P) over the rows' P
//     positions; slots [offsets, min(offsets + counts, P)), and a slot whose
//     position is P (dropped by the sort) adds nothing
//     (exact.py::_route_to_table);
//   padded (K5): the slot map is the padded stream's q_of_slot at its own
//     length S = max_pairs; every slot s of [offsets, offsets + counts)
//     reads position q_of_slot[min(s, S - 1)], so on an overflowed render
//     each slot past the budget adds the last slot's row once, as
//     splatpu/render/pallas_composite.py::_composite_g_bwd's clipped
//     gather does.  Positions are clamped into the rows, as JAX's gather
//     clamps.
//
// Design.  One thread per (view, Gaussian, row), flattened as item * R + r,
// so no lane idles: the thread walks its Gaussian's slots serially, in slot
// order (a fixed order, so two runs give bitwise-identical sums), reads each
// slot's position (one broadcast address for the R threads of an item) and
// row r of that pair (the R threads read adjacent floats), and writes
// d_table[item * R + r] (a warp's stores are contiguous).  No shuffles, no
// atomics, no dependence on P.  The walk is serial per Gaussian, so a long
// slot run costs latency; at config 3's five 1280x720 training views
// (chip_smoke.py's measure phases) a Gaussian holds at most 40 slots of
// the exact stream (3.47 on average, 9 of 502,925 over 32) and 156 of the
// padded stream (9.52 on average, 5 over 128), so lanes per row for long
// runs would buy little.  The loop is unrolled by 4, so four slots' loads
// are in flight at once.
//
// What bounds it.  The bytes: each kept pair row is read once (through a
// gather), each slot's position once, the offsets and counts, and the table
// of gradients written once; one add per row read.  A 40-byte row (R = 10)
// spans two or three 32-byte sectors, so the gather moves ~1.6x the row
// bytes the bound counts.

#include <cuda_runtime.h>

namespace {

constexpr int MIN_REC = 8;           // 7 geometry rows + 1..9 colours
constexpr int MAX_REC = 16;
constexpr int THREADS = 128;

// The row count is a template parameter: the division of the thread index
// into (item, row) is by a constant.
template <int R, bool PADDED>
__global__ void __launch_bounds__(THREADS) route_pairs_kernel(
    const float* __restrict__ d_rows,       // (V, P, R) per-pair rows
    const int* __restrict__ slot_map,       // (V, S) slot -> position
    const int* __restrict__ offsets,        // (V, N) first emission slot
    const int* __restrict__ counts,         // (V, N) emitted pairs
    float* __restrict__ d_table,            // (V, N, R) per-Gaussian rows
    long long total, int N, int P, int S) {
  const long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long item = t / R;
  const int r = static_cast<int>(t - item * R);
  const int v = static_cast<int>(item / N);
  const int lo = offsets[item];
  const int cnt = counts[item];
  const float* rows_v = d_rows + static_cast<size_t>(v) * P * R + r;
  const int* map_v = slot_map + static_cast<size_t>(v) * S;

  float acc = 0.0f;
  if (PADDED) {
#pragma unroll 4
    for (int i = 0; i < cnt; ++i) {
      const int s = min(lo + i, S - 1);
      const int q = min(max(map_v[s], 0), P - 1);
      acc += rows_v[static_cast<size_t>(q) * R];
    }
  } else {
    const int hi = min(lo + cnt, P);
#pragma unroll 4
    for (int s = lo; s < hi; ++s) {
      const int p = map_v[s];
      if (p < P) acc += rows_v[static_cast<size_t>(p) * R];
    }
  }
  d_table[t] = acc;
}

}  // namespace

extern "C" {

// Launches the routing on `stream`: one thread per (view, Gaussian, row), R
// rows of 8..16 (7 + C, C of 1..9); the slot map is (V, S), S == P unless
// `padded`.  Returns cudaGetLastError() (0 on success).
int splatpu_route_pairs(const void* d_rows, const void* slot_map, const void* offsets,
                        const void* counts, void* d_table, int V, int N, int P, int S, int R,
                        int padded, void* stream) {
  if (V < 1 || N < 1 || P < 1 || S < 1 || R < MIN_REC || R > MAX_REC || (!padded && S != P))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(V) * N * R;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<const float*>(d_rows);
  const auto map = static_cast<const int*>(slot_map);
  const auto off = static_cast<const int*>(offsets);
  const auto cnt = static_cast<const int*>(counts);
  const auto out = static_cast<float*>(d_table);
#define SPLATPU_LAUNCH(NR)                                                                     \
  case NR:                                                                                     \
    if (padded)                                                                                \
      route_pairs_kernel<NR, true><<<grid, THREADS, 0, s>>>(rows, map, off, cnt, out, total, N, \
                                                             P, S);                            \
    else                                                                                       \
      route_pairs_kernel<NR, false><<<grid, THREADS, 0, s>>>(rows, map, off, cnt, out, total,  \
                                                              N, P, S);                        \
    break;
  switch (R) {
    SPLATPU_LAUNCH(8) SPLATPU_LAUNCH(9) SPLATPU_LAUNCH(10) SPLATPU_LAUNCH(11) SPLATPU_LAUNCH(12)
    SPLATPU_LAUNCH(13) SPLATPU_LAUNCH(14) SPLATPU_LAUNCH(15) SPLATPU_LAUNCH(16)
  }
#undef SPLATPU_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
