// Forward tile composite (K1) for Hopper (sm_90a), behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_fwd_kernel_grid
// (launched by _fwd_call_grid): the exact-binned forward composite over the
// tile's [start, end) pairs, records gathered by gid from the per-Gaussian
// table, at most 5 colour channels (the grid kernel's limit).  The walk is
// composite_common.cuh's forward body; this file instantiates it for 1..5
// channels at every multiple of 8 from 8 to 64 px (fwd_blocks_per_tile(tile)
// blocks of fwd_threads(tile) threads of 2 pixels each per tile).

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 5;

template <int C, int TILE>
__global__ void __launch_bounds__(fwd_threads(TILE), fwd_min_blocks(TILE, C))
    composite_fwd_kernel(Walk w, FwdOut out) {
  composite_fwd_body<C, Family::kExact, TILE>(w, out);
}

}  // namespace

extern "C" {

// Launches the composite on `stream` over a (num_tiles *
// fwd_blocks_per_tile(tile), V) grid of fwd_threads(tile) threads, tile a
// multiple of 8 up to 64; returns cudaGetLastError() (0 on success).
int splatpu_composite_fwd(const void* table, const void* gid, const void* start,
                          const void* end, const void* bg, void* image,
                          void* depth, void* tfinal, void* last, int V, int N,
                          int P, int C, int tiles_x, int tiles_y, int tile,
                          int width, int height, void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(table), static_cast<const int*>(gid),
               static_cast<const int*>(start), static_cast<const int*>(end),
               static_cast<const float*>(bg), N, P, tiles_x, tiles_x * tiles_y, width, height};
  const FwdOut out{static_cast<float*>(image), static_cast<float*>(depth),
                   static_cast<float*>(tfinal), static_cast<int*>(last)};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool tile_ok = with_tile(FwdTiles{}, tile, [&](auto nt) {
    constexpr int TILE = decltype(nt)::value;
    const dim3 grid(w.num_tiles * fwd_blocks_per_tile(TILE), V);
    with_channels<MAX_C>(C, [&](auto nc) {
      composite_fwd_kernel<decltype(nc)::value, TILE><<<grid, fwd_threads(TILE), 0, s>>>(w, out);
    });
  });
  if (!tile_ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* splatpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
