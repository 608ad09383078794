// Backward tile composite (K2) for Hopper (sm_90a), behind a plain C
// launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_bwd_kernel_grid
// (launched by _bwd_call_grid): per pixel, walk the tile's pairs back to
// front from the forward kernel's int32 `last` and write one gradient row
// per pair, [mx, my, ca, cb, cc, opacity, depth, colour...] summed over the
// tile's pixels as exact.py::_grad_contrib writes them; the opacity row is
// sum(dpower) / opacity where opacity > 0.  The walk is
// composite_common.cuh's backward body; this file instantiates it for 1..5
// channels at 16 and 32 px tiles (64 and 256 threads of 4 pixels each).

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 5;
template <int C, int TILE>
__global__ void __launch_bounds__(bwd_threads(TILE), bwd_min_blocks(TILE, C))
    composite_bwd_kernel(Walk w, BwdIn g) {
  composite_bwd_body<C, Family::kExact, TILE>(w, g);
}

}  // namespace

extern "C" {

// Launches the backward composite on `stream` over a (num_tiles, V) grid of
// bwd_threads(tile) threads, tile 16 or 32; `d_rows` must be zeroed by the
// caller.  Returns cudaGetLastError() (0 on success).
int splatpu_composite_bwd(const void* table, const void* gid, const void* start,
                          const void* end, const void* bg, const void* tfinal,
                          const void* last, const void* g_img, const void* g_depth,
                          const void* g_tf, void* d_rows, int V, int N, int P,
                          int C, int tiles_x, int tiles_y, int tile, int width,
                          int height, void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(table), static_cast<const int*>(gid),
               static_cast<const int*>(start), static_cast<const int*>(end),
               static_cast<const float*>(bg), N, P, tiles_x, tiles_x * tiles_y, tile,
               width, height};
  const BwdIn g{static_cast<const float*>(tfinal), static_cast<const int*>(last),
                static_cast<const float*>(g_img), static_cast<const float*>(g_depth),
                static_cast<const float*>(g_tf), static_cast<float*>(d_rows)};
  const dim3 grid(w.num_tiles, V);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool tile_ok = with_bwd_tile(tile, [&](auto nt) {
    constexpr int TILE = decltype(nt)::value;
    with_channels<MAX_C>(C, [&](auto nc) {
      composite_bwd_kernel<decltype(nc)::value, TILE><<<grid, bwd_threads(TILE), 0, s>>>(w, g);
    });
  });
  if (!tile_ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
