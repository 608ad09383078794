// Manual backward tile composite (K4) for Hopper (sm_90a), behind a plain C
// launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_bwd_kernel (launched by
// _bwd_call under BinningConfig.kernel="manual").  Same contract as the grid
// backward K2 (composite_bwd.cu), up to 9 colour channels and any pair
// budget, as the forward (composite_manual_fwd.cu).  The TPU kernel writes
// chunk-aligned gradient blocks and read-modify-writes the first chunk,
// which the previous tile shares; here a pair belongs to exactly one
// (tile, view), so the block that owns it writes its row once, and only the
// tile's own pairs are written: no read-modify-write and no atomics.  The
// walk is composite_common.cuh's backward body, instantiated here for 1..9
// channels at every multiple of 8 from 8 to 64 px.

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 9;
template <int C, int TILE>
__global__ void __launch_bounds__(bwd_threads(TILE), bwd_min_blocks(TILE, C))
    manual_bwd_kernel(Walk w, BwdIn g) {
  composite_bwd_body<C, Family::kExact, TILE>(w, g);
}

}  // namespace

extern "C" {

// Launches K4's backward on `stream` over a (num_tiles, V) grid of
// bwd_threads(tile) threads, tile a multiple of 8 up to 64, C of 1..9;
// `d_rows` must be zeroed by the caller.  Returns cudaGetLastError() (0 on success).
int splatpu_composite_manual_bwd(const void* table, const void* gid, const void* start,
                                 const void* end, const void* bg, const void* tfinal,
                                 const void* last, const void* g_img, const void* g_depth,
                                 const void* g_tf, void* d_rows, int V, int N, int P, int C,
                                 int tiles_x, int tiles_y, int tile, int width, int height,
                                 void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(table), static_cast<const int*>(gid),
               static_cast<const int*>(start), static_cast<const int*>(end),
               static_cast<const float*>(bg), N, P, tiles_x, tiles_x * tiles_y, width, height};
  const BwdIn g{static_cast<const float*>(tfinal), static_cast<const int*>(last),
                static_cast<const float*>(g_img), static_cast<const float*>(g_depth),
                static_cast<const float*>(g_tf), static_cast<float*>(d_rows)};
  const dim3 grid(w.num_tiles, V);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool tile_ok = with_tile(BwdTiles{}, tile, [&](auto nt) {
    constexpr int TILE = decltype(nt)::value;
    with_channels<MAX_C>(C, [&](auto nc) {
      manual_bwd_kernel<decltype(nc)::value, TILE><<<grid, bwd_threads(TILE), 0, s>>>(w, g);
    });
  });
  if (!tile_ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
