// First-generation padded backward composite (K5) for Hopper (sm_90a),
// behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/pallas_composite.py::_bwd_kernel
// (launched by _composite_bwd_call).  Per pixel, walk the tile's aligned
// segment back to front from the forward's int32 `last` and write one
// gradient row per padded position, summed over the tile's pixels.  As in
// the TPU kernel: absolute pixel coordinates (padded_fwd.cu), and the
// opacity row is the per-pixel sum of exp(power) * dalpha where the raw
// alpha is below 0.99 (the grid and manual kernels divide sum(dpower) by
// the opacity instead).  The wrapper zeroes the rows first, so the padding
// in a tile's last chunk, the pairs behind the tile's largest `last` and
// the tail past the last segment come out as zero rows (the TPU caller
// masks its unwritten tail instead).  The walk is composite_common.cuh's
// backward body (family kPadded), instantiated here for 1..9 channels.

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 9;
constexpr int TILE = 16;

template <int C>
__global__ void __launch_bounds__(bwd_threads(TILE), bwd_min_blocks(TILE, C))
    padded_bwd_kernel(Walk w, BwdIn g) {
  composite_bwd_body<C, Family::kPadded, TILE>(w, g);
}

}  // namespace

extern "C" {

// Launches K5's backward on `stream` over a (num_tiles, V) grid of
// bwd_threads(16) = 64 threads, C of 1..9; `d_rows` must be zeroed by the
// caller.  Returns cudaGetLastError() (0 on success).
int splatpu_padded_bwd(const void* records, const void* start, const void* end, const void* bg,
                       const void* tfinal, const void* last, const void* g_img,
                       const void* g_depth, const void* g_tf, void* d_rows, int V, int Pp, int C,
                       int tiles_x, int tiles_y, int width, int height, void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(records), nullptr, static_cast<const int*>(start),
               static_cast<const int*>(end), static_cast<const float*>(bg), 0, Pp, tiles_x,
               tiles_x * tiles_y, TILE, width, height};
  const BwdIn g{static_cast<const float*>(tfinal), static_cast<const int*>(last),
                static_cast<const float*>(g_img), static_cast<const float*>(g_depth),
                static_cast<const float*>(g_tf), static_cast<float*>(d_rows)};
  const dim3 grid(w.num_tiles, V);
  with_channels<MAX_C>(C, [&](auto nc) {
    padded_bwd_kernel<decltype(nc)::value>
        <<<grid, bwd_threads(TILE), 0, static_cast<cudaStream_t>(stream)>>>(w, g);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
