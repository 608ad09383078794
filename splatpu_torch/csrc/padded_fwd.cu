// First-generation padded forward composite (K5) for Hopper (sm_90a),
// behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/pallas_composite.py::_fwd_kernel
// (launched by _composite_fwd_call, behind render(impl="pallas_padded")).
// It composites the chunk-aligned padded pair stream (build_pair_stream):
// 16 px tiles, each tile's segment starting on a chunk boundary, the
// records gathered per pair before the call, the segment tested by
// pos < end only.  As the TPU kernel, it works in ABSOLUTE pixel
// coordinates (dx = px - mx, px the pixel's column in the image; the grid
// and manual kernels work tile-local).  The TPU kernel counts failing pairs
// along the chunk and keeps those before the first, which is the serial
// walk's stop at the pair that would take T below 1e-4.  `last` is the
// int32 padded position of the last pair that contributed.  The walk is
// composite_common.cuh's forward body (family kPadded), instantiated here
// for 1..9 channels at 16 px tiles, one block of fwd_threads(16) = 128
// threads of 2 pixels per tile; each batch is one coalesced sweep over
// contiguous rows, with no gather.

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 9;
constexpr int TILE = 16;

template <int C>
__global__ void __launch_bounds__(fwd_threads(TILE), fwd_min_blocks(TILE, C))
    padded_fwd_kernel(Walk w, FwdOut out) {
  composite_fwd_body<C, Family::kPadded, TILE>(w, out);
}

}  // namespace

extern "C" {

// Launches K5's forward on `stream` over a (num_tiles, V) grid of
// fwd_threads(16) threads, C of 1..9; returns cudaGetLastError() (0 on
// success).
int splatpu_padded_fwd(const void* records, const void* start, const void* end, const void* bg,
                       void* image, void* depth, void* tfinal, void* last, int V, int Pp, int C,
                       int tiles_x, int tiles_y, int width, int height, void* stream) {
  if (C < 1 || C > MAX_C || V < 1 || V > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(records), nullptr, static_cast<const int*>(start),
               static_cast<const int*>(end), static_cast<const float*>(bg), 0, Pp, tiles_x,
               tiles_x * tiles_y, width, height};
  const FwdOut out{static_cast<float*>(image), static_cast<float*>(depth),
                   static_cast<float*>(tfinal), static_cast<int*>(last)};
  const dim3 grid(w.num_tiles * fwd_blocks_per_tile(TILE), V);
  with_channels<MAX_C>(C, [&](auto nc) {
    padded_fwd_kernel<decltype(nc)::value>
        <<<grid, fwd_threads(TILE), 0, static_cast<cudaStream_t>(stream)>>>(w, out);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
