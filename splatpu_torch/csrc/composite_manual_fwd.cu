// Manual forward tile composite (K4) for Hopper (sm_90a), behind a plain C
// launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_fwd_kernel (launched by
// _fwd_call under BinningConfig.kernel="manual").  Same contract as the grid
// kernel K1 (composite_fwd.cu); what "manual" adds is its reach: up to 9
// colour channels (NREC - R_COLOR0 of the TPU kernels) and any pair budget,
// where the grid kernel stops at 5 channels and 2^24 pairs.  The walk is
// composite_common.cuh's forward body, instantiated here for 1..9 channels
// at every multiple of 8 from 8 to 64 px.  (The TPU kernel's chunk DMA starts on
// chunk boundaries and masks the neighbouring tiles' pairs; where a batch
// starts does not change which pairs a pixel sees, so this kernel stages
// from the segment's start, as K1 does.)

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 9;

template <int C, int TILE>
__global__ void __launch_bounds__(fwd_threads(TILE), fwd_min_blocks(TILE, C))
    manual_fwd_kernel(Walk w, FwdOut out) {
  composite_fwd_body<C, Family::kExact, TILE>(w, out);
}

}  // namespace

extern "C" {

// Launches K4's forward on `stream` over a (num_tiles *
// fwd_blocks_per_tile(tile), V) grid of fwd_threads(tile) threads, tile a
// multiple of 8 up to 64, C of 1..9; returns cudaGetLastError() (0 on
// success).
int splatpu_composite_manual_fwd(const void* table, const void* gid, const void* start,
                                 const void* end, const void* bg, void* image, void* depth,
                                 void* tfinal, void* last, int V, int N, int P, int C,
                                 int tiles_x, int tiles_y, int tile, int width, int height,
                                 void* stream) {
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
      manual_fwd_kernel<decltype(nc)::value, TILE><<<grid, fwd_threads(TILE), 0, s>>>(w, out);
    });
  });
  if (!tile_ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
