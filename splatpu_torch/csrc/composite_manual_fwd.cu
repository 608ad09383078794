// Manual forward tile composite (K4) for Hopper (sm_90a), behind a plain C
// launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_fwd_kernel (launched by
// _fwd_call under BinningConfig.kernel="manual").  Same contract as the grid
// kernel K1 (composite_fwd.cu); what "manual" adds is its reach: up to 9
// colour channels (NREC - R_COLOR0 of the TPU kernels) and any pair budget,
// where the grid kernel stops at 5 channels and 2^24 pairs.  As the TPU
// kernel's chunk DMA does, it stages chunks aligned to BATCH from
// start / BATCH and leaves out the neighbouring tiles' pairs.  The walk is
// composite_common.cuh's forward body, instantiated here for 1..9 channels.

#include "composite_common.cuh"

namespace {

using namespace splatpu;

constexpr int MAX_C = 9;
constexpr int BATCH = 256;  // pairs staged per shared-memory chunk

template <int C>
__global__ void __launch_bounds__(1024) manual_fwd_kernel(Walk w, FwdOut out) {
  composite_fwd_body<C, Family::kExact, BATCH, true>(w, out);
}

}  // namespace

extern "C" {

// Launches K4's forward on `stream` over a (num_tiles, V) grid of tile*tile
// threads, C of 1..9; returns cudaGetLastError() (0 on success).
int splatpu_composite_manual_fwd(const void* table, const void* gid, const void* start,
                                 const void* end, const void* bg, void* image, void* depth,
                                 void* tfinal, void* last, int V, int N, int P, int C,
                                 int tiles_x, int tiles_y, int tile, int width, int height,
                                 void* stream) {
  if (C < 1 || C > MAX_C || tile < 1 || tile * tile > 1024 || V < 1 || V > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk w{static_cast<const float*>(table), static_cast<const int*>(gid),
               static_cast<const int*>(start), static_cast<const int*>(end),
               static_cast<const float*>(bg), N, P, tiles_x, tiles_x * tiles_y, tile,
               width, height};
  const FwdOut out{static_cast<float*>(image), static_cast<float*>(depth),
                   static_cast<float*>(tfinal), static_cast<int*>(last)};
  const dim3 grid(w.num_tiles, V);
  with_channels<MAX_C>(C, [&](auto nc) {
    manual_fwd_kernel<decltype(nc)::value>
        <<<grid, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(w, out);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
