// Forward tile composite for Hopper (sm_90a), behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_fwd_kernel_grid (launched
// by _fwd_call_grid).  Same observable contract: for every pixel, walk the
// tile's depth-sorted pairs front to back;
//   alpha = min(0.99, op * exp(power)),
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,
// skip the pair where power > 0 or alpha < 1/255; stop (without compositing
// that pair or any behind it) where T * (1 - alpha) would fall below 1e-4;
// otherwise accumulate alpha*T into colour and depth, set T *= 1 - alpha and
// remember the pair's position.  The pixel ends as image = acc + bg * T.
//
// Design.  One block per (tile, view), one thread per pixel (tile 32 ->
// 1024 threads).  Blocks are independent, so the TPU's sequential chunk grid
// and its carried scratch become a loop inside the block.  The tile's
// [start, end) pairs are staged through shared memory in batches of BATCH;
// each record is gathered here from the per-Gaussian table by gid, so there
// is no gathered (16, P) copy in device memory as on the TPU.  The block
// leaves its loop once every pixel is done (__syncthreads_count); pixels
// outside the image start done.
//
// What bounds it.  Per (pixel, pair) evaluation the work is ~16 FP32
// operations and one exp; bytes are one table row per pair per block plus
// the outputs, so on the H100 the arithmetic bound is the larger one.  The
// serial per-pixel walk keeps every evaluation in registers and reads each
// record from shared memory once per thread; the early block exit skips
// the pairs behind opaque pixels.  Making it fast (warp-level culling of
// pairs, fewer threads per pixel row, overlapping the next batch's gather)
// is later work.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 5;             // colour channels the kernel takes
constexpr int REC_GEOM = 7;          // mx, my, ca, cb, cc, op, depth
constexpr int MAX_REC = REC_GEOM + MAX_C;
constexpr int BATCH = 256;           // pairs staged per shared-memory batch
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;

__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const float* __restrict__ table,  // (V, N, REC) per-Gaussian records
    const int* __restrict__ gid,      // (V, P) sorted pair -> gaussian id
    const int* __restrict__ start,    // (V, T) segment starts
    const int* __restrict__ end,      // (V, T) segment ends
    const float* __restrict__ bg,     // (C,)
    float* __restrict__ image,        // (V, C, H, W)
    float* __restrict__ depth_out,    // (V, H, W)
    float* __restrict__ tfinal,       // (V, H, W)
    int* __restrict__ last_out,       // (V, H, W)
    int N, int P, int C, int tiles_x, int num_tiles, int tile, int width,
    int height) {
  __shared__ float s_rec[MAX_REC][BATCH];

  const int t = blockIdx.x;
  const int v = blockIdx.y;
  const int tid = threadIdx.x;
  const int npix = blockDim.x;
  const int rec_n = REC_GEOM + C;

  const int lx = tid % tile;
  const int ly = tid / tile;
  const int tx = t % tiles_x;
  const int ty = t / tiles_x;
  const float ox = static_cast<float>(tx * tile);
  const float oy = static_cast<float>(ty * tile);
  const int px = tx * tile + lx;
  const int py = ty * tile + ly;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(lx);
  const float fy = static_cast<float>(ly);

  const int seg_lo = start[v * num_tiles + t];
  const int seg_hi = end[v * num_tiles + t];
  const int* gid_v = gid + static_cast<size_t>(v) * P;
  const float* table_v = table + static_cast<size_t>(v) * N * rec_n;

  float T = 1.0f;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.0f;
  float dep = 0.0f;
  int last = -1;
  int done = inside ? 0 : 1;

  for (int base = seg_lo; base < seg_hi; base += BATCH) {
    // Barrier for the previous batch's readers, and the block-wide exit.
    if (__syncthreads_count(done) == npix) break;
    const int n = min(BATCH, seg_hi - base);
    for (int j = tid; j < n; j += npix) {
      const float* rec = table_v + static_cast<size_t>(gid_v[base + j]) * rec_n;
      // Tile-local means keep dx, dy small and well conditioned in f32.
      s_rec[0][j] = rec[0] - ox;
      s_rec[1][j] = rec[1] - oy;
      for (int r = 2; r < rec_n; ++r) s_rec[r][j] = rec[r];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = fx - s_rec[0][j];
      const float dy = fy - s_rec[1][j];
      // Rounded op by op in the reference's order (no FMA contraction):
      // far from an elongated splat's centre the terms are large and
      // cancel, and a contracted form moves alpha by ~1e-5.  This way the
      // kernel and its plain version compute the same power on the card.
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(s_rec[2][j], dx), dx),
                                   __fmul_rn(__fmul_rn(s_rec[4][j], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(s_rec[3][j], dx), dy));
      if (power > 0.0f) continue;
      const float alpha = fminf(ALPHA_MAX, s_rec[5][j] * expf(power));
      if (alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = 1;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) acc[c] += w * s_rec[REC_GEOM + c][j];
      dep += w * s_rec[6][j];
      T = test_T;
      last = base + j;
    }
  }

  if (!inside) return;
  const size_t hw = static_cast<size_t>(width) * height;
  const size_t pix = static_cast<size_t>(py) * width + px;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c)
    if (c < C) image[(static_cast<size_t>(v) * C + c) * hw + pix] = acc[c] + T * bg[c];
  depth_out[v * hw + pix] = dep;
  tfinal[v * hw + pix] = T;
  last_out[v * hw + pix] = last;
}

}  // namespace

extern "C" {

// Launches the composite on `stream` over a (num_tiles, V) grid of
// tile*tile threads; returns cudaGetLastError() (0 on success).
int splatpu_composite_fwd(const void* table, const void* gid, const void* start,
                          const void* end, const void* bg, void* image,
                          void* depth, void* tfinal, void* last, int V, int N,
                          int P, int C, int tiles_x, int tiles_y, int tile,
                          int width, int height, void* stream) {
  if (C < 1 || C > MAX_C || tile < 1 || tile * tile > 1024 || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = tiles_x * tiles_y;
  dim3 grid(num_tiles, V);
  composite_fwd_kernel<<<grid, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(gid),
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const float*>(bg), static_cast<float*>(image),
      static_cast<float*>(depth), static_cast<float*>(tfinal),
      static_cast<int*>(last), N, P, C, tiles_x, num_tiles, tile, width, height);
  return static_cast<int>(cudaGetLastError());
}

const char* splatpu_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
