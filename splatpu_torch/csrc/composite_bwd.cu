// Backward tile composite for Hopper (sm_90a), behind a plain C launcher.
//
// Replaces the TPU kernel splatpu/render/exact.py::_bwd_kernel_grid
// (launched by _bwd_call_grid).  Same observable contract: for every pixel,
// walk the tile's depth-sorted pairs BACK to front, from the pixel's last
// contributing pair (the forward kernel's int32 `last`) down to the tile's
// start, and write one gradient row per pair:
//
//   T_excl  rebuilt from the final T by dividing by (1 - alpha) per live pair;
//   suffix  starts at T_final * (g_T + sum_c g_img_c * bg_c) and gathers
//           w * chat of the pairs behind;
//   chat  = g_depth * depth + sum_c g_img_c * colour_c,  w = alpha * T_excl;
//   dalpha = T_excl * chat - suffix / (1 - alpha);
//   dpower = alpha * dalpha where the raw alpha is below 0.99, else 0;
//   rows   [mx, my, ca, cb, cc, opacity, depth, colour...] summed over the
//          tile's pixels, as exact.py::_grad_contrib writes them; the opacity
//          row is sum(dpower) / opacity where opacity > 0.
//
// Design.  One block per (tile, view), one thread per pixel, all V views in
// one launch; the TPU's sequential chunk grid becomes a loop inside the
// block, from the tile's largest `last` down.  Records come through shared
// memory in batches of BATCH pairs, gathered by gid from the per-Gaussian
// table and made tile-local exactly as the forward kernel does.  Power and
// alpha are rounded op by op (__fmul_rn / __fsub_rn, no FMA contraction) as
// in composite_fwd.cu, so the skip tests and the T rebuild agree with the
// forward pass pair for pair.  A pair belongs to exactly one (tile, view), so
// one block owns its row: each warp sums a pair's contributions with a
// butterfly of shuffles (skipped when no lane of the warp is live), lane 0
// parks the warp's sums in shared memory, and after the batch the block adds
// the warps' sums in a fixed order and writes the rows.  No global atomics:
// two runs give bitwise-identical rows.
//
// What bounds it.  Per evaluated (pixel, pair) ~20 FP32 operations and one
// exp; per live one two divisions and ~30 more for the rows; the bytes are
// one table row per pair, the per-pixel inputs and the pair rows out.  So
// the FP32 pipes bound it on the H100, and the shuffles of the per-pair
// reduction (5 per row per live warp) are the largest cost above that
// bound.  Making it fast (one warp per pair row instead of per pixel row,
// reducing several pairs per shuffle round) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 5;             // colour channels the kernel takes
constexpr int REC_GEOM = 7;          // mx, my, ca, cb, cc, op, depth
constexpr int MAX_REC = REC_GEOM + MAX_C;
constexpr int BATCH = 16;            // pairs staged per shared-memory batch
constexpr int MAX_WARPS = 32;        // 1024 threads
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float* __restrict__ table,   // (V, N, REC) per-Gaussian records
    const int* __restrict__ gid,       // (V, P) sorted pair -> gaussian id
    const int* __restrict__ start,     // (V, T) segment starts
    const int* __restrict__ end,       // (V, T) segment ends
    const float* __restrict__ bg,      // (C,)
    const float* __restrict__ tfinal,  // (V, H, W) forward final T
    const int* __restrict__ last_in,   // (V, H, W) forward last position
    const float* __restrict__ g_img,   // (V, C, H, W) cotangents
    const float* __restrict__ g_depth, // (V, H, W)
    const float* __restrict__ g_tf,    // (V, H, W)
    float* __restrict__ d_rows,        // (V, P, REC) per-pair rows (zeroed)
    int N, int P, int C, int tiles_x, int num_tiles, int tile, int width,
    int height) {
  __shared__ float s_rec[MAX_REC][BATCH];
  __shared__ float s_part[MAX_WARPS][MAX_REC][BATCH];
  __shared__ int s_maxlast;

  const int t = blockIdx.x;
  const int v = blockIdx.y;
  const int tid = threadIdx.x;
  const int npix = blockDim.x;
  const int nwarps = npix >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
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
  float* rows_v = d_rows + static_cast<size_t>(v) * P * rec_n;

  // Per-pixel state: T (walking back to T_excl), the suffix sum S, the
  // cotangents.  Pixels outside the image have last = -1 and never go live.
  const size_t hw = static_cast<size_t>(width) * height;
  const size_t local = static_cast<size_t>(py) * width + px;
  const size_t pix = static_cast<size_t>(v) * hw + local;
  int my_last = -1;
  float T = 0.0f, S = 0.0f, gd = 0.0f;
  float gi[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) gi[c] = 0.0f;
  if (inside) {
    my_last = last_in[pix];
    T = tfinal[pix];
    gd = g_depth[pix];
    float gbg = g_tf[pix];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) {
        gi[c] = g_img[(static_cast<size_t>(v) * C + c) * hw + local];
        gbg += gi[c] * bg[c];
      }
    }
    S = T * gbg;
  }

  // The walk starts at the tile's largest `last`: pairs behind it have zero
  // gradient (their rows stay as the wrapper zeroed them).
  int wmax = my_last;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) wmax = max(wmax, __shfl_xor_sync(FULL, wmax, off));
  if (tid == 0) s_maxlast = -1;
  __syncthreads();
  if (lane == 0) atomicMax(&s_maxlast, wmax);
  __syncthreads();
  const int top_pos = min(seg_hi - 1, s_maxlast);

  for (int top = top_pos; top >= seg_lo; top -= BATCH) {
    const int base = max(seg_lo, top - BATCH + 1);
    const int n = top - base + 1;
    __syncthreads();  // the previous batch's readers are done
    for (int idx = tid; idx < n * rec_n; idx += npix) {
      const int j = idx / rec_n;
      const int r = idx - j * rec_n;
      const float x = table_v[static_cast<size_t>(gid_v[base + j]) * rec_n + r];
      s_rec[r][j] = r == 0 ? x - ox : (r == 1 ? x - oy : x);
    }
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      const int pos = base + j;
      float vals[MAX_REC];
#pragma unroll
      for (int r = 0; r < MAX_REC; ++r) vals[r] = 0.0f;
      bool live = false;
      if (pos <= my_last) {
        const float dx = fx - s_rec[0][j];
        const float dy = fy - s_rec[1][j];
        const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
        const float op = s_rec[5][j];
        // The forward kernel's rounding, op by op.
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        if (!(power > 0.0f)) {  // the forward kernel's skip test
          const float raw = op * expf(power);
          const float alpha = fminf(ALPHA_MAX, raw);
          if (alpha >= ALPHA_MIN) {
            live = true;
            const float one_m = 1.0f - alpha;
            T = T / one_m;  // T before this pair
            float chat = gd * s_rec[6][j];
#pragma unroll
            for (int c = 0; c < MAX_C; ++c)
              if (c < C) chat += gi[c] * s_rec[REC_GEOM + c][j];
            const float w = alpha * T;
            const float dalpha = T * chat - S / one_m;
            S += w * chat;
            const float dpower = raw < ALPHA_MAX ? alpha * dalpha : 0.0f;
            vals[0] = (ca * dx + cb * dy) * dpower;
            vals[1] = (cc * dy + cb * dx) * dpower;
            vals[2] = -0.5f * dx * dx * dpower;
            vals[3] = -dx * dy * dpower;
            vals[4] = -0.5f * dy * dy * dpower;
            vals[5] = dpower;
            vals[6] = w * gd;
#pragma unroll
            for (int c = 0; c < MAX_C; ++c)
              if (c < C) vals[REC_GEOM + c] = w * gi[c];
          }
        }
      }
      if (__any_sync(FULL, live)) {
#pragma unroll
        for (int r = 0; r < MAX_REC; ++r) {
          if (r < rec_n) {
            float x = vals[r];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
            vals[r] = x;
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < MAX_REC; ++r)
          if (r < rec_n) s_part[warp][r][j] = vals[r];
      }
    }
    __syncthreads();

    // Fixed-order sum over the warps, one (pair, row) per thread; adjacent
    // threads write adjacent floats of the (P, REC) rows.
    for (int idx = tid; idx < n * rec_n; idx += npix) {
      const int j = idx / rec_n;
      const int r = idx - j * rec_n;
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w) sum += s_part[w][r][j];
      if (r == 5) {
        const float op = s_rec[5][j];
        sum = op > 0.0f ? sum / fmaxf(op, 1e-30f) : 0.0f;
      }
      rows_v[static_cast<size_t>(base + j) * rec_n + r] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Launches the backward composite on `stream` over a (num_tiles, V) grid of
// tile*tile threads (a multiple of 32, at most 1024); `d_rows` must be
// zeroed by the caller.  Returns cudaGetLastError() (0 on success).
int splatpu_composite_bwd(const void* table, const void* gid, const void* start,
                          const void* end, const void* bg, const void* tfinal,
                          const void* last, const void* g_img, const void* g_depth,
                          const void* g_tf, void* d_rows, int V, int N, int P,
                          int C, int tiles_x, int tiles_y, int tile, int width,
                          int height, void* stream) {
  if (C < 1 || C > MAX_C || tile < 1 || tile * tile > 1024 || (tile * tile) % 32 != 0 ||
      V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_tiles = tiles_x * tiles_y;
  dim3 grid(num_tiles, V);
  composite_bwd_kernel<<<grid, tile * tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(gid),
      static_cast<const int*>(start), static_cast<const int*>(end),
      static_cast<const float*>(bg), static_cast<const float*>(tfinal),
      static_cast<const int*>(last), static_cast<const float*>(g_img),
      static_cast<const float*>(g_depth), static_cast<const float*>(g_tf),
      static_cast<float*>(d_rows), N, P, C, tiles_x, num_tiles, tile, width, height);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
