// The composite walk, written once for the four composite kernels.
//
// K1 (composite_fwd.cu), K2 (composite_bwd.cu), K4 (composite_manual_*.cu)
// and K5 (padded_*.cu) each replace their own TPU kernel and keep their own
// C entry point, but they compute one thing: per pixel, walk a tile's
// depth-sorted pairs,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,
//   alpha = min(0.99, op * exp(power)),
// skip the pair where power > 0 or alpha < 1/255, stop (without compositing
// that pair or any behind it) where T * (1 - alpha) would fall below 1e-4,
// else accumulate alpha * T into colour and depth and set T *= 1 - alpha.
// The forward body below does that front to back; the backward body walks
// back to front from the forward's `last`, rebuilding T by division, and
// writes one gradient row per pair.  Each kernel file is a thin
// instantiation of these bodies.
//
// Design (all four).  One block per (tile, view), one thread per pixel; the
// TPU's sequential chunk grid becomes a loop inside the block.  Records are
// staged through shared memory in batches of BATCH pairs.  The forward
// leaves its loop once every pixel is done (__syncthreads_count); pixels
// outside the image start done.  The backward starts at the tile's largest
// `last`, since pairs behind it have zero gradient.  A pair belongs to one
// (tile, view), so one block owns its row: each warp sums a pair's
// contributions with a butterfly of shuffles (skipped when no lane is
// live), lane 0 parks the warp's sums in shared memory, and after each batch
// the block adds the warps' sums in a fixed order and writes each row once.
// No atomics: two runs give bitwise-identical rows.  The channel count C is
// a template parameter, so a 3-channel launch keeps 3 accumulators in
// registers.  Every offset into gid, the records and the outputs is size_t:
// V * P * REC passes 2^31 above 2^24 pairs.
//
// The forward and backward of a kernel must see exactly the same pairs: the
// backward starts each pixel at the forward's `last` and rebuilds T by
// division.  So power is rounded op by op in the reference's order (no FMA
// contraction): far from an elongated splat's centre the terms are large
// and cancel, and a contracted form moves alpha by ~1e-5; this way the
// kernels and their plain PyTorch versions compute the same power.
//
// What bounds them.  Per evaluated (pixel, pair) ~16 FP32 operations and
// one exp forward (~20 backward), per contribution 4 + 2 (C + 1) more
// forward (a division and ~30 + 4C backward); the bytes are one record row
// per pair per block, the per-pixel inputs and the outputs.  So the FP32
// pipes bound them on the H100; the backward's per-pair shuffles (5 per row
// per live warp) are its largest cost above that bound.

#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace splatpu {

constexpr int REC_GEOM = 7;          // mx, my, ca, cb, cc, op, depth
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_EPS = 1e-4f;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The two families of TPU composite kernels.
enum class Family {
  // splatpu/render/exact.py (K1, K2, K4): records gathered by gid from the
  // (V, N, REC) per-Gaussian table, tile-local coordinates (means minus the
  // tile origin, pixel in tile), opacity row sum(dpower) / opacity.
  kExact,
  // splatpu/render/pallas_composite.py (K5): the (V, P, REC) per-pair rows
  // gathered before the call, absolute pixel coordinates, opacity row the
  // per-pixel sum of exp(power) * dalpha.
  kPadded,
};

struct Walk {                 // what both bodies read
  const float* rec;           // kExact: (V, N, REC) table; kPadded: (V, P, REC)
  const int* gid;             // kExact: (V, P) sorted pair -> Gaussian id
  const int* start;           // (V, T) segment starts
  const int* end;             // (V, T) segment ends
  const float* bg;            // (C,)
  int N, P, tiles_x, num_tiles, tile, width, height;
};

struct FwdOut {
  float* image;               // (V, C, H, W)
  float* depth;               // (V, H, W)
  float* tfinal;              // (V, H, W)
  int* last;                  // (V, H, W) last contributing position, -1 if none
};

struct BwdIn {
  const float* tfinal;        // (V, H, W) forward final T
  const int* last;            // (V, H, W) forward last position
  const float* g_img;         // (V, C, H, W) cotangents
  const float* g_depth;       // (V, H, W)
  const float* g_tf;          // (V, H, W)
  float* d_rows;              // (V, P, REC) per-pair rows, zeroed by the caller
};

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, rounded op by op.
__device__ __forceinline__ float pair_power(float ca, float cb, float cc, float dx,
                                            float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// Block-wide max of `x` through one shared int (initialised here); every
// thread of the block must call it.
__device__ __forceinline__ int block_max(int x, int* s_slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(FULL_MASK, x, off));
  if (threadIdx.x == 0) *s_slot = -1;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMax(s_slot, x);
  __syncthreads();
  return *s_slot;
}

// This thread's pixel in block (tile blockIdx.x, view blockIdx.y), in the
// family's frame: the records' means are staged minus (ox, oy), and the
// pixel sits at (fx, fy) in that frame.
struct Pixel {
  int px, py;
  bool inside;
  float ox, oy, fx, fy;
  size_t local;               // py * width + px
};

template <Family F>
__device__ __forceinline__ Pixel pixel_of(const Walk& w) {
  const int t = blockIdx.x;
  const int x0 = (t % w.tiles_x) * w.tile;
  const int y0 = (t / w.tiles_x) * w.tile;
  Pixel p;
  p.px = x0 + threadIdx.x % w.tile;
  p.py = y0 + threadIdx.x / w.tile;
  p.inside = p.px < w.width && p.py < w.height;
  const int fx0 = F == Family::kExact ? x0 : 0;
  const int fy0 = F == Family::kExact ? y0 : 0;
  p.ox = static_cast<float>(fx0);
  p.oy = static_cast<float>(fy0);
  p.fx = static_cast<float>(p.px - fx0);
  p.fy = static_cast<float>(p.py - fy0);
  p.local = static_cast<size_t>(p.py) * w.width + p.px;
  return p;
}

// Stages the records of positions [base + j_lo, base + j_hi) into columns
// j_lo..j_hi of s_rec, adjacent threads reading adjacent floats of a row.
template <Family F, int REC, int BATCH>
__device__ __forceinline__ void stage(float (&s_rec)[REC][BATCH], const Walk& w, int v,
                                      int base, int j_lo, int j_hi, const Pixel& p) {
  const size_t rows = F == Family::kExact ? w.N : w.P;
  const float* rec_v = w.rec + static_cast<size_t>(v) * rows * REC;
  for (int idx = j_lo * REC + threadIdx.x; idx < j_hi * REC; idx += blockDim.x) {
    const int j = idx / REC;
    const int r = idx - j * REC;
    const size_t row = F == Family::kExact
                           ? static_cast<size_t>(w.gid[static_cast<size_t>(v) * w.P + base + j])
                           : static_cast<size_t>(base + j);
    const float x = rec_v[row * REC + r];
    s_rec[r][j] = r == 0 ? x - p.ox : (r == 1 ? x - p.oy : x);
  }
}

// Forward composite of block (tile, view).  ALIGN stages chunks aligned to
// BATCH from start / BATCH, leaving out the neighbouring tiles' pairs in the
// first and last chunk, as the manual TPU kernel's chunk DMA does.
template <int C, Family F, int BATCH, bool ALIGN>
__device__ __forceinline__ void composite_fwd_body(const Walk& w, const FwdOut& out) {
  constexpr int REC = REC_GEOM + C;
  __shared__ float s_rec[REC][BATCH];

  const int v = blockIdx.y;
  const Pixel p = pixel_of<F>(w);
  const size_t vt = static_cast<size_t>(v) * w.num_tiles + blockIdx.x;
  const int seg_lo = w.start[vt];
  const int seg_hi = w.end[vt];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  float dep = 0.0f;
  int last = -1;
  int done = p.inside ? 0 : 1;

  const int first = ALIGN && seg_hi > seg_lo ? seg_lo / BATCH * BATCH : seg_lo;
  for (int base = first; base < seg_hi; base += BATCH) {
    // Barrier for the previous batch's readers, and the block-wide exit.
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int j_lo = max(seg_lo - base, 0);      // foreign pairs before
    const int j_hi = min(seg_hi - base, BATCH);  // and after the segment
    stage<F>(s_rec, w, v, base, j_lo, j_hi, p);
    __syncthreads();
    if (done) continue;
    for (int j = j_lo; j < j_hi; ++j) {
      const float power =
          pair_power(s_rec[2][j], s_rec[3][j], s_rec[4][j], p.fx - s_rec[0][j], p.fy - s_rec[1][j]);
      if (power > 0.0f) continue;
      const float alpha = fminf(ALPHA_MAX, s_rec[5][j] * expf(power));
      if (alpha < ALPHA_MIN) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = 1;
        break;
      }
      const float wt = alpha * T;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += wt * s_rec[REC_GEOM + c][j];
      dep += wt * s_rec[6][j];
      T = test_T;
      last = base + j;
    }
  }

  if (!p.inside) return;
  const size_t hw = static_cast<size_t>(w.width) * w.height;
  const size_t pix = static_cast<size_t>(v) * hw + p.local;
#pragma unroll
  for (int c = 0; c < C; ++c)
    out.image[(static_cast<size_t>(v) * C + c) * hw + p.local] = acc[c] + T * w.bg[c];
  out.depth[pix] = dep;
  out.tfinal[pix] = T;
  out.last[pix] = last;
}

// Backward composite of block (tile, view), for at most MAX_WARPS warps:
// per pixel, from the forward's `last` back to the tile's start,
//   T_excl  rebuilt from the final T by dividing by (1 - alpha) per live pair;
//   suffix  starts at T_final * (g_T + sum_c g_img_c * bg_c) and gathers
//           w * chat of the pairs behind;
//   chat  = g_depth * depth + sum_c g_img_c * colour_c,  w = alpha * T_excl;
//   dalpha = T_excl * chat - suffix / (1 - alpha);
//   dpower = alpha * dalpha where the raw alpha is below 0.99, else 0;
//   rows   [mx, my, ca, cb, cc, opacity, depth, colour...] summed over the
//          tile's pixels, the opacity row as the family says.
template <int C, Family F, int BATCH, int MAX_WARPS>
__device__ __forceinline__ void composite_bwd_body(const Walk& w, const BwdIn& g) {
  constexpr int REC = REC_GEOM + C;
  __shared__ float s_rec[REC][BATCH];
  __shared__ float s_part[MAX_WARPS][REC][BATCH];
  __shared__ int s_maxlast;

  const int v = blockIdx.y;
  const int tid = threadIdx.x;
  const int nwarps = blockDim.x >> 5;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Pixel p = pixel_of<F>(w);
  const size_t vt = static_cast<size_t>(v) * w.num_tiles + blockIdx.x;
  const int seg_lo = w.start[vt];
  const int seg_hi = w.end[vt];
  float* rows_v = g.d_rows + static_cast<size_t>(v) * w.P * REC;

  // Per-pixel state: T (walking back to T_excl), the suffix sum S, the
  // cotangents.  Pixels outside the image have last = -1 and never go live.
  const size_t hw = static_cast<size_t>(w.width) * w.height;
  const size_t pix = static_cast<size_t>(v) * hw + p.local;
  int my_last = -1;
  float T = 0.0f, S = 0.0f, gd = 0.0f;
  float gi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gi[c] = 0.0f;
  if (p.inside) {
    my_last = g.last[pix];
    T = g.tfinal[pix];
    gd = g.g_depth[pix];
    float gbg = g.g_tf[pix];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gi[c] = g.g_img[(static_cast<size_t>(v) * C + c) * hw + p.local];
      gbg += gi[c] * w.bg[c];
    }
    S = T * gbg;
  }

  // Pairs behind the tile's largest `last` keep the rows the caller zeroed.
  const int top_pos = min(seg_hi - 1, block_max(my_last, &s_maxlast));

  for (int top = top_pos; top >= seg_lo; top -= BATCH) {
    const int base = max(seg_lo, top - BATCH + 1);
    const int n = top - base + 1;
    __syncthreads();  // the previous batch's readers are done
    stage<F>(s_rec, w, v, base, 0, n, p);
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      float vals[REC];
#pragma unroll
      for (int r = 0; r < REC; ++r) vals[r] = 0.0f;
      bool live = false;
      if (base + j <= my_last) {
        const float dx = p.fx - s_rec[0][j];
        const float dy = p.fy - s_rec[1][j];
        const float ca = s_rec[2][j], cb = s_rec[3][j], cc = s_rec[4][j];
        const float power = pair_power(ca, cb, cc, dx, dy);  // the forward's rounding
        if (!(power > 0.0f)) {  // the forward's skip test
          const float e = expf(power);
          const float raw = s_rec[5][j] * e;
          const float alpha = fminf(ALPHA_MAX, raw);
          if (alpha >= ALPHA_MIN) {
            live = true;
            const float one_m = 1.0f - alpha;
            T = T / one_m;  // T before this pair
            float chat = gd * s_rec[6][j];
#pragma unroll
            for (int c = 0; c < C; ++c) chat += gi[c] * s_rec[REC_GEOM + c][j];
            const float wt = alpha * T;
            const float dalpha = T * chat - S / one_m;
            S += wt * chat;
            const bool unclamped = raw < ALPHA_MAX;
            const float dpower = unclamped ? alpha * dalpha : 0.0f;
            vals[0] = (ca * dx + cb * dy) * dpower;
            vals[1] = (cc * dy + cb * dx) * dpower;
            vals[2] = -0.5f * dx * dx * dpower;
            vals[3] = -dx * dy * dpower;
            vals[4] = -0.5f * dy * dy * dpower;
            if (F == Family::kExact)
              vals[5] = dpower;  // divided by the opacity after the sum
            else
              vals[5] = unclamped ? e * dalpha : 0.0f;
            vals[6] = wt * gd;
#pragma unroll
            for (int c = 0; c < C; ++c) vals[REC_GEOM + c] = wt * gi[c];
          }
        }
      }
      if (__any_sync(FULL_MASK, live)) {
#pragma unroll
        for (int r = 0; r < REC; ++r) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            vals[r] += __shfl_xor_sync(FULL_MASK, vals[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < REC; ++r) s_part[warp][r][j] = vals[r];
      }
    }
    __syncthreads();

    // Fixed-order sum over the warps, one (pair, row) per thread; adjacent
    // threads write adjacent floats of the (P, REC) rows.
    for (int idx = tid; idx < n * REC; idx += blockDim.x) {
      const int j = idx / REC;
      const int r = idx - j * REC;
      float sum = 0.0f;
      for (int k = 0; k < nwarps; ++k) sum += s_part[k][r][j];
      if (F == Family::kExact && r == 5) {
        const float op = s_rec[5][j];
        sum = op > 0.0f ? sum / fmaxf(op, 1e-30f) : 0.0f;
      }
      rows_v[static_cast<size_t>(base + j) * REC + r] = sum;
    }
  }
}

// Calls fn(std::integral_constant<int, C>{}) for the C of 1..MAX_C that
// equals `channels`; false if none does.
template <typename Fn, int... Cs>
bool with_channels_impl(int channels, Fn&& fn, std::integer_sequence<int, Cs...>) {
  return ((channels == Cs + 1 ? (fn(std::integral_constant<int, Cs + 1>{}), true) : false) ||
          ...);
}

template <int MAX_C, typename Fn>
bool with_channels(int channels, Fn&& fn) {
  return with_channels_impl(channels, fn, std::make_integer_sequence<int, MAX_C>{});
}

}  // namespace splatpu
