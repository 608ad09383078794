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
// Design.  One block per (tile, view); the TPU's sequential chunk grid
// becomes a loop inside the block.  Records are staged through shared
// memory in batches of BATCH pairs.  The forward runs one thread per pixel
// and leaves its loop once every pixel is done (__syncthreads_count);
// pixels outside the image start done.  The backward starts at the tile's
// largest `last`, since pairs behind it have zero gradient, and a warp
// skips the pairs behind its own largest.  Each backward thread holds 4
// pixels of one column of the tile, so the dx terms of power are formed
// once per pair for all four, and their skip tests run without branches
// (their exp chains overlap) before the live pixels' rows.  A pair belongs
// to one (tile, view), so one block owns its row; the sum over the tile's
// pixels is formed in three fixed-order steps: each thread adds its
// pixels' rows in registers, each warp sums its lanes with a
// reduce-scatter of shuffles (skipped when no lane is live) whose lanes
// park one row each in shared memory, and after each batch the block adds
// its warps' sums and writes each row once.  The next batch's records load
// into registers while the current one is walked.  No atomics: two runs
// give bitwise-identical rows.  The channel count C is a template
// parameter, so a 3-channel launch keeps 3 accumulators in registers.
// Every offset into gid, the records and the outputs is size_t: V * P *
// REC passes 2^31 above 2^24 pairs.
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
// pipes bound them on the H100.  The backward's sums over the pixels cost,
// per (block, pair) at C = 3 (10 rows), with a live lane in every warp:
//   one pixel per thread and a butterfly per row (before): 32 px tiles,
//     32 warps x 50 shuffles = 1,600 shuffles and 320 single-lane shared
//     stores, then 32 shared loads per (pair, row); 16 px tiles 400 and
//     80, then 8 loads;
//   4 pixels per thread and a reduce-scatter (now): 32 px tiles, 8 warps x
//     12 shuffles = 96 and 8 shared stores, then 8 loads per (pair, row);
//     16 px tiles 2 x 12 = 24 and 2, then 2 loads.
// What is left is the walk's own instruction stream (the tests, exp and
// the live pixels' two divisions, issued for a warp whenever one of its
// lanes needs them) and the block's two barriers per batch; PERF.md
// section 6 holds the measured times.

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

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, rounded op by op, from the dx
// terms a dx^2 = (ca dx) dx and b dx = cb dx (formed once for pixels that
// share a column).
__device__ __forceinline__ float pair_power_dy(float adx2, float bdx, float cc, float dy) {
  const float quad = __fadd_rn(adx2, __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(bdx, dy));
}

__device__ __forceinline__ float pair_power(float ca, float cb, float cc, float dx,
                                            float dy) {
  return pair_power_dy(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(cb, dx), cc, dy);
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

// The backward's launch shape: BWD_PIX pixels per thread, so a 32 px tile
// runs 256 threads (8 warps) and a 16 px tile 64 (2 warps), and
// BWD_BATCH pairs per shared-memory batch.  Blocks per SM the registers
// must leave room for (launch bounds): 768 threads up to 5 channels, which
// caps a thread at 85 registers; 512, so 128 registers, for the 6- to
// 9-channel state.
constexpr int BWD_PIX = 4;
constexpr int BWD_BATCH = 32;
__host__ __device__ constexpr int bwd_threads(int tile) { return tile * tile / BWD_PIX; }
__host__ __device__ constexpr int bwd_min_blocks(int tile, int c) {
  return (c <= 5 ? 768 : 512) / bwd_threads(tile);
}

// Calls fn(std::integral_constant<int, TILE>{}) for the tiles the backward
// body takes (16 and 32 px); false for any other.
template <typename Fn>
bool with_bwd_tile(int tile, Fn&& fn) {
  switch (tile) {
    case 16: fn(std::integral_constant<int, 16>{}); return true;
    case 32: fn(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

// Sums v[0..K) over the warp's 32 lanes by recursive halving (a
// reduce-scatter): in the round of lane bit OFF each lane keeps one half
// of the values it holds and sends the other half to its partner,
// ceil(K / 2) shuffles, until every lane holds one value.  12 shuffles for
// K = 10 and 16 for K = 16, where a butterfly per value takes 5 K.  The
// lane's sum ends in v[0]: the value reduce_scatter_row names.  The order
// of the adds is fixed by the lane bits, so the sums are deterministic.
template <int K, int OFF = 16, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  if constexpr (OFF > 0) {
    constexpr int H = (K + 1) / 2;
    const bool hi = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float a = v[i];
      const float b = i + H < K ? v[i + H] : 0.0f;  // an odd K pads with 0
      v[i] = (hi ? b : a) + __shfl_xor_sync(FULL_MASK, hi ? a : b, OFF);
    }
    reduce_scatter<H, OFF / 2>(v, lane);
  }
}

// Which of reduce_scatter<K>'s K sums lane `lane` ends with, or -1 for a
// lane left with padding.  Each of 0..K-1 is held by exactly one lane.
template <int K>
__device__ __forceinline__ int reduce_scatter_row(int lane) {
  int k = K, real = K, row = 0;  // values held, of which real, and the first's index
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int h = (k + 1) / 2;
    if (lane & off) {
      row += h;
      real = max(real - h, 0);
    } else {
      real = min(real, h);
    }
    k = h;
  }
  return real == 1 ? row : -1;
}

// The backward's staging, one batch ahead of the walk: value e = t + m * NT
// of a batch of n pairs at [base, base + n) is row e % REC of pair e / REC.
// stage_sources loads each value's record index (kExact: its gid, a batch
// earlier still, so the gather never waits on it); stage_values loads the
// values; stage_store writes them to shared memory, flat in (pair, row).
template <Family F, int REC, int NT, int PER>
__device__ __forceinline__ void stage_sources(int (&src)[PER], const Walk& w, int v, int base,
                                              int n) {
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = static_cast<int>(threadIdx.x) + m * NT;
    const int j = e / REC;
    src[m] = 0;
    if (e < n * REC)
      src[m] = F == Family::kExact ? w.gid[static_cast<size_t>(v) * w.P + base + j] : base + j;
  }
}

template <Family F, int REC, int NT, int PER>
__device__ __forceinline__ void stage_values(float (&val)[PER], const int (&src)[PER],
                                             const Walk& w, int v, int n, float ox, float oy) {
  const size_t rows = F == Family::kExact ? w.N : w.P;
  const float* rec_v = w.rec + static_cast<size_t>(v) * rows * REC;
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = static_cast<int>(threadIdx.x) + m * NT;
    const int r = e % REC;
    if (e < n * REC) {
      const float x = rec_v[static_cast<size_t>(src[m]) * REC + r];
      val[m] = r == 0 ? x - ox : (r == 1 ? x - oy : x);
    }
  }
}

template <int REC, int NT, int PER, int BATCH>
__device__ __forceinline__ void stage_store(float (&s)[BATCH][REC], const float (&val)[PER],
                                            int n) {
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = static_cast<int>(threadIdx.x) + m * NT;
    if (e < n * REC) (&s[0][0])[e] = val[m];
  }
}

// Backward composite of block (tile, view), bwd_threads(TILE) threads of
// BWD_PIX pixels each: per pixel, from the forward's `last` back to the
// tile's start,
//   T_excl  rebuilt from the final T by dividing by (1 - alpha) per live pair;
//   suffix  starts at T_final * (g_T + sum_c g_img_c * bg_c) and gathers
//           w * chat of the pairs behind;
//   chat  = g_depth * depth + sum_c g_img_c * colour_c,  w = alpha * T_excl;
//   dalpha = T_excl * chat - suffix / (1 - alpha);
//   dpower = alpha * dalpha where the raw alpha is below 0.99, else 0;
//   rows   [mx, my, ca, cb, cc, opacity, depth, colour...] summed over the
//          tile's pixels, the opacity row as the family says.
// Per pair, a thread adds its pixels' rows in pixel order, the warp sums
// them with reduce_scatter (skipped when no pixel of the warp is live), the
// lane holding each row parks it in shared memory, and after each batch the
// block adds the warps' sums in a fixed order and writes each row once.
template <int C, Family F, int TILE>
__device__ __forceinline__ void composite_bwd_body(const Walk& w, const BwdIn& g) {
  constexpr int REC = REC_GEOM + C;
  constexpr int PIX = BWD_PIX;
  constexpr int BATCH = BWD_BATCH;
  constexpr int NT = bwd_threads(TILE);
  constexpr int NWARPS = NT / 32;
  constexpr int PER = (BATCH * REC + NT - 1) / NT;  // staged values per thread
  __shared__ float s_rec[2][BATCH][REC];             // double-buffered records
  __shared__ float s_part[NWARPS][BATCH][REC];       // the warps' row sums
  __shared__ int s_maxlast;

  const int v = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t vt = static_cast<size_t>(v) * w.num_tiles + blockIdx.x;
  const int seg_lo = w.start[vt];
  const int seg_hi = w.end[vt];
  float* rows_v = g.d_rows + static_cast<size_t>(v) * w.P * REC;

  // This thread's pixels: column tid % TILE of the tile and rows tid / TILE
  // + k ROWS (NT is a multiple of TILE, so they share one column and the dx
  // terms of power), in the family's frame as pixel_of's.  Per pixel: T
  // (walking back to T_excl), the suffix sum S, the cotangents.  Pixels
  // outside the image have last = -1 and never go live.
  constexpr int ROWS = NT / TILE;
  const int x0 = (static_cast<int>(blockIdx.x) % w.tiles_x) * TILE;
  const int y0 = (static_cast<int>(blockIdx.x) / w.tiles_x) * TILE;
  const int px = x0 + tid % TILE;
  const int fx0 = F == Family::kExact ? x0 : 0;
  const int fy0 = F == Family::kExact ? y0 : 0;
  const float ox = static_cast<float>(fx0);
  const float oy = static_cast<float>(fy0);
  const float fx = static_cast<float>(px - fx0);
  const size_t hw = static_cast<size_t>(w.width) * w.height;
  float fy[PIX], T[PIX], S[PIX], gd[PIX], gi[PIX][C];
  int last[PIX];
  int max_last = -1;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int py = y0 + tid / TILE + k * ROWS;
    fy[k] = static_cast<float>(py - fy0);
    last[k] = -1;
    T[k] = S[k] = gd[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) gi[k][c] = 0.0f;
    if (px < w.width && py < w.height) {
      const size_t local = static_cast<size_t>(py) * w.width + px;
      const size_t pix = static_cast<size_t>(v) * hw + local;
      last[k] = g.last[pix];
      T[k] = g.tfinal[pix];
      gd[k] = g.g_depth[pix];
      float gbg = g.g_tf[pix];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gi[k][c] = g.g_img[(static_cast<size_t>(v) * C + c) * hw + local];
        gbg += gi[k][c] * w.bg[c];
      }
      S[k] = T[k] * gbg;
    }
    max_last = max(max_last, last[k]);
  }

  // Pairs behind the tile's largest `last` keep the rows the caller zeroed,
  // and a warp skips those behind its own largest.
  int warp_last = max_last;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    warp_last = max(warp_last, __shfl_xor_sync(FULL_MASK, warp_last, off));
  const int top_pos = min(seg_hi - 1, block_max(max_last, &s_maxlast));
  const int my_row = reduce_scatter_row<REC>(lane);

  // Batch i covers [max(seg_lo, top_i - BATCH + 1), top_i], top_i = top_pos
  // - i BATCH.  `val` holds batch i's records when its iteration starts,
  // `src` batch i + 1's sources.
  int src[PER];
  float val[PER];
  {
    const int base0 = max(seg_lo, top_pos - BATCH + 1);
    stage_sources<F, REC, NT>(src, w, v, base0, top_pos - base0 + 1);
    stage_values<F, REC, NT>(val, src, w, v, top_pos - base0 + 1, ox, oy);
    const int top1 = top_pos - BATCH, base1 = max(seg_lo, top1 - BATCH + 1);
    stage_sources<F, REC, NT>(src, w, v, base1, top1 - base1 + 1);
  }

  int buf = 0;
  for (int top = top_pos; top >= seg_lo; top -= BATCH, buf ^= 1) {
    const int base = max(seg_lo, top - BATCH + 1);
    const int n = top - base + 1;
    // s_rec[buf] was last read two batches ago, before the barrier that
    // ended the previous batch's walk.
    stage_store<REC, NT>(s_rec[buf], val, n);
    __syncthreads();
    {
      const int top1 = top - BATCH, base1 = max(seg_lo, top1 - BATCH + 1);
      stage_values<F, REC, NT>(val, src, w, v, top1 - base1 + 1, ox, oy);
      const int top2 = top1 - BATCH, base2 = max(seg_lo, top2 - BATCH + 1);
      stage_sources<F, REC, NT>(src, w, v, base2, top2 - base2 + 1);
    }

    for (int j = n - 1; j >= 0; --j) {
      const int pos = base + j;
      if (pos > warp_last) {  // no pixel of the warp reaches this pair
        if (my_row >= 0) s_part[warp][j][my_row] = 0.0f;
        continue;
      }
      const float* rec = s_rec[buf][j];
      const float mx = rec[0], my = rec[1], ca = rec[2], cb = rec[3], cc = rec[4];
      const float op = rec[5], dep = rec[6];
      // The forward's tests for every pixel first, without branches, so
      // the pixels' exp chains overlap; then the live pixels' rows.
      const float dx = fx - mx;
      const float adx2 = __fmul_rn(__fmul_rn(ca, dx), dx);
      const float bdx = __fmul_rn(cb, dx);
      float dy[PIX], e[PIX], alpha[PIX];
      bool live[PIX], unclamped[PIX];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        dy[k] = fy[k] - my;
        const float power = pair_power_dy(adx2, bdx, cc, dy[k]);  // the forward's rounding
        e[k] = expf(power);
        const float raw = op * e[k];
        alpha[k] = fminf(ALPHA_MAX, raw);
        unclamped[k] = raw < ALPHA_MAX;
        // The forward's skip tests: power > 0, alpha below 1/255.
        live[k] = pos <= last[k] && !(power > 0.0f) && alpha[k] >= ALPHA_MIN;
        any = any || live[k];
      }
      float acc[REC];
#pragma unroll
      for (int r = 0; r < REC; ++r) acc[r] = 0.0f;
      // With no live pixel in the warp every acc is 0 and so is what the
      // holders park.
      if (__any_sync(FULL_MASK, any)) {
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
          if (!live[k]) continue;
          const float one_m = 1.0f - alpha[k];
          T[k] = T[k] / one_m;  // T before this pair
          float chat = gd[k] * dep;
#pragma unroll
          for (int c = 0; c < C; ++c) chat += gi[k][c] * rec[REC_GEOM + c];
          const float wt = alpha[k] * T[k];
          const float dalpha = T[k] * chat - S[k] / one_m;
          S[k] += wt * chat;
          const float dpower = unclamped[k] ? alpha[k] * dalpha : 0.0f;
          acc[0] += (ca * dx + cb * dy[k]) * dpower;
          acc[1] += (cc * dy[k] + cb * dx) * dpower;
          acc[2] += -0.5f * dx * dx * dpower;
          acc[3] += -dx * dy[k] * dpower;
          acc[4] += -0.5f * dy[k] * dy[k] * dpower;
          if (F == Family::kExact)
            acc[5] += dpower;  // divided by the opacity after the sum
          else
            acc[5] += unclamped[k] ? e[k] * dalpha : 0.0f;
          acc[6] += wt * gd[k];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[REC_GEOM + c] += wt * gi[k][c];
        }
        reduce_scatter<REC>(acc, lane);
      }
      if (my_row >= 0) s_part[warp][j][my_row] = acc[0];
    }
    __syncthreads();

    // Fixed-order sum over the warps, one (pair, row) per thread; adjacent
    // threads write adjacent floats of the (P, REC) rows.
    for (int idx = tid; idx < n * REC; idx += NT) {
      const int j = idx / REC;
      const int r = idx - j * REC;
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < NWARPS; ++k) sum += s_part[k][j][r];
      if (F == Family::kExact && r == 5) {
        const float op = s_rec[buf][j][5];
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
