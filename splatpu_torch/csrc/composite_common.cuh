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
// Design, both bodies.  Blocks per (tile, view); the TPU's sequential
// chunk grid becomes a loop inside the block.  Each thread holds several
// pixels of one column of the tile, so per pair the dx terms of power
// (a dx^2 and b dx) are formed once for all of them, and their power, exp
// and skip tests run without branches, so the pixels' exp chains overlap;
// the live pixels' updates follow in pixel order.  Records are staged
// through double-buffered shared memory in batches of 32 pairs: the next
// batch's values, and for kExact the gid of the batch after it, load into
// registers while the current batch is walked.  No atomics: two launches
// give bitwise-identical outputs.  The channel count C and the tile are
// template parameters, so a 3-channel launch keeps 3 accumulators per pixel
// in registers.  Every offset into gid, the records and the outputs is
// size_t: V * P * REC passes 2^31 above 2^24 pairs.
//
// Forward.  2 pixels per thread in consecutive rows of one column, 8 x 8
// pixels per warp, one block per 8, 16 or 24 px tile, per 16 px square of a
// 32, 48 or 64 px tile (4, 9 or 16 blocks that walk the same segment), or
// per 8 px square of a 40 or 56 px tile (25 or 49 one-warp blocks).  Per
// batch each warp keeps only the pairs whose alpha >= 1/255 ellipse can
// reach its 8 x 8 pixels (lane j tests pair j, one ballot), so a warp walks
// the pairs near it, not the whole tile's.  A thread keeps its pixels' T,
// colour, depth, `last` and done flags in registers and leaves a batch
// once both its pixels are done; the block leaves its loop at the batch's
// one barrier (__syncthreads_count) once every thread is done.  Pixels
// outside the image start done and write nothing.  The staged rows are
// padded to a multiple of 4 floats, so a pair's geometry is one 16-byte
// and one 8-byte shared load, broadcast to the warp.
//
// Backward.  Several pixels per thread (one column, rows ROWS apart): 2 at
// 8 px tiles, 4 at 16, 32 and 48 px, 3 at 24, 5 at 40, 7 at 56 and 8 at 64,
// so a block is whole warps and whole columns.  It starts at the tile's
// largest `last`, since pairs behind it have zero gradient, and a warp
// skips the pairs behind its own largest.
// A pair belongs to one (tile, view), so one block owns its row; the sum
// over the tile's pixels is formed in three fixed-order steps: each thread
// adds its pixels' rows in registers, each warp sums its lanes with a
// reduce-scatter of shuffles (skipped when no lane is live) whose lanes
// park one row each in shared memory, and after each batch the block adds
// its warps' sums and writes each row once.
//
// The forward, the backward and the plain PyTorch versions must see exactly
// the same pairs: the backward starts each pixel at the forward's `last`
// and rebuilds T by division, and `last` is held identical to the plain
// version's.  So power is rounded op by op in the reference's order (no FMA
// contraction): far from an elongated splat's centre the terms are large
// and cancel, and a contracted form moves alpha by ~1e-5.  And the forward
// carries T in float64 and stops where T (1 - alpha) < 1e-4 in float64, as
// the plain version does: a float32 T drifts by up to ~1e-6 relative over a
// pixel's contributions, enough to put a pixel now and then on the other
// side of 1e-4 (at the served 5 x 1280x720 frame one pixel went on at
// T (1 - alpha) = 1.000000047e-4 in float32 where the plain version's
// float64 9.999999862e-5 stopped; PERF.md section 6).  The weights alpha T
// take T rounded to float32.
//
// What bounds them.  Per evaluated (pixel, pair) ~16 FP32 operations and
// one exp forward (~20 backward), per contribution 4 + 2 (C + 1) more
// forward (a division and ~30 + 4C backward); the bytes are one record row
// per pair per block, the per-pixel inputs and the outputs.  So the FP32
// pipes bound them on the H100.  The forward, reckoned from the code, per
// pair a warp walks:
//   one pixel per thread, 1,024-thread blocks at 32 px (before): per
//     pixel 6 shared loads, dx and dy, power (9 ops), exp (~8), alpha (2),
//     two tests that branch and the loop: ~34 instructions; every warp
//     walks the tile's whole segment until its pixels are done;
//   2 pixels per thread (now): per pair 2 shared loads, dx, a dx^2, b dx,
//     the loop and the any-live and all-done tests (~14, shared by the 2
//     pixels), per pixel dy, power (6), exp, alpha and three tests without
//     branches (~20): ~27 per pixel, and a warp walks only the pairs that
//     can reach its 8 x 8 pixels, for ~1.3 instructions per pair and lane
//     spent on the cull test (a log, two square roots, a division).
// The cull took a 4-pixels-per-thread body from 1.55 to 0.93 ms per
// served 5 x 1280x720 launch; 2 pixels per thread in 8 x 8 warps 0.76, and
// the 32 px tile cut into four 16 px blocks, so that none waits at the
// batch barrier for pixels of another square, 0.65 (PERF.md section 6).
// What holds it above its FP32 bound is not measured (the card's machine
// has no ncu): ptxas gives 76 registers and no spill at C = 3; of the
// instructions issued, those of done or culled pixels in a live warp, the
// float64 T (a float32 T ran 7% faster, but moved `last`) and the batch
// barriers are the candidates.
// The backward's sums over the pixels cost, per (block, pair) at C = 3 (10
// rows), with a live lane in every warp:
//   one pixel per thread and a butterfly per row (before): 32 px tiles,
//     32 warps x 50 shuffles = 1,600 shuffles and 320 single-lane shared
//     stores, then 32 shared loads per (pair, row); 16 px tiles 400 and
//     80, then 8 loads;
//   4 pixels per thread and a reduce-scatter (now): 32 px tiles, 8 warps x
//     12 shuffles = 96 and 8 shared stores, then 8 loads per (pair, row);
//     16 px tiles 2 x 12 = 24 and 2, then 2 loads.
// What is left is the walk's own instruction stream (the tests, exp and,
// for the live pixels, the updates, issued for a warp whenever one of its
// lanes needs them) and the block's barriers per batch; PERF.md section 6
// holds the measured times.

#pragma once

#include <cuda_runtime.h>

#include <utility>

namespace splatpu {

constexpr int REC_GEOM = 7;          // mx, my, ca, cb, cc, op, depth
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr double T_EPS = 1e-4;     // against the float64 T, as the plain versions
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
  int N, P, tiles_x, num_tiles, width, height;
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

// The staging of both bodies, one batch ahead of the walk: value e = t + m
// NT of a batch of n pairs at [base, base + n) is row e % REC of pair
// e / REC.  stage_sources loads each value's record index (kExact: its gid,
// a batch earlier still, so the gather never waits on it); stage_values
// loads the values; stage_store writes them to shared memory rows of S
// floats (the backward's S = REC: flat in (pair, row)).
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

template <int REC, int NT, int PER, int BATCH, int S>
__device__ __forceinline__ void stage_store(float (&s)[BATCH][S], const float (&val)[PER],
                                            int n) {
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = static_cast<int>(threadIdx.x) + m * NT;
    if (e >= n * REC) continue;
    if constexpr (S == REC)
      (&s[0][0])[e] = val[m];
    else
      s[e / REC][e % REC] = val[m];
  }
}

// The forward's launch shape.  A block holds a fwd_side(TILE)-px square
// of its tile (a 32 px tile is 4 blocks of 16 px that walk the same
// segment, so each leaves as soon as its own pixels are done; 40 and 56 px
// tiles, which 16 does not divide, take 8 px squares, since their whole
// tile would be 800 or 1,568 threads), each thread
// FWD_PIX pixels in consecutive rows of one column, each warp an 8 x 8
// pixel square (FWD_WARP_W columns by 32 / FWD_WARP_W threads' rows).
// FWD_BATCH pairs per shared-memory batch, one per lane.  Blocks per SM the
// registers must leave room for (launch bounds): 768 threads up to 5
// channels, which caps a thread at 85 registers; 512, so 128 registers,
// for the 6- to 9-channel state.  The staged rows are fwd_stride(REC)
// floats, REC rounded up to a multiple of 4.
constexpr int FWD_BATCH = 32;
constexpr int FWD_PIX = 2;
constexpr int FWD_WARP_W = 8;
__host__ __device__ constexpr int fwd_side(int tile) {
  return tile <= 24 ? tile : tile % 16 == 0 ? 16 : 8;
}
__host__ __device__ constexpr int fwd_blocks_per_tile(int tile) {
  return (tile / fwd_side(tile)) * (tile / fwd_side(tile));
}
__host__ __device__ constexpr int fwd_threads(int tile) {
  return fwd_side(tile) * fwd_side(tile) / FWD_PIX;
}
// Blocks per SM for the launch bounds of a block of `threads` threads:
// 768 threads' worth up to 5 channels, 512 for 6 to 9, and at least one.
__host__ __device__ constexpr int min_blocks(int threads, int c) {
  return (c <= 5 ? 768 : 512) / threads > 1 ? (c <= 5 ? 768 : 512) / threads : 1;
}
__host__ __device__ constexpr int fwd_min_blocks(int tile, int c) {
  return min_blocks(fwd_threads(tile), c);
}
__host__ __device__ constexpr int fwd_stride(int rec) { return (rec + 3) / 4 * 4; }

// The tiles both bodies take: every multiple of 8 up to 64 px.  with_tile
// calls fn(std::integral_constant<int, TILE>{}) for the TILE of the set
// that equals `tile`; false if none does.
using FwdTiles = std::integer_sequence<int, 8, 16, 24, 32, 40, 48, 56, 64>;
using BwdTiles = FwdTiles;
template <int... TILES, typename Fn>
bool with_tile(std::integer_sequence<int, TILES...>, int tile, Fn&& fn) {
  return ((tile == TILES ? (fn(std::integral_constant<int, TILES>{}), true) : false) || ...);
}

// Whether the pair (means mx, my, conic ca cb cc, opacity op) can pass the
// skip tests at some pixel of the box [bx0, bx1] x [by0, by1]; false only
// where it provably cannot.  alpha >= 1/255 needs Q = a dx^2 + 2 b dx dy +
// c dy^2 <= tau = 2 ln(255 op), an ellipse whose bounding box has the half
// widths sqrt(tau c / det) and sqrt(tau a / det); tau is widened to 1.05
// tau + 1, which covers the rounding of the pixels' power wherever the box's
// terms a dx^2 + c dy^2 + 2 |b dx dy| stay below 1e5 (an error below 0.05
// in Q) and det is not cancelled (det > 1e-4 a c).  Any other pair is kept.
__device__ __forceinline__ bool pair_may_pass(float mx, float my, float ca, float cb, float cc,
                                              float op, float bx0, float bx1, float by0,
                                              float by1) {
  const float det = ca * cc - cb * cb;
  if (!(ca > 0.0f && cc > 0.0f && det > 1e-4f * ca * cc)) return true;
  const float tau = fmaxf(2.0f * logf(255.0f * op), 0.0f) * 1.05f + 1.0f;
  const float hx = sqrtf(tau * cc / det);
  const float hy = sqrtf(tau * ca / det);
  if (ca * hx * hx + cc * hy * hy + 2.0f * fabsf(cb) * hx * hy > 1e5f) return true;
  return !(mx + hx < bx0 || mx - hx > bx1 || my + hy < by0 || my - hy > by1);
}

// Forward composite of block (tile square, view), fwd_threads(TILE)
// threads of FWD_PIX pixels each, front to back over the tile's [start,
// end) pairs.  Per batch each warp first keeps the pairs that can reach its
// pixels (lane j tests pair j, pair_may_pass, one ballot); per kept pair a
// thread forms dx, a dx^2 and b dx once, then every pixel's power, alpha
// and skip tests without branches, then, if one of its pixels is live,
// their T tests and updates in pixel order.
template <int C, Family F, int TILE>
__device__ __forceinline__ void composite_fwd_body(const Walk& w, const FwdOut& out) {
  constexpr int REC = REC_GEOM + C;
  constexpr int S = fwd_stride(REC);
  constexpr int PIX = FWD_PIX;
  constexpr int SIDE = fwd_side(TILE);
  constexpr int NT = fwd_threads(TILE);
  constexpr int BATCH = FWD_BATCH;
  constexpr int PER = (BATCH * REC + NT - 1) / NT;  // staged values per thread
  constexpr int WX = FWD_WARP_W;                    // a warp's columns
  constexpr int WY = 32 / WX;                       // and threads' rows
  static_assert(BATCH == 32, "one pair of a batch per lane");
  static_assert(TILE % SIDE == 0 && SIDE % WX == 0 && (SIDE / PIX) % WY == 0,
                "a block is whole warps that tile its square");
  __shared__ __align__(16) float s_rec[2][BATCH][S];  // double-buffered records

  const int v = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = static_cast<int>(blockIdx.x) / fwd_blocks_per_tile(TILE);
  const int square = static_cast<int>(blockIdx.x) % fwd_blocks_per_tile(TILE);
  const size_t vt = static_cast<size_t>(v) * w.num_tiles + tile;
  const int seg_lo = w.start[vt];
  const int seg_hi = w.end[vt];

  // This thread's pixels: column wcol + lane % WX and rows wrow + (lane /
  // WX) PIX + k of the block's square, where the warp's own square starts
  // at (wcol, wrow); in the family's frame, where the records' means are
  // staged minus (ox, oy), pixel k sits at (fx, fy + k) and the warp's
  // pixels in [bx0, bx0 + WX - 1] x [by0, by0 + WY PIX - 1].
  const int x0 = tile % w.tiles_x * TILE;
  const int y0 = tile / w.tiles_x * TILE;
  const int wcol = square % (TILE / SIDE) * SIDE + warp % (SIDE / WX) * WX;
  const int wrow = square / (TILE / SIDE) * SIDE + warp / (SIDE / WX) * WY * PIX;
  const int px = x0 + wcol + lane % WX;
  const int py0 = y0 + wrow + lane / WX * PIX;
  const int fx0 = F == Family::kExact ? x0 : 0;
  const int fy0 = F == Family::kExact ? y0 : 0;
  const float ox = static_cast<float>(fx0);
  const float oy = static_cast<float>(fy0);
  const float fx = static_cast<float>(px - fx0);
  const float fy = static_cast<float>(py0 - fy0);
  const float bx0 = static_cast<float>(x0 + wcol - fx0);
  const float by0 = static_cast<float>(y0 + wrow - fy0);
  const float bx1 = bx0 + static_cast<float>(WX - 1);
  const float by1 = by0 + static_cast<float>(WY * PIX - 1);

  double T[PIX];
  float acc[PIX][C], dep[PIX];
  int last[PIX];
  bool done[PIX];
  bool all_done = true;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    T[k] = 1.0;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;
    dep[k] = 0.0f;
    last[k] = -1;
    done[k] = !(px < w.width && py0 + k < w.height);
    all_done = all_done && done[k];
  }

  // Batch i covers [seg_lo + i BATCH, min(seg_hi, seg_lo + (i + 1) BATCH)).
  // `val` holds batch i's records when its iteration starts, `src` batch
  // i + 1's sources.
  int src[PER];
  float val[PER];
  stage_sources<F, REC, NT>(src, w, v, seg_lo, min(BATCH, seg_hi - seg_lo));
  stage_values<F, REC, NT>(val, src, w, v, min(BATCH, seg_hi - seg_lo), ox, oy);
  stage_sources<F, REC, NT>(src, w, v, seg_lo + BATCH, min(BATCH, seg_hi - seg_lo - BATCH));

  int buf = 0;
  for (int base = seg_lo; base < seg_hi; base += BATCH, buf ^= 1) {
    const int n = min(BATCH, seg_hi - base);
    // s_rec[buf] was last read two batches ago, before the previous
    // batch's barrier.  This barrier publishes the batch and is the
    // block-wide exit.
    stage_store<REC, NT>(s_rec[buf], val, n);
    if (__syncthreads_count(all_done) == NT) break;
    {
      const int base1 = base + BATCH, base2 = base1 + BATCH;
      stage_values<F, REC, NT>(val, src, w, v, min(BATCH, seg_hi - base1), ox, oy);
      stage_sources<F, REC, NT>(src, w, v, base2, min(BATCH, seg_hi - base2));
    }
    if (__all_sync(FULL_MASK, all_done)) continue;
    unsigned kept;
    {
      bool pass = false;
      if (lane < n) {
        const float* rec = s_rec[buf][lane];
        pass = pair_may_pass(rec[0], rec[1], rec[2], rec[3], rec[4], rec[5], bx0, bx1, by0, by1);
      }
      kept = __ballot_sync(FULL_MASK, pass);
    }
    if (all_done) continue;

    while (kept) {  // the kept pairs in order
      const int j = __ffs(kept) - 1;
      kept &= kept - 1;
      const float* rec = s_rec[buf][j];
      const float4 g = *reinterpret_cast<const float4*>(rec);      // mx, my, ca, cb
      const float2 h = *reinterpret_cast<const float2*>(rec + 4);  // cc, op
      const float dx = fx - g.x;
      const float adx2 = __fmul_rn(__fmul_rn(g.z, dx), dx);
      const float bdx = __fmul_rn(g.w, dx);
      float alpha[PIX];
      bool live[PIX];
      bool any = false;
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        const float power = pair_power_dy(adx2, bdx, h.x, (fy + static_cast<float>(k)) - g.y);
        alpha[k] = fminf(ALPHA_MAX, h.y * expf(power));
        live[k] = !done[k] && !(power > 0.0f) && !(alpha[k] < ALPHA_MIN);
        any = any || live[k];
      }
      if (!any) continue;
#pragma unroll
      for (int k = 0; k < PIX; ++k) {
        if (!live[k]) continue;
        const double test_T = T[k] * static_cast<double>(1.0f - alpha[k]);
        if (test_T < T_EPS) {  // the first failing pair stops the pixel
          done[k] = true;
          continue;
        }
        const float wt = alpha[k] * static_cast<float>(T[k]);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[k][c] += wt * rec[REC_GEOM + c];
        dep[k] += wt * rec[6];
        T[k] = test_T;
        last[k] = base + j;
      }
      all_done = true;
#pragma unroll
      for (int k = 0; k < PIX; ++k) all_done = all_done && done[k];
      if (all_done) break;
    }
  }

  const size_t hw = static_cast<size_t>(w.width) * w.height;
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int py = py0 + k;
    if (px >= w.width || py >= w.height) continue;
    const size_t local = static_cast<size_t>(py) * w.width + px;
    const size_t pix = static_cast<size_t>(v) * hw + local;
    const float t = static_cast<float>(T[k]);
#pragma unroll
    for (int c = 0; c < C; ++c)
      out.image[(static_cast<size_t>(v) * C + c) * hw + local] = acc[k][c] + t * w.bg[c];
    out.depth[pix] = dep[k];
    out.tfinal[pix] = t;
    out.last[pix] = last[k];
  }
}

// The backward's launch shape: bwd_pix(tile) pixels of one column per
// thread, so whole warps and whole columns: 4 at 32 px (256 threads, 8
// warps) and 16 px (64, 2 warps), 3 at 24 px (192, 6 warps), 2 at 8 px (32,
// one warp); 5 at 40 px (320, 10 warps), 4 at 48 px (576, 18 warps), 7 at
// 56 px (448, 14 warps), 8 at 64 px (512, 16 warps); and BWD_BATCH pairs
// per shared-memory batch.  Blocks per SM the registers must leave room
// for (launch bounds): 768 threads up to 5 channels, which caps a thread at
// 85 registers; 512, so 128 registers, for the 6- to 9-channel state (24
// px: 384, so 170); and at least one block, so 65,536 registers over a
// 48, 56 or 64 px block's 576, 448 or 512 threads at any channel count.
constexpr int BWD_BATCH = 32;
__host__ __device__ constexpr int bwd_pix(int tile) {
  return tile == 8 ? 2 : tile == 24 ? 3 : tile == 40 ? 5 : tile == 56 ? 7 : tile == 64 ? 8 : 4;
}
__host__ __device__ constexpr int bwd_threads(int tile) { return tile * tile / bwd_pix(tile); }
__host__ __device__ constexpr int bwd_min_blocks(int tile, int c) {
  return min_blocks(bwd_threads(tile), c);
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

// Backward composite of block (tile, view), bwd_threads(TILE) threads of
// bwd_pix(TILE) pixels each: per pixel, from the forward's `last` back to the
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
  constexpr int PIX = bwd_pix(TILE);
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
  // terms of power), in the family's frame as the forward's.  Per pixel: T
  // (walking back to T_excl), the suffix sum S, the cotangents.  Pixels
  // outside the image have last = -1 and never go live.
  constexpr int ROWS = NT / TILE;
  static_assert(NT % 32 == 0 && NT % TILE == 0 && ROWS * PIX == TILE, "whole warps, whole columns");
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
