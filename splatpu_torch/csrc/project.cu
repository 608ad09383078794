// One projection of every view of a render, forward and backward, for Hopper
// (sm_90a), behind plain C launchers.
//
// Replaces no TPU kernel.  The JAX package's preprocess
// (splatpu/core/projection.py) and its table pack are jnp that XLA fuses
// into a few kernels per view.  PyTorch runs the same arithmetic
// (splatpu_torch/core/projection.py::preprocess) eagerly, one launch per
// operation: ~317 launches a view forward and ~577 in its autograd replay,
// with the table pack's and the opacity mask's.  That made the host, not
// the card, the bound of a training step.  Here it is one launch forward
// and one backward for all V views of a render.
//
// Forward (splatpu_project_fwd).  One thread per Gaussian reads the
// Gaussian once, builds its 3D covariance R diag(s^2) R^T once, then for
// each view 0..V-1 projects it and writes the composite's table row
// (mean2d, conic, visibility-masked opacity, depth, colours), its screen
// radius and its visibility.  The cameras are read from the device: w2c
// (V, 4, 4) and K (V, 3, 3); the FOV size, 1/W and 1/H, the projection's
// near/far entries and the strip's first row are arguments.
//
// Rounding.  The plain path on the card is the spec.  Every float
// operation here is one of that path's PyTorch operations, in its order,
// rounded once (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn:
// nvcc contracts none of them into an FMA).  Three places follow what
// PyTorch's CUDA kernels do rather than the Python text (probed on an H100,
// torch 2.11): a tensor divided by a Python number is a multiply by the
// number's float reciprocal (div_true on a CPU scalar; the host passes 1/W
// and 1/H); the 4x4 matmul P @ w2c rounds each product and adds them in
// order k = 0..3 (6,400 of 6,400 entries); the quaternion's vector_norm
// adds the squares as (q0^2 + q2^2) + (q1^2 + q3^2) (200,000 of 200,000).
//
// Two colour sets (render_dual, stage 1's render).  Given a second colour set
// colors_b (N, C_b), the same launch writes a second table whose rows hold
// the same mean2d, conic, masked opacity and depth with colors_b in place
// of colors; the backward reads both cotangent tables in one launch.  The
// second table's geometry reaches means3d, scales, rotations and
// opacities as the first's does, its colour columns go to colors_b, and
// means2d_offset takes the first table's cotangent only: render_dual's
// lineage cut (mean2d + (off.detach() - off) * wh, the same values) done
// here.  Without colors_b the kernels are the single-table instances
// (template DUAL = false): the same work and the same output.
//
// Backward (splatpu_project_bwd).  One thread per Gaussian recomputes each
// view's forward values (the same code, so the same values) and applies
// autograd's derivative of each operation of the plain path: the
// torch.where branches (tz == 0, det <= 0), the frustum clamp passing the
// gradient at its bounds inclusive, the quaternion norm's 1e-12 floor, a
// zero opacity gradient for culled splats, nothing through radius or
// visibility.  render/project.py's project_views_bwd_plain has the same
// formulas.  The views are summed in order 0..V-1 in registers: no atomics,
// the same result on every run.  The 3D covariance's gradient is summed
// over the views first and taken back through R(q) and s once.
//
// What bounds it.  The bytes.  Forward: 11 + C floats a Gaussian read,
// V (8 + C) floats and V bytes written; backward: V (7 + C) floats and V
// bytes read with the 11 floats of the Gaussian, 11 + C (+ 2 or 2V) floats
// written.  A second colour set adds C_b floats read and V (7 + C_b)
// written forward, V (7 + C_b) read and C_b written backward.  Each view costs ~150 flops forward and ~400 backward (the
// forward again, then its derivative), so at 5 views the kernels do ~3 and
// ~7 flops a byte, under the card's ~20 (67 TFLOP/s over 3.35 TB/s).  A
// thread writes its table rows whole; a warp's 32 rows are contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, lo, hi) with tensor bounds: NaN first, as PyTorch's kernel.
__device__ __forceinline__ float clamp_t(float x, float lo, float hi) {
  if (isnan(x)) return x;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(x, lo), hi);
}

// torch.clamp(x, min=m) with a Python bound: NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float m) { return isnan(x) ? x : fmaxf(x, m); }

// The per-view constants, as the plain path builds them from w2c and K.
struct Cam {
  float R[3][3];  // w2c's rotation
  float t[3];     // and translation
  float M[4][4];  // P @ w2c
  float fx, fy, limx, limy;
};

__device__ __forceinline__ void load_cam(const float* __restrict__ w2c, const float* __restrict__ K,
                                         int v, float fw, float fh, float inv_w, float inv_h,
                                         float p22, float p23, Cam& c) {
  float W[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) W[i][j] = __ldg(w2c + 16 * v + 4 * i + j);
  const float* k = K + 9 * v;
  const float fx = __ldg(k + 0), cx = __ldg(k + 2), fy = __ldg(k + 4), cy = __ldg(k + 5);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[i][j] = W[i][j];
    c.t[i] = W[i][3];
  }
  // core/projection.py::opengl_projection_matrix; "x / w" is x * (1 / w).
  float P[4][4] = {};
  P[0][0] = mul(mul(2.0f, fx), inv_w);
  P[0][2] = mul(-sub(fw, mul(2.0f, cx)), inv_w);
  P[1][1] = mul(mul(2.0f, fy), inv_h);
  P[1][2] = mul(-sub(fh, mul(2.0f, cy)), inv_h);
  P[2][2] = p22;
  P[2][3] = p23;
  P[3][2] = 1.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = mul(P[r][0], W[0][j]);
#pragma unroll
      for (int kk = 1; kk < 4; ++kk) acc = add(acc, mul(P[r][kk], W[kk][j]));
      c.M[r][j] = acc;
    }
  c.fx = fx;
  c.fy = fy;
  // Camera.tan_fovx (a tensor division) times 1.3.
  c.limx = mul(dvd(fw, mul(2.0f, fx)), 1.3f);
  c.limy = mul(dvd(fh, mul(2.0f, fy)), 1.3f);
}

// The per-Gaussian quantities every view shares.
struct Gauss {
  float q[4], nrm, nc, qn[4];
  float R[3][3], s[3], RS[3][3], S[3][3];  // rotation, scales, R diag(s), covariance
};

__device__ __forceinline__ void load_gauss(const float* __restrict__ scales,
                                           const float* __restrict__ rots, int n, Gauss& g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) g.q[i] = __ldg(rots + 4 * n + i);
#pragma unroll
  for (int i = 0; i < 3; ++i) g.s[i] = __ldg(scales + 3 * n + i);
  // quat_normalize(q, eps=1e-12): vector_norm, clamp, divide.
  g.nrm = __fsqrt_rn(add(add(mul(g.q[0], g.q[0]), mul(g.q[2], g.q[2])),
                         add(mul(g.q[1], g.q[1]), mul(g.q[3], g.q[3]))));
  g.nc = clamp_min(g.nrm, 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) g.qn[i] = dvd(g.q[i], g.nc);
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  g.R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  g.R[0][1] = mul(2.0f, sub(mul(x, y), mul(r, z)));
  g.R[0][2] = mul(2.0f, add(mul(x, z), mul(r, y)));
  g.R[1][0] = mul(2.0f, add(mul(x, y), mul(r, z)));
  g.R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  g.R[1][2] = mul(2.0f, sub(mul(y, z), mul(r, x)));
  g.R[2][0] = mul(2.0f, sub(mul(x, z), mul(r, y)));
  g.R[2][1] = mul(2.0f, add(mul(y, z), mul(r, x)));
  g.R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) g.RS[i][k] = mul(g.R[i][k], g.s[k]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      g.S[i][j] = add(add(mul(g.RS[i][0], g.RS[j][0]), mul(g.RS[i][1], g.RS[j][1])),
                      mul(g.RS[i][2], g.RS[j][2]));
}

// One view's projection of one Gaussian: preprocess's values, by its names.
struct Proj {
  float p[3];          // p_view
  float ph0, ph1, ph3, pw, mx, my;
  float tzs, u, w, txtz, tytz, tx, ty, iz, iz2;
  float JW[2][3], tmp[2][3];  // tmp[c][k] = sum_l S[k][l] JW[c][l]
  float a, b, c, det, ds, ca, cb, cc;
  bool front, valid;
};

__device__ __forceinline__ float matvec_row(const float m[3], const float* row, float bias) {
  return add(add(add(mul(m[0], row[0]), mul(m[1], row[1])), mul(m[2], row[2])), bias);
}

__device__ __forceinline__ void project(const float m[3], const Gauss& g, const Cam& c, float fw,
                                        float fh, Proj& p) {
#pragma unroll
  for (int r = 0; r < 3; ++r) p.p[r] = matvec_row(m, c.R[r], c.t[r]);
  const float tz = p.p[2];
  p.front = tz > 0.2f;
  p.ph0 = matvec_row(m, c.M[0], c.M[0][3]);
  p.ph1 = matvec_row(m, c.M[1], c.M[1][3]);
  p.ph3 = matvec_row(m, c.M[3], c.M[3][3]);
  p.pw = dvd(1.0f, add(p.ph3, 1e-7f));
  p.mx = mul(sub(mul(add(mul(p.ph0, p.pw), 1.0f), fw), 1.0f), 0.5f);
  p.my = mul(sub(mul(add(mul(p.ph1, p.pw), 1.0f), fh), 1.0f), 0.5f);

  p.tzs = tz == 0.0f ? 1e-6f : tz;
  p.u = dvd(p.p[0], p.tzs);
  p.w = dvd(p.p[1], p.tzs);
  p.txtz = clamp_t(p.u, -c.limx, c.limx);
  p.tytz = clamp_t(p.w, -c.limy, c.limy);
  p.tx = mul(p.txtz, p.tzs);
  p.ty = mul(p.tytz, p.tzs);
  p.iz = dvd(1.0f, p.tzs);
  p.iz2 = mul(p.iz, p.iz);
  const float J00 = mul(c.fx, p.iz), J02 = mul(mul(-c.fx, p.tx), p.iz2);
  const float J11 = mul(c.fy, p.iz), J12 = mul(mul(-c.fy, p.ty), p.iz2);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    p.JW[0][b] = add(add(mul(J00, c.R[0][b]), mul(0.0f, c.R[1][b])), mul(J02, c.R[2][b]));
    p.JW[1][b] = add(add(mul(0.0f, c.R[0][b]), mul(J11, c.R[1][b])), mul(J12, c.R[2][b]));
  }
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p.tmp[cc][k] = add(add(mul(g.S[k][0], p.JW[cc][0]), mul(g.S[k][1], p.JW[cc][1])),
                         mul(g.S[k][2], p.JW[cc][2]));
  float e[3];  // cov2d entries (0, 0), (0, 1), (1, 1)
  const int rows[3] = {0, 0, 1}, cols[3] = {0, 1, 1};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int r = rows[i], cc = cols[i];
    float acc = add(0.0f, mul(p.JW[r][0], p.tmp[cc][0]));
    acc = add(acc, mul(p.JW[r][1], p.tmp[cc][1]));
    e[i] = add(acc, mul(p.JW[r][2], p.tmp[cc][2]));
  }
  p.a = add(e[0], 0.3f);
  p.b = e[1];
  p.c = add(e[2], 0.3f);
  p.det = sub(mul(p.a, p.c), mul(p.b, p.b));
  p.valid = p.det > 0.0f;
  p.ds = p.valid ? p.det : 1.0f;
  p.ca = dvd(p.c, p.ds);
  p.cb = dvd(-p.b, p.ds);
  p.cc = dvd(p.a, p.ds);
}

// DUAL: colors_b (N, CB) given; table_b (V, N, 7 + CB) written beside table.
template <bool DUAL>
__global__ void __launch_bounds__(THREADS) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const float* __restrict__ opac,
    const float* __restrict__ colors, const float* __restrict__ colors_b,
    const float* __restrict__ offset, const float* __restrict__ w2c,
    const float* __restrict__ K, float* __restrict__ table, float* __restrict__ table_b,
    float* __restrict__ radius, unsigned char* __restrict__ visible, int V, int N, int C,
    int CB, int offset_mode, int row_offset, float fw, float fh, float inv_w, float inv_h,
    float p22, float p23) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int rec = 7 + C;
  Gauss g;
  load_gauss(scales, rots, n, g);
  const float m[3] = {__ldg(means + 3 * n), __ldg(means + 3 * n + 1), __ldg(means + 3 * n + 2)};
  const float op = __ldg(opac + n);
  const float sx = mul(fw, 0.5f), sy = mul(fh, 0.5f);  // offset_pixel_scale
  for (int v = 0; v < V; ++v) {
    Cam c;
    load_cam(w2c, K, v, fw, fh, inv_w, inv_h, p22, p23, c);
    Proj p;
    project(m, g, c, fw, fh, p);
    float mx = p.mx, my = p.my;
    if (offset_mode) {
      const float* o = offset + 2 * (offset_mode == 2 ? static_cast<size_t>(v) * N + n : n);
      mx = add(mx, mul(__ldg(o), sx));
      my = add(my, mul(__ldg(o + 1), sy));
    }
    if (row_offset) my = sub(my, static_cast<float>(row_offset));
    const float mid = mul(0.5f, add(p.a, p.c));
    const float disc = __fsqrt_rn(clamp_min(sub(mul(mid, mid), p.det), 0.1f));
    const float rad = ceilf(mul(3.0f, __fsqrt_rn(add(mid, disc))));
    const bool vis = p.front && p.valid && rad > 0.0f && op > 0.0f;
    const size_t item = static_cast<size_t>(v) * N + n;
    const float head[7] = {mx, my, p.ca, p.cb, p.cc, vis ? op : 0.0f, p.p[2]};
    float* row = table + item * rec;
#pragma unroll
    for (int k = 0; k < 7; ++k) row[k] = head[k];
    for (int ch = 0; ch < C; ++ch) row[7 + ch] = __ldg(colors + static_cast<size_t>(n) * C + ch);
    if (DUAL) {
      float* row_b = table_b + item * (7 + CB);
#pragma unroll
      for (int k = 0; k < 7; ++k) row_b[k] = head[k];
      for (int ch = 0; ch < CB; ++ch)
        row_b[7 + ch] = __ldg(colors_b + static_cast<size_t>(n) * CB + ch);
    }
    radius[item] = vis ? rad : 0.0f;
    visible[item] = vis;
  }
}

// The gradients a null pointer leaves out are not computed.  DUAL: d_table_b
// (V, N, 7 + CB) read beside d_table; its first 7 columns are added to
// d_table's before the geometry's chain (not to the offset's).
template <bool DUAL>
__global__ void __launch_bounds__(THREADS) project_bwd_kernel(
    const float* __restrict__ d_table, const float* __restrict__ d_table_b,
    const float* __restrict__ means, const float* __restrict__ scales,
    const float* __restrict__ rots, const unsigned char* __restrict__ visible,
    const float* __restrict__ w2c, const float* __restrict__ K, float* __restrict__ d_means,
    float* __restrict__ d_scales, float* __restrict__ d_rots, float* __restrict__ d_opac,
    float* __restrict__ d_colors, float* __restrict__ d_colors_b, float* __restrict__ d_offset,
    int V, int N, int C, int CB, int offset_mode, float fw, float fh, float inv_w, float inv_h,
    float p22, float p23) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int rec = 7 + C;
  const bool geo = d_means || d_scales || d_rots;
  Gauss g;
  float m[3] = {0.0f, 0.0f, 0.0f};
  if (geo) {
    load_gauss(scales, rots, n, g);
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = __ldg(means + 3 * n + k);
  }
  float dm[3] = {0.0f, 0.0f, 0.0f};
  float dS[3][3] = {};  // d(cov3d) + its transpose, summed over the views
  float dop = 0.0f, doff[2] = {0.0f, 0.0f};
  const float sx = fw * 0.5f, sy = fh * 0.5f;
  for (int v = 0; v < V; ++v) {
    const size_t item = static_cast<size_t>(v) * N + n;
    const float* gr0 = d_table + item * rec;
    // The geometry's cotangents: the first table's, plus the second's.
    const float* gr = gr0;
    float both[7];
    if (DUAL) {
#pragma unroll
      for (int k = 0; k < 7; ++k) both[k] = gr0[k] + d_table_b[item * (7 + CB) + k];
      gr = both;
    }
    const float gmx = gr[0], gmy = gr[1];
    if (d_opac && visible[item]) dop += gr[5];
    if (d_offset) {
      if (offset_mode == 2) {
        d_offset[2 * item] = gr0[0] * sx;
        d_offset[2 * item + 1] = gr0[1] * sy;
      } else {
        doff[0] += gr0[0] * sx;
        doff[1] += gr0[1] * sy;
      }
    }
    if (!geo) continue;
    Cam c;
    load_cam(w2c, K, v, fw, fh, inv_w, inv_h, p22, p23, c);
    Proj p;
    project(m, g, c, fw, fh, p);
    // mean2d <- ndc <- p_hom rows 0, 1 and (through p_w) 3.
    const float dnx = (gmx * 0.5f) * fw, dny = (gmy * 0.5f) * fh;
    const float dph0 = dnx * p.pw, dph1 = dny * p.pw;
    const float dpw = dnx * p.ph0 + dny * p.ph1;
    const float dph3 = -dpw * (p.pw * p.pw);
#pragma unroll
    for (int k = 0; k < 3; ++k) dm[k] += dph0 * c.M[0][k] + dph1 * c.M[1][k] + dph3 * c.M[3][k];
    // conic <- a, b, c and det.
    const float gca = gr[2], gcb = gr[3], gcc = gr[4];
    float dc = gca / p.ds, db = -(gcb / p.ds), da = gcc / p.ds;
    const float dds = -gca * (p.ca / p.ds) - gcb * (p.cb / p.ds) - gcc * (p.cc / p.ds);
    const float ddet = p.valid ? dds : 0.0f;
    da += ddet * p.c;
    dc += ddet * p.a;
    db += -2.0f * ddet * p.b;
    // cov2d = JW S JW^T: H = G + G^T with G = [[da, db], [0, dc]].  DUAL
    // (stage 1, whose Adam steps each rotation by its own gradient, however
    // small) sums each entry k <= l once and mirrors it: d(cov3d) exactly
    // symmetric, so an isotropic Gaussian's rotation gradient is exactly
    // zero, as autograd's is, and not round-off that Adam would turn into
    // full-rate steps.
    const float h00 = 2.0f * da, h01 = db, h11 = 2.0f * dc;
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        if (DUAL && l < k) continue;
        const float d = h00 * p.JW[0][k] * p.JW[0][l] +
                        h01 * (p.JW[0][k] * p.JW[1][l] + p.JW[1][k] * p.JW[0][l]) +
                        h11 * p.JW[1][k] * p.JW[1][l];
        dS[k][l] += d;
        if (DUAL && l > k) dS[l][k] += d;
      }
    float dJW[2][3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      dJW[0][q] = h00 * p.tmp[0][q] + h01 * p.tmp[1][q];
      dJW[1][q] = h01 * p.tmp[0][q] + h11 * p.tmp[1][q];
    }
    // JW = J Rw: J's entries (0, 0), (0, 2), (1, 1), (1, 2).
    float dJ00 = 0.0f, dJ02 = 0.0f, dJ11 = 0.0f, dJ12 = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      dJ00 += dJW[0][b] * c.R[0][b];
      dJ02 += dJW[0][b] * c.R[2][b];
      dJ11 += dJW[1][b] * c.R[1][b];
      dJ12 += dJW[1][b] * c.R[2][b];
    }
    float diz = dJ00 * c.fx + dJ11 * c.fy;
    const float dtx = dJ02 * p.iz2 * -c.fx, dty = dJ12 * p.iz2 * -c.fy;
    const float diz2 = dJ02 * (-c.fx * p.tx) + dJ12 * (-c.fy * p.ty);
    diz += 2.0f * diz2 * p.iz;
    float dtzs = -diz * (p.iz * p.iz);
    dtzs += dtx * p.txtz + dty * p.tytz;
    // The frustum clamp passes the gradient on [-lim, lim], bounds included.
    const float du = (p.u >= -c.limx && p.u <= c.limx) ? dtx * p.tzs : 0.0f;
    const float dw = (p.w >= -c.limy && p.w <= c.limy) ? dty * p.tzs : 0.0f;
    const float dpx = du / p.tzs, dpy = dw / p.tzs;
    dtzs += -du * (p.u / p.tzs) - dw * (p.w / p.tzs);
    const float dtz = gr[6] + (p.p[2] != 0.0f ? dtzs : 0.0f);
#pragma unroll
    for (int k = 0; k < 3; ++k) dm[k] += dpx * c.R[0][k] + dpy * c.R[1][k] + dtz * c.R[2][k];
  }
  if (d_opac) d_opac[n] = dop;
  if (d_offset && offset_mode == 1) {
    d_offset[2 * n] = doff[0];
    d_offset[2 * n + 1] = doff[1];
  }
  if (d_colors)
    for (int ch = 0; ch < C; ++ch) {
      float acc = 0.0f;
      for (int v = 0; v < V; ++v) acc += d_table[(static_cast<size_t>(v) * N + n) * rec + 7 + ch];
      d_colors[static_cast<size_t>(n) * C + ch] = acc;
    }
  if (DUAL && d_colors_b)
    for (int ch = 0; ch < CB; ++ch) {
      float acc = 0.0f;
      for (int v = 0; v < V; ++v)
        acc += d_table_b[(static_cast<size_t>(v) * N + n) * (7 + CB) + 7 + ch];
      d_colors_b[static_cast<size_t>(n) * CB + ch] = acc;
    }
  if (!geo) return;
  if (d_means)
#pragma unroll
    for (int k = 0; k < 3; ++k) d_means[3 * n + k] = dm[k];
  // cov3d = RS RS^T; RS = R diag(s).
  float dRS[3][3], dR[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dRS[i][k] = dS[i][0] * g.RS[0][k] + dS[i][1] * g.RS[1][k] + dS[i][2] * g.RS[2][k];
      dR[i][k] = dRS[i][k] * g.s[k];
    }
  if (d_scales)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d_scales[3 * n + k] = dRS[0][k] * g.R[0][k] + dRS[1][k] * g.R[1][k] + dRS[2][k] * g.R[2][k];
  if (!d_rots) return;
  const float r = g.qn[0], x = g.qn[1], y = g.qn[2], z = g.qn[3];
  float dq[4];
  dq[0] = 2.0f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] - y * dR[2][0] +
                  x * dR[2][1]);
  dq[1] = 2.0f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] - 2.0f * x * dR[1][1] -
                  r * dR[1][2] + z * dR[2][0] + r * dR[2][1] - 2.0f * x * dR[2][2]);
  dq[2] = 2.0f * (-2.0f * y * dR[0][0] + x * dR[0][1] + r * dR[0][2] + x * dR[1][0] +
                  z * dR[1][2] - r * dR[2][0] + z * dR[2][1] - 2.0f * y * dR[2][2]);
  dq[3] = 2.0f * (-2.0f * z * dR[0][0] - r * dR[0][1] + x * dR[0][2] + r * dR[1][0] -
                  2.0f * z * dR[1][1] + y * dR[1][2] + x * dR[2][0] + y * dR[2][1]);
  // q / max(|q|, 1e-12): the norm's gradient only where the clamp passes it.
  float dnc = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) dnc -= dq[i] * (g.qn[i] / g.nc);
  const float dnorm = g.nrm >= 1e-12f ? dnc / g.nrm : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) d_rots[4 * n + i] = dq[i] / g.nc + g.q[i] * dnorm;
}

}  // namespace

extern "C" {

// The forward: table (V, N, 7 + C), radius (V, N), visible (V, N) bytes, and
// with a second colour set (colors_b (N, C_b), C_b > 0) table_b (V, N,
// 7 + C_b); C_b 0 and null pointers without one.  offset_mode: 0 none, 1
// one (N, 2) offset for every view, 2 (V, N, 2).  Returns
// cudaGetLastError() (0 on success).
int splatpu_project_fwd(const void* means, const void* scales, const void* rots,
                        const void* opac, const void* colors, const void* colors_b,
                        const void* offset, const void* w2c, const void* K, void* table,
                        void* table_b, void* radius, void* visible, int V, int N, int C, int CB,
                        int offset_mode, int fov_w, int fov_h, int row_offset, float inv_w,
                        float inv_h, float p22, float p23, void* stream) {
  if (V < 1 || N < 1 || C < 1 || CB < 0 || offset_mode < 0 || offset_mode > 2 || fov_w < 1 ||
      fov_h < 1 || (offset_mode && !offset) || (CB > 0) != (colors_b != nullptr) ||
      (CB > 0) != (table_b != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + THREADS - 1) / THREADS);
  auto kernel = CB > 0 ? project_fwd_kernel<true> : project_fwd_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(means), static_cast<const float*>(scales),
      static_cast<const float*>(rots), static_cast<const float*>(opac),
      static_cast<const float*>(colors), static_cast<const float*>(colors_b),
      static_cast<const float*>(offset), static_cast<const float*>(w2c),
      static_cast<const float*>(K), static_cast<float*>(table), static_cast<float*>(table_b),
      static_cast<float*>(radius), static_cast<unsigned char*>(visible), V, N, C, CB,
      offset_mode, row_offset, static_cast<float>(fov_w), static_cast<float>(fov_h), inv_w,
      inv_h, p22, p23);
  return static_cast<int>(cudaGetLastError());
}

// The backward of splatpu_project_fwd: d_table (V, N, 7 + C), and d_table_b
// (V, N, 7 + C_b) where the forward had a second colour set (C_b > 0) ->
// the gradients whose pointers are not null (d_colors_b only with C_b > 0).
// Returns cudaGetLastError().
int splatpu_project_bwd(const void* d_table, const void* d_table_b, const void* means,
                        const void* scales, const void* rots, const void* visible,
                        const void* w2c, const void* K, void* d_means, void* d_scales,
                        void* d_rots, void* d_opac, void* d_colors, void* d_colors_b,
                        void* d_offset, int V, int N, int C, int CB, int offset_mode, int fov_w,
                        int fov_h, float inv_w, float inv_h, float p22, float p23,
                        void* stream) {
  if (V < 1 || N < 1 || C < 1 || CB < 0 || offset_mode < 0 || offset_mode > 2 || fov_w < 1 ||
      fov_h < 1 || (d_offset && !offset_mode) || (CB > 0) != (d_table_b != nullptr) ||
      (d_colors_b && CB == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + THREADS - 1) / THREADS);
  auto kernel = CB > 0 ? project_bwd_kernel<true> : project_bwd_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d_table), static_cast<const float*>(d_table_b),
      static_cast<const float*>(means), static_cast<const float*>(scales),
      static_cast<const float*>(rots), static_cast<const unsigned char*>(visible),
      static_cast<const float*>(w2c), static_cast<const float*>(K), static_cast<float*>(d_means),
      static_cast<float*>(d_scales), static_cast<float*>(d_rots), static_cast<float*>(d_opac),
      static_cast<float*>(d_colors), static_cast<float*>(d_colors_b),
      static_cast<float*>(d_offset), V, N, C, CB, offset_mode, static_cast<float>(fov_w),
      static_cast<float>(fov_h), inv_w, inv_h, p22, p23);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
