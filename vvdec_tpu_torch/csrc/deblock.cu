// Dense VVC deblocking of the device filter chain: every vertical edge of
// Y, Cb and Cr in one launch, every horizontal edge in the next.
//
// Replaces the deblock of the reference's filter chain, the jax.jit
// program vvdec_tpu/ops/device_pipeline.py::_chain_fn (:634; the deblock
// at :558-573), whose cores are vvdec_tpu/ops/deblock_dense.py::
// deblock_luma_dense_core (:96) and deblock_chroma_dense_core (:314).
// Those cores evaluate the whole edge-filter decision tree at every
// sample as if an edge sat at its own column, then route the results of
// the true 4-grid (chroma 8-grid) edges to the samples they write by
// constant phase masks; the horizontal direction runs them on transposed
// planes.  The port's plain version (ops/deblock_dense.py, composed by
// ops/cuda/deblock.py::deblock_dense_ref) is the specification, bit for
// bit, quirks included (LoopFilter::xEdgeFilterLuma / xEdgeFilterChroma,
// LoopFilter.cpp:851-1210).
//
// What bounds it on an H100: bytes.  The work is a few hundred int32
// operations for each sample near an edge and a grid read for the rest;
// reading and writing a 832x480 4:2:0 picture's int32 planes once takes
// 4.8 MB, 1.4 us at 3.35 TB/s (two passes, as here: twice that).  The
// plain version's ~1,000 whole-plane PyTorch ops a picture are bound by
// their launches.
//
// Design (a simple kernel that is right):
// - One thread per output sample; blockIdx.y is the component and
//   blockIdx.z the frame (the batched chain stacks its pictures on a
//   leading axis).  Threads run along the row in memory, so loads and the
//   store coalesce in both directions.
// - The kernel reads one buffer and writes another: every vertical edge
//   decides and filters from the pre-deblock plane, every horizontal one
//   from the vertical pass's output, as the plain version does.
// - In the edge's own frame (lines along the edge, positions across it;
//   for the horizontal direction the plane read transposed), a luma
//   sample at position x with phase p = x & 3 may be written by the edges
//   at x - r for r in (p, p + 4, p - 4, p - 8) within the written offsets
//   -7..6, the later one winning where windows overlap (never in a
//   conformant picture; the fuzzed grids of the tests make them).  The
//   thread tries them from the last to the first and takes the first
//   that writes.  A chroma sample has one candidate, r = p or p - 8 on
//   its 8-grid.
// - An edge's decisions read lines 0 and 3 of its 4-line segment (chroma:
//   lines 0 and line3 of its L-line segment); each thread recomputes them
//   from the input, with no shared state, after the cheap exits: no
//   candidate, bS 0 or an inactive cell, an offset the edge's filter
//   lengths cannot reach.
// - Reads across a picture border come from the edge sample (clamped
//   positions), as the plain version's edge-replicated columns.
// - Per-cell parameters come from the packed int16 grids as the host
//   built and uploaded them (ops/deblock_dense.py: luma bs | qp << 2 |
//   max_fl_p << 9 | max_fl_q << 12, chroma bs | qp << 2 | large << 9,
//   15 bits, one grid per direction), a chroma sample taking the luma
//   cell its position maps to; the slice's tc / beta offsets from the
//   [n_sl, 6] table by the slice-index grid; tc, beta and the long
//   filters' weights from the constant pool the wrapper passes
//   (ops/cuda/deblock.py::CONST_TABLES).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the constant pool (ops/cuda/deblock.py CONST_TABLES)
constexpr int kTc = 0;       // _DB_TC [66]
constexpr int kBeta = 66;    // _DB_BETA [64]
constexpr int kDb = 130;     // _DB_DB [3][7]
constexpr int kTcc = 151;    // _DB_TCC [3][7]

struct Plane {
  const int* in;  // [F, H, W]
  int* out;       // [F, H, W]
  int H, W;
  const short* grid;  // [F, 2, h4, w4] luma-cell grid of this component
};

struct Args {
  Plane c[3];
  const short* si;     // [F, h4, w4] slice index, or null (one slice)
  const short* sltab;  // [F, n_sl, 6]
  const int* consts;   // the pool
  int h4, w4, n_sl, bd, ctu, sub_w, sub_h, dir;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The samples of one line of a plane, read across the edge: position
// `pos` of line `line` in the edge's frame, clamped to the plane.
struct Line {
  const int* base;  // the frame's plane
  int step;         // elements between neighbouring positions
  int n;            // positions
  __device__ __forceinline__ int operator()(int pos) const {
    return __ldg(base + (size_t)clampi(pos, 0, n - 1) * step);
  }
};

// One cell's edge parameters, shared by luma and chroma.
struct Cell {
  int g, tc, beta;
};

// The cell (cy, cx) of component comp's grid of frame f.
__device__ __forceinline__ Cell cell_params(const Args& a, const short* grid,
                                            int f, int comp, int cy, int cx) {
  const size_t cells = (size_t)a.h4 * a.w4;
  const int at = cy * a.w4 + cx;
  const int g = __ldg(grid + (2 * (size_t)f + a.dir) * cells + at);
  int s = a.si != nullptr ? __ldg(a.si + f * cells + at) : 0;
  s = (s >= 1 && s < a.n_sl) ? s : 0;
  const short* sl = a.sltab + ((size_t)f * a.n_sl + s) * 6 + 2 * comp;
  const int bs = g & 3, qp = (g >> 2) & 127;
  const int idx_tc = clampi(qp + 2 * (bs - 1) + 2 * __ldg(sl), 0, 65);
  const int idx_b = clampi(qp + 2 * __ldg(sl + 1), 0, 63);
  const int t = __ldg(a.consts + kTc + idx_tc);
  Cell c;
  c.g = g;
  c.tc = a.bd >= 10 ? t << (a.bd - 10)
                    : (t + (1 << (9 - a.bd))) >> (10 - a.bd);
  c.beta = __ldg(a.consts + kBeta + idx_b) << (a.bd - 8);
  return c;
}

// ---------------------------------------------------------------- luma

struct LumaEdge {
  int tc, beta, mfp, mfq, n_p, n_q;
  bool sp_l, sq_l;
};

struct LumaLine {
  int dp, dq, dl;
  bool usl, uss;
};

// One decision line of a luma edge at position e: its side activities,
// the long filters' activity dl and the two strong-filter conditions.
__device__ __forceinline__ LumaLine luma_line(const LumaEdge& E,
                                              const Line& L, int e) {
  auto A = [&](int k) { return L(e + k); };
  LumaLine r;
  r.dp = abs(A(-3) - 2 * A(-2) + A(-1));
  r.dq = abs(A(0) - 2 * A(1) + A(2));
  const int dpx = abs(A(-6) - 2 * A(-5) + A(-4));
  const int dqx = abs(A(3) - 2 * A(4) + A(5));
  r.dl = (E.sp_l ? (r.dp + dpx + 1) >> 1 : r.dp) +
         (E.sq_l ? (r.dq + dqx + 1) >> 1 : r.dq);
  const int m3 = A(-1), m4 = A(0);
  const int absm34 = abs(m3 - m4);
  const int tc5 = (E.tc * 5 + 1) >> 1;
  const int sp3 = abs(A(-4) - m3);
  const int sq3 = abs(A(3) - m4);
  const int mp4 = E.mfp == 7 ? A(-8) : A(-6);
  const int m11 = E.mfq == 7 ? A(7) : A(5);
  int sp3l = E.mfp == 7 ? sp3 + abs(A(-5) - A(-6) - A(-7) + mp4) : sp3;
  sp3l = (sp3l + abs(A(-4) - mp4) + 1) >> 1;
  const int sp3f = E.sp_l ? sp3l : sp3;
  int sq3l = E.mfq == 7 ? sq3 + abs(A(4) - A(5) - A(6) + m11) : sq3;
  sq3l = (sq3l + abs(m11 - A(3)) + 1) >> 1;
  const int sq3f = E.sq_l ? sq3l : sq3;
  const int d2 = 2 * r.dl;
  r.usl = (d2 < (E.beta >> 2)) && (absm34 < tc5) &&
          ((sp3f + sq3f) < ((E.beta * 3) >> 5)) && (d2 < (E.beta >> 4));
  r.uss = (2 * (r.dp + r.dq) < (E.beta >> 2)) && (absm34 < tc5) &&
          ((sp3 + sq3) < (E.beta >> 3));
  return r;
}

__device__ __forceinline__ int c3(int v, int ref, int t) {
  return max(ref - t, min(ref + t, v));
}

// Whether the luma edge at position e writes the sample at offset k
// (-7..6) of line `line`; if so its value in *out.
__device__ bool luma_edge(const Args& a, const short* grid, int f,
                          const Line& L0, const Line& L3, const Line& L,
                          int line, int e, int k, int* out) {
  const int row = a.dir ? e : line, col = a.dir ? line : e;
  const Cell c = cell_params(a, grid, f, 0, row >> 2, col >> 2);
  const int bs = c.g & 3;
  if (bs == 0 || (c.beta == 0 && c.tc == 0)) return false;
  LumaEdge E;
  E.tc = c.tc;
  E.beta = c.beta;
  E.mfp = (c.g >> 9) & 7;
  E.mfq = (c.g >> 12) & 7;
  // dir 1: the P side is never "large" on a CTU row
  E.sp_l = E.mfp > 3 && !(a.dir && e % a.ctu == 0);
  E.sq_l = E.mfq > 3;
  E.n_p = E.sp_l ? E.mfp : 3;
  E.n_q = E.sq_l ? E.mfq : 3;
  // offsets past the short filters: only the long filter reaches them
  if (k < -3 && E.n_p <= -1 - k) return false;
  if (k > 2 && E.n_q <= k) return false;

  const LumaLine s0 = luma_line(E, L0, e), s3 = luma_line(E, L3, e);
  const bool sw_l = (E.sp_l || E.sq_l) && (s0.dl + s3.dl < E.beta) &&
                    s0.usl && s3.usl;
  auto A = [&](int kk) { return L(e + kk); };
  const int tc = E.tc;
  if (sw_l) {
    const bool is_p = k < 0;
    const int pos = is_p ? -1 - k : k;
    if ((is_p ? E.n_p : E.n_q) <= pos) return false;
    const int np_cls = clampi((E.n_p - 3) >> 1, 0, 2);
    const int nq_cls = clampi((E.n_q - 3) >> 1, 0, 2);
    int Pv[7], Qv[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      Pv[j] = A(-1 - j);
      Qv[j] = A(j);
    }
    const int ref_p = np_cls == 0   ? (A(-3) + A(-4) + 1) >> 1
                      : np_cls == 1 ? (A(-5) + A(-6) + 1) >> 1
                                    : (A(-7) + A(-8) + 1) >> 1;
    const int ref_q = nq_cls == 0   ? (A(2) + A(3) + 1) >> 1
                      : nq_cls == 1 ? (A(4) + A(5) + 1) >> 1
                                    : (A(6) + A(7) + 1) >> 1;
    const int n_l = max(E.n_p, E.n_q), n_s = min(E.n_p, E.n_q);
    int ref_m;
    if (E.n_p == E.n_q && E.n_p == 5) {
      ref_m = (2 * (Pv[0] + Qv[0] + Pv[1] + Qv[1] + Pv[2] + Qv[2]) + Pv[3] +
               Qv[3] + Pv[4] + Qv[4] + 8) >> 4;
    } else if (E.n_p == E.n_q) {
      ref_m = (2 * (Pv[0] + Qv[0]) + Pv[1] + Qv[1] + Pv[2] + Qv[2] + Pv[3] +
               Qv[3] + Pv[4] + Qv[4] + Pv[5] + Qv[5] + Pv[6] + Qv[6] + 8) >>
              4;
    } else if (n_l == 7 && n_s == 5) {
      ref_m = (2 * (Pv[0] + Qv[0] + Pv[1] + Qv[1]) + Pv[2] + Qv[2] + Pv[3] +
               Qv[3] + Pv[4] + Qv[4] + Pv[5] + Qv[5] + 8) >> 4;
    } else if (n_l == 7 && n_s == 3) {
      const bool swapq = E.n_q > E.n_p;
      int pl[7], ql[3];
#pragma unroll
      for (int j = 0; j < 7; ++j) pl[j] = swapq ? Qv[j] : Pv[j];
#pragma unroll
      for (int j = 0; j < 3; ++j) ql[j] = swapq ? Pv[j] : Qv[j];
      ref_m = (2 * (pl[0] + ql[0]) + ql[0] + 2 * (ql[1] + ql[2]) + pl[1] +
               ql[1] + pl[2] + pl[3] + pl[4] + pl[5] + pl[6] + 8) >> 4;
    } else {
      ref_m = (Pv[0] + Qv[0] + Pv[1] + Qv[1] + Pv[2] + Qv[2] + Pv[3] + Qv[3] +
               4) >> 3;
    }
    const int cls = is_p ? np_cls : nq_cls;
    const int refs = is_p ? ref_p : ref_q;
    const int db = __ldg(a.consts + kDb + cls * 7 + pos);
    const int tcc = __ldg(a.consts + kTcc + cls * 7 + pos);
    const int cv = (tc * tcc) >> 1;
    const int val = (ref_m * db + refs * (64 - db) + 32) >> 6;
    const int v = A(k);
    *out = max(v - cv, min(v + cv, val));
    return true;
  }
  if (k < -3 || k > 2) return false;
  // the regular (strong / weak) filter
  const int d = s0.dp + s0.dq + s3.dp + s3.dq;
  if (d >= E.beta) return false;
  const bool sw = E.mfp > 2 && E.mfq > 2 && s0.uss && s3.uss;
  const int m0 = A(-4), m1 = A(-3), m2 = A(-2), m3 = A(-1), m4 = A(0),
            m5 = A(1), m6 = A(2), m7 = A(3);
  if (sw) {
    switch (k) {
      case -3: *out = c3((2 * m0 + 3 * m1 + m2 + m3 + m4 + 4) >> 3, m1, tc);
        break;
      case -2: *out = c3((m1 + m2 + m3 + m4 + 2) >> 2, m2, 2 * tc); break;
      case -1:
        *out = c3((m1 + 2 * m2 + 2 * m3 + 2 * m4 + m5 + 4) >> 3, m3, 3 * tc);
        break;
      case 0:
        *out = c3((m2 + 2 * m3 + 2 * m4 + 2 * m5 + m6 + 4) >> 3, m4, 3 * tc);
        break;
      case 1: *out = c3((m3 + m4 + m5 + m6 + 2) >> 2, m5, 2 * tc); break;
      default:
        *out = c3((m3 + m4 + m5 + 3 * m6 + 2 * m7 + 4) >> 3, m6, tc);
    }
    return true;
  }
  if (k == -3 || k == 2) return false;
  const int delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4;
  if (!(abs(delta) < tc * 10)) return false;
  const int pel_max = (1 << a.bd) - 1;
  const int dcl = clampi(delta, -tc, tc);
  const int tc2 = tc >> 1;
  const bool filt_pq = E.mfp > 1 && E.mfq > 1;
  const int side_thresh = (E.beta + (E.beta >> 1)) >> 3;
  switch (k) {
    case -2: {
      if (!(filt_pq && (s0.dp + s3.dp) < side_thresh)) return false;
      const int d1 = clampi((((m1 + m3 + 1) >> 1) - m2 + dcl) >> 1, -tc2,
                            tc2);
      *out = clampi(m2 + d1, 0, pel_max);
      return true;
    }
    case -1: *out = clampi(m3 + dcl, 0, pel_max); return true;
    case 0: *out = clampi(m4 - dcl, 0, pel_max); return true;
    default: {
      if (!(filt_pq && (s0.dq + s3.dq) < side_thresh)) return false;
      const int d2 = clampi((((m6 + m4 + 1) >> 1) - m5 - dcl) >> 1, -tc2,
                            tc2);
      *out = clampi(m5 + d2, 0, pel_max);
      return true;
    }
  }
}

// -------------------------------------------------------------- chroma

struct ChromaLine {
  int d;
  bool cstr;
};

__device__ __forceinline__ ChromaLine chroma_line(const Line& L, int e,
                                                  bool hor_ctb, int tc,
                                                  int beta) {
  auto A = [&](int k) { return L(e + k); };
  const int m0 = A(-4), m1 = A(-3), m2 = A(-2), m3 = A(-1), m4 = A(0),
            m5 = A(1), m6 = A(2), m7 = A(3);
  const int dp = hor_ctb ? abs(m3 - m2) : abs(m1 - 2 * m2 + m3);
  const int dq = abs(m4 - 2 * m5 + m6);
  const int sp3 = hor_ctb ? abs(m2 - m3) : abs(m0 - m3);
  const int sq3 = abs(m7 - m4);
  const int tc5 = (tc * 5 + 1) >> 1;
  ChromaLine r;
  r.d = dp + dq;
  r.cstr = (2 * r.d < (beta >> 2)) && (abs(m3 - m4) < tc5) &&
           ((sp3 + sq3) < (beta >> 3));
  return r;
}

// Whether the chroma edge at position e writes offset k (-3..2) of the
// line; if so its value in *out.
__device__ bool chroma_edge(const Args& a, const short* grid, int f,
                            int comp, const Line& L0, const Line& L3,
                            const Line& L,
                            int line, int e, int k, int* out) {
  if (e < 8) return false;  // the first chroma edge lies at 8
  const int row = a.dir ? e : line, col = a.dir ? line : e;
  const Cell c = cell_params(a, grid, f, comp, row / (4 / a.sub_h),
                             col / (4 / a.sub_w));
  const int bs = c.g & 3;
  const bool lg = ((c.g >> 9) & 1) != 0;
  if (!(bs == 2 || (lg && bs == 1))) return false;
  if (c.tc == 0 && !lg) return false;
  // without the large flag only the weak filter writes, at -1 and 0
  if (!lg && k != -1 && k != 0) return false;
  const int tc = c.tc;
  const bool hor_ctb = a.dir && e % (a.ctu / a.sub_h) == 0;
  const ChromaLine s0 = chroma_line(L0, e, hor_ctb, tc, c.beta);
  const ChromaLine s3 = chroma_line(L3, e, hor_ctb, tc, c.beta);
  const bool sw = lg && (s0.d + s3.d < c.beta) && s0.cstr && s3.cstr;
  auto A = [&](int kk) { return L(e + kk); };
  const int m0 = A(-4), m1 = A(-3), m2 = A(-2), m3 = A(-1), m4 = A(0),
            m5 = A(1), m6 = A(2), m7 = A(3);
  if (sw) {
    if (hor_ctb) {
      // the CTU-row variant reads and writes fewer P samples
      switch (k) {
        case -3: case -2: return false;
        case -1:
          *out = c3((3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3, tc);
          break;
        case 0:
          *out = c3((2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4, tc);
          break;
        case 1:
          *out = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5, tc);
          break;
        default:
          *out = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6, tc);
      }
      return true;
    }
    switch (k) {
      case -3: *out = c3((3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3, m1, tc);
        break;
      case -2:
        *out = c3((2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3, m2, tc);
        break;
      case -1:
        *out = c3((m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3, m3, tc);
        break;
      case 0:
        *out = c3((m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3, m4, tc);
        break;
      case 1:
        *out = c3((m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3, m5, tc);
        break;
      default:
        *out = c3((m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3, m6, tc);
    }
    return true;
  }
  if (k != -1 && k != 0) return false;
  const int pel_max = (1 << a.bd) - 1;
  const int delta = clampi(((m4 - m3) * 4 + m2 - m5 + 4) >> 3, -tc, tc);
  *out = k == -1 ? clampi(m3 + delta, 0, pel_max)
                 : clampi(m4 - delta, 0, pel_max);
  return true;
}

__global__ void __launch_bounds__(kThreads)
deblock_kernel(Args a) {
  const int comp = blockIdx.y, f = blockIdx.z;
  const Plane P = comp == 0 ? a.c[0] : comp == 1 ? a.c[1] : a.c[2];
  const int H = P.H, W = P.W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int y = (int)(i / W), x = (int)(i % W);
  const int* plane = P.in + (size_t)f * H * W;
  // the edge's frame: lines along the edge, positions across it
  const int line = a.dir ? x : y, pos = a.dir ? y : x;
  const int n_pos = a.dir ? H : W;
  auto line_at = [&](int l) {
    Line L;
    L.base = a.dir ? plane + l : plane + (size_t)l * W;
    L.step = a.dir ? W : 1;
    L.n = n_pos;
    return L;
  };
  const Line L = line_at(line);
  int v = 0;
  bool done = false;
  if (comp == 0) {
    const int s0 = line & ~3;
    const Line L0 = line_at(s0), L3 = line_at(s0 + 3);
    const int p = pos & 3;
    // the candidates, the one the plain version routes last first
    const int rs[4] = {p - 8, p - 4, p + 4, p};
#pragma unroll
    for (int j = 0; j < 4 && !done; ++j) {
      const int r = rs[j], e = pos - r;
      if (r < -7 || r > 6 || e < 0 || e >= n_pos) continue;
      done = luma_edge(a, P.grid, f, L0, L3, L, line, e, r, &v);
    }
  } else {
    const int seg = 4 / (a.dir ? a.sub_w : a.sub_h);
    const int s0 = line - line % seg;
    const Line L0 = line_at(s0), L3 = line_at(s0 + (seg == 2 ? 1 : 3));
    const int p = pos & 7;
    const int r = p <= 2 ? p : p - 8;
    const int e = pos - r;
    if (r >= -3 && e < n_pos) {
      done = chroma_edge(a, P.grid, f, comp, L0, L3, L, line, e, r, &v);
    }
  }
  P.out[(size_t)f * H * W + i] = done ? v : __ldg(plane + i);
}

}  // namespace

// planes: host array of 3 x 5 int64, per component {in pointer, out
// pointer, H, W, grid pointer} (absent components: zeros), the planes
// int32 and the grids int16; si: device [F, h4, w4] int16 slice-index
// grid or null; sltab: device [F, n_sl, 6] int16; consts: the device
// int32 pool; dir 0 filters the vertical edges, 1 the
// horizontal ones.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int deblock_launch(const long long* planes, int num_comp, int F,
                              const void* si, const void* sltab,
                              const void* consts, int h4, int w4, int n_sl,
                              int bd, int ctu, int sub_w, int sub_h, int dir,
                              void* stream) {
  if (F <= 0 || num_comp <= 0) return 0;
  Args a;
  long long most = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = planes + 5 * c;
    a.c[c] = {reinterpret_cast<const int*>(d[0]), reinterpret_cast<int*>(d[1]),
              (int)d[2], (int)d[3], reinterpret_cast<const short*>(d[4])};
    if (c < num_comp && d[2] * d[3] > most) most = d[2] * d[3];
  }
  a.si = static_cast<const short*>(si);
  a.sltab = static_cast<const short*>(sltab);
  a.consts = static_cast<const int*>(consts);
  a.h4 = h4;
  a.w4 = w4;
  a.n_sl = n_sl;
  a.bd = bd;
  a.ctu = ctu;
  a.sub_w = sub_w;
  a.sub_h = sub_h;
  a.dir = dir;
  if (most == 0) return 0;
  const dim3 grid((unsigned)((most + kThreads - 1) / kThreads),
                  (unsigned)num_comp, (unsigned)F);
  deblock_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
