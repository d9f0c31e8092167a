// The intra wavefront of one picture in one launch: every step of the
// host's [S, K, D] batches, in order, each reconstructing up to K units
// that do not read each other's output.
//
// Replaces vvdec_tpu/ops/intra_device.py::_intra_wavefront_fn (:823), a
// jax.jit program a picture: a lax.scan over the steps (:935), a
// lax.switch on the step's mode class (:905) and a lax.fori_loop over the
// K masked block writes (:933).  It has no pallas_call; the port ran it as
// a Python loop of about 300 eager PyTorch ops a step.  Per step and unit
// (descriptor row d, layout in ops/intra_device.py):
//   gather:   the top / left reference runs (RL samples from 2-row and
//             2-column windows with clamped starts; an index the clamp
//             pushes out of the window reads 0; 1 << (bd-1) when no
//             reference is available), [1 2 1]-smoothed where d[8];
//   predict:  by the step's mode class d[7] of row 0: planar, DC,
//             angular (cubic / gauss / chroma 2-tap filters, the side
//             projection, both PDPC forms, the transpose of horizontal
//             modes), MIP (Haar downsample, the int32 matrix product,
//             transpose, linear upsampling), CCLM (template sampling off
//             the luma plane, the min/max fit, the division table) or
//             CIIP (planar blended with the inter prediction in the
//             plane); PDPC of planar / DC / CIIP where d[27];
//   residual: the LMCS chroma residual scale where d[29] & 1 (the
//             average of the luma left of and above the unit's VPDU),
//             added where d[9], clipped to [0, 2^bd - 1];
//   write:    the unit's h x w corner of its 64 x 64 window (start
//             clamped as lax.dynamic_update_slice clamps it) of the
//             stacked [3, hh, ww] int32 planes, where d[28].
// Integer semantics follow the plain version (ops/cuda/intra.py
// intra_wavefront_ref): floor shifts, clamps as min(max(v, lo), hi).
//
// What bounds it on an H100: not the bytes (a 1080p intra frame moves
// tens of megabytes at most, microseconds at 3.35 TB/s) but the chain of
// steps: each step reads what the one before wrote, so the steps run one
// after another, and a step's time is the latency of its dependent global
// reads (references, luma, residuals), its barriers and its writes.
//
// Design (simple and right first; speed is later work):
// - One thread block walks all S steps (the scan becomes a loop inside
//   the block, so no launch, host round trip or grid barrier per step).
// - Reads before writes: every read of a step (references, CCLM's luma,
//   the LMCS scale's luma, CIIP's inter prediction) happens before any
//   write of that step, as in the plain version, whose one index_put_
//   follows all its reads.  Each step: load the K rows; gather the raw
//   references; smooth; per-unit set-up by one warp a unit (DC sum, MIP
//   boundary and matrix product, CCLM parameters, LMCS scale); every
//   output sample of the step's units into shared memory (uint16,
//   K x 64 x 64 at most, only the h x w corners are computed); barrier;
//   the writes; barrier.
// - Where two units of a step overlap (never in a conformant picture),
//   the later row wins, as the reference's fori_loop writes in row order.
// - The constant tables (ops/cuda/intra.py intra_consts: the cubic and
//   gauss filters, MIP_4x4 / 8x8 / 16x16, the CCLM division table) are
//   copied into shared memory once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kB = 64;                     // compute tile side (B)
constexpr int kRL = 132;                   // reference run length (RL)
constexpr int kD = 33;                     // descriptor row width (D)
constexpr int kHOff = 64;                  // refext negative extent
constexpr int kRL2 = kHOff + 128 + kB + 4; // refext length
constexpr int kNext = 128 + kB + 1;        // PDPC side extension length
constexpr int kPB = 64;                    // plane bottom / right padding
constexpr int kMaxK = 8;                   // units a step
constexpr int kThreads = 512;
constexpr int kLmLen = 69;
// the constant pool (ops/cuda/intra.py CONST_TABLES)
constexpr int kCubic = 0;      // [32][4]
constexpr int kGauss = 128;    // [32][4]
constexpr int kMip4 = 256;     // [16][16][4]
constexpr int kMip8 = 1280;    // [8][16][8]
constexpr int kMip16 = 2304;   // [6][64][7]
constexpr int kDiv = 4992;     // [16]
constexpr int kConstLen = 5008;

// CCLM luma downsampling taps by chroma format: 4:2:0 (and 4:0:0), 4:2:2,
// 4:4:4; t3 (first CTU row: coef x3, rnd, shift), t5 (collocated: coef
// x5, rnd, shift), t6 (coef x6, rnd, shift)
__constant__ int kT3[3][5] = {{2, 1, 1, 2, 2}, {2, 1, 1, 2, 2},
                              {1, 0, 0, 0, 0}};
__constant__ int kT5[3][7] = {{1, 4, 1, 1, 1, 4, 3}, {0, 2, 1, 1, 0, 2, 2},
                              {0, 1, 0, 0, 0, 0, 0}};
__constant__ int kT6[3][8] = {{2, 1, 1, 2, 1, 1, 4, 3},
                              {2, 1, 1, 0, 0, 0, 2, 2},
                              {1, 0, 0, 0, 0, 0, 0, 0}};

struct Params {
  int* planes;          // [3, hh, ww], updated in place
  const int* resi;      // [3, hh, ww]
  const int* batches;   // [S, K, kD]
  const int* consts;    // [kConstLen]
  const int* lm;        // [kLmLen] or null without LMCS
  int S, K, hh, ww, bd, cfmt, collocated, ctu_log2, has_lmcs;
};

struct Shared {
  int d[kMaxK][kD];
  int raw_t[kMaxK][kRL];
  int raw_l[kMaxK][kRL];
  int top[kMaxK][kRL];
  int left[kMaxK][kRL];
  int mip[kMaxK][64];     // MIP's 8 x 8 reduced prediction, transposed
  int red[kMaxK][16];     // per-unit partial results of the set-up warp
  int scal[kMaxK][4];     // DC value / CCLM a, b, shift / LMCS scale (3)
  int off[kMaxK + 1];     // first output sample of each unit
  int consts[kConstLen];
  int lm[kLmLen + 3];
  uint16_t out[kMaxK * kB * kB];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// int32 left shift that wraps as the plain version's int32 tensors do
__device__ __forceinline__ int shl(int v, int s) {
  return static_cast<int>(static_cast<unsigned>(v) << s);
}

// the start lax.dynamic_slice uses: a negative start wraps once, then
// the window is clamped into [0, dim)
__device__ __forceinline__ int win_start(int start, int size, int dim) {
  if (start < 0) start += dim;
  return clampi(start, 0, dim - size);
}

// int.bit_length for v > 0, saturating at 17 (the plain _bitlen); 0 for
// v <= 0
__device__ __forceinline__ int bitlen17(int v) {
  return v <= 0 ? 0 : min(32 - __clz(v), 17);
}

// arr[idx] of a reference run, 0 outside it (the one-hot gather's _take)
__device__ __forceinline__ int take(const int* arr, int idx) {
  return (idx >= 0 && idx < kRL) ? arr[idx] : 0;
}

__device__ __forceinline__ bool valid(const Shared& sm, const Params& p,
                                      int k) {
  return k < p.K && sm.d[k][28] == 1;
}

// ---------------------------------------------------------------- refs
// raw reference sample j of unit d (before smoothing): _gather_refs
__device__ void raw_refs(const Params& p, const int* d, int j, int* top,
                         int* left) {
  const int hp = p.hh, wp = p.ww;
  const int* P = p.planes + static_cast<size_t>(clampi(d[0], 0, 2)) * hp * wp;
  const int rt0 = clampi(min(d[11], d[12]), 0, hp - 2);
  const int ct0 = clampi(d[15], 0, wp - kRL);
  const int row = j < d[13] ? rt0 + (d[11] != rt0) : rt0 + (d[12] != rt0);
  const int jt = clampi(d[14] + j, d[15], d[16]) - ct0;
  int t = (jt >= 0 && jt < kRL) ? P[static_cast<size_t>(row) * wp + ct0 + jt]
                                : 0;
  const int rl0 = clampi(d[21], 0, hp - kRL);
  const int cl0 = clampi(min(d[17], d[18]), 0, wp - 2);
  const int col = j < d[19] ? cl0 + (d[17] != cl0) : cl0 + (d[18] != cl0);
  const int jl = clampi(d[20] + j, d[21], d[22]) - rl0;
  int l = (jl >= 0 && jl < kRL)
              ? P[static_cast<size_t>(rl0 + jl) * wp + col] : 0;
  if (d[10] == 1) t = l = 1 << (p.bd - 1);
  *top = t;
  *left = l;
}

// ------------------------------------------------------- planar and DC
__device__ int pred_planar(const int* d, const int* T, const int* L, int y,
                           int x) {
  const int w = d[3], h = d[4], l2w = d[5], l2h = d[6];
  const int topv = T[1 + x], leftv = L[1 + y];
  const int tr = T[clampi(w + 1, 0, kRL - 1)];
  const int bl = L[clampi(h + 1, 0, kRL - 1)];
  const int hor = shl(leftv, l2w) + (x + 1) * (tr - leftv);
  const int ver = shl(topv, l2h) + (y + 1) * (bl - topv);
  return (shl(hor, l2h) + shl(ver, l2w) + (1 << (l2w + l2h))) >>
         (1 + l2w + l2h);
}

__device__ int pdpc_dc_planar(const int* d, const int* T, const int* L,
                              int pred, int y, int x) {
  const int scale = max((d[5] + d[6] - 2) >> 2, 0);
  const int wt = 32 >> min((2 * y) >> scale, 31);
  const int wl = 32 >> min((2 * x) >> scale, 31);
  return pred + ((wl * (L[1 + y] - pred) + wt * (T[1 + x] - pred) + 32) >> 6);
}

// ------------------------------------------------------------- angular
struct Ang {
  const int* main;
  const int* side;
  int wp, hp, inv;
};

// refext[j]: main[clip(j - H_OFF, 0, 2wp)] for j >= H_OFF, else the
// inverse-angle side projection
__device__ __forceinline__ int refext(const Ang& a, int j) {
  const int m = j - kHOff;
  if (m < 0) {
    return a.side[clampi(min(((-m) * a.inv + 256) >> 9, a.hp), 0, kRL - 1)];
  }
  return take(a.main, min(max(m, 0), 2 * a.wp));
}

// the window of refext starting at st, zero past its end and all zero
// for a start outside it (_shifted_windows)
__device__ __forceinline__ int wnd(const Ang& a, int st, int u) {
  return (st >= 0 && st < kRL2 && st + u < kRL2) ? refext(a, st + u) : 0;
}

__device__ int pred_angular(const Params& p, const int* d, const int* T,
                            const int* L, const int* consts, int y, int x) {
  const int pel_max = (1 << p.bd) - 1;
  const bool is_ver = d[23] == 1;
  const int w = d[3], h = d[4], l2w = d[5], l2h = d[6];
  Ang a;
  a.wp = is_ver ? w : h;
  a.hp = is_ver ? h : w;
  const int l2wp = is_ver ? l2w : l2h, l2hp = is_ver ? l2h : l2w;
  a.main = is_ver ? T : L;
  a.side = is_ver ? L : T;
  a.inv = d[25];
  const int angle = d[24];
  // (r, c) in the main-reference space; horizontal modes transpose
  const int r = is_ver ? y : x, c = is_ver ? x : y;
  const int delta = angle * (r + 1);
  const int frac = delta & 31;
  const int st = kHOff + min(delta >> 5, 2 * a.wp);
  int v;
  switch (clampi(d[26], 0, 3)) {
    case 1: {
      const int* co = consts + kCubic + frac * 4;
      v = clampi((co[0] * wnd(a, st, c) + co[1] * wnd(a, st, c + 1) +
                  co[2] * wnd(a, st, c + 2) + co[3] * wnd(a, st, c + 3) +
                  32) >> 6, 0, pel_max);
      break;
    }
    case 2: {
      const int* co = consts + kGauss + frac * 4;
      v = (co[0] * wnd(a, st, c) + co[1] * wnd(a, st, c + 1) +
           co[2] * wnd(a, st, c + 2) + co[3] * wnd(a, st, c + 3) + 32) >> 6;
      break;
    }
    case 3:
      v = ((32 - frac) * wnd(a, st, c + 1) + frac * wnd(a, st, c + 2) + 16)
          >> 5;
      break;
    default:
      v = wnd(a, st, c + 1);
  }
  if (d[27] != 1) return v;
  if (angle > 0) {
    // positive-angle PDPC: lv = side[min(r + g(c), 2hp)]
    const int scale_a = min(l2hp - (bitlen17(3 * a.inv - 2) - 1 - 8), 2);
    if (scale_a >= 0) {
      const int sa = clampi(scale_a, 0, 31);
      if (c < min(3 << sa, a.wp)) {
        const int gs = clampi(((256 + a.inv * (c + 1)) >> 9) + 1, 0,
                              kNext - kB);
        const int j = gs + r;
        const int lv = (gs < kNext && j < kNext)
            ? take(a.side, clampi(min(j, 2 * a.hp), 0, kRL - 1)) : 0;
        const int wl = 32 >> min((2 * c) >> sa, 31);
        v += (wl * (lv - v) + 32) >> 6;
      }
    }
  } else if (angle == 0) {
    const int scale0 = max((l2wp + l2hp - 2) >> 2, 0);
    if (c < min(3 << scale0, a.wp)) {
      const int wl0 = 32 >> min((2 * c) >> scale0, 31);
      const int mrow = refext(a, kHOff + 1 + c);
      v = clampi((wl0 * (a.side[1 + r] - a.side[0]) + mrow * 64 + 32) >> 6, 0,
                 pel_max);
    }
  }
  return v;
}

// ----------------------------------------------------------------- MIP
// set-up of unit k by its warp: boundary reduction, input vector, the
// matrix product into sm.mip[k] (transposed where d[25])
__device__ void mip_setup(const Params& p, Shared& sm, int k, int lane) {
  const int* d = sm.d[k];
  const int w = d[3], h = d[4], l2w = d[5], l2h = d[6];
  const int sid = d[26], mode = d[24];
  const bool transpose = d[25] == 1;
  const int log2bdry = 2 - (sid == 0);
  const int bdry = 1 << log2bdry;
  if (lane < 8) {
    // lanes 0-3: the top run's group sums, lanes 4-7 the left run's
    const bool is_top = lane < 4;
    const int g = lane & 3;
    const int* ref = is_top ? sm.top[k] : sm.left[k];
    const int side = is_top ? w : h;
    const int lgf = max((is_top ? l2w : l2h) - log2bdry, 0);
    int s = 0;
    for (int i = 0; i < kB; ++i) {
      if ((i >> lgf) == g && i < side) s += ref[1 + i];
    }
    sm.red[k][lane] = lgf > 0 ? (s + (1 << max(lgf - 1, 0))) >> lgf : s;
  }
  sm.mip[k][lane] = 0;
  sm.mip[k][lane + 32] = 0;
  __syncwarp();
  const int* t_red = sm.red[k];
  const int* l_red = sm.red[k] + 4;
  int inp[8];
  for (int i = 0; i < 8; ++i) {
    const bool lo = i < bdry;
    const int i_lo = clampi(i, 0, 3), i_hi = clampi(i - bdry, 0, 3);
    const int bound = lo ? t_red[i_lo] : l_red[i_hi];
    const int bound_t = lo ? l_red[i_lo] : t_red[i_hi];
    inp[i] = transpose ? bound_t : bound;
  }
  const int in_off = inp[0];
  int sum = 0;
  for (int i = 0; i < 8; ++i) {
    int v = i == 0 ? (sid < 2 ? (1 << (p.bd - 1)) - in_off : 0)
                   : inp[i] - in_off;
    inp[i] = i < 2 * bdry ? v : 0;
    sum += inp[i];
  }
  const int offset = 32 - 32 * sum;
  const int pel_max = (1 << p.bd) - 1;
  const int sc = clampi(sid, 0, 2);
  // (matrices, modes - 1, first input, inputs, side n) by size class
  const int base = sc == 0 ? kMip4 : sc == 1 ? kMip8 : kMip16;
  const int top_mode = sc == 0 ? 15 : sc == 1 ? 7 : 5;
  const int col0 = sc == 2 ? 1 : 0;
  const int ni = sc == 0 ? 4 : sc == 1 ? 8 : 7;
  const int n = sc == 2 ? 8 : 4;
  const int np = n * n;
  const int* mat = sm.consts + base + clampi(mode, 0, top_mode) * np * ni;
  for (int q = lane; q < np; q += 32) {
    int acc = 0;
    for (int i = 0; i < ni; ++i) acc += mat[q * ni + i] * inp[col0 + i];
    const int o = clampi(((acc + offset) >> 6) + in_off, 0, pel_max);
    const int a = q / n, b = q % n;
    sm.mip[k][transpose ? b * 8 + a : a * 8 + b] = o;
  }
}

__device__ __forceinline__ int mip_hor(const int* P8, const int* L, int row,
                                       int x, int lg_h, int up_v) {
  const int up_h = 1 << lg_h;
  const int j = x >> lg_h;
  const int* rowp = P8 + clampi(row, 0, 7) * 8;
  const int bh = rowp[clampi(j, 0, 7)];
  const int pv = j == 0 ? L[clampi((row + 1) * up_v, 0, kRL - 1)]
                        : rowp[clampi(j - 1, 0, 7)];
  const int ro_h = lg_h > 0 ? 1 << max(lg_h - 1, 0) : 0;
  return (pv * up_h + ro_h + ((x & (up_h - 1)) + 1) * (bh - pv)) >> lg_h;
}

__device__ int pred_mip(const int* d, const int* T, const int* L,
                        const int* P8, int y, int x) {
  const int log2red = 3 - (d[26] < 2);
  const int lg_h = max(d[5] - log2red, 0), lg_v = max(d[6] - log2red, 0);
  const int up_v = 1 << lg_v;
  const int yv = y >> lg_v;
  const int bh2 = mip_hor(P8, L, clampi(yv, 0, kB - 1), x, lg_h, up_v);
  const int pv2 = yv == 0 ? T[1 + x]
                          : mip_hor(P8, L, clampi(yv - 1, 0, kB - 1), x,
                                    lg_h, up_v);
  const int ro_v = lg_v > 0 ? 1 << max(lg_v - 1, 0) : 0;
  return (pv2 * up_v + ro_v + ((y & (up_v - 1)) + 1) * (bh2 - pv2)) >> lg_v;
}

// ---------------------------------------------------------------- CCLM
struct Cclm {
  const int* luma;
  int hh, ww, lh, lw, sub_w, sub_h, stro, tap;
  bool collocated;
};

__device__ __forceinline__ Cclm cclm_of(const Params& p) {
  Cclm c;
  c.luma = p.planes;
  c.hh = p.hh;
  c.ww = p.ww;
  c.lh = p.hh - kPB;
  c.lw = p.ww - kPB;
  c.sub_w = (p.cfmt == 1 || p.cfmt == 2) ? 2 : 1;
  c.sub_h = p.cfmt == 1 ? 2 : 1;
  c.stro = c.sub_w == 1 ? 0 : 1;
  c.tap = p.cfmt == 2 ? 1 : p.cfmt == 3 ? 2 : 0;
  c.collocated = p.collocated != 0;
  return c;
}

// the luma sample at (r, c): a negative index wraps once at the plane
// less its padding and clamps at its last row / column, then the JAX
// gather's own wrap and clamp at the padded plane
__device__ __forceinline__ int lum(const Cclm& c, int r, int x) {
  r = min(r < 0 ? r + c.lh : r, c.lh - 1);
  r = clampi(r < 0 ? r + c.hh : r, 0, c.hh - 1);
  x = min(x < 0 ? x + c.lw : x, c.lw - 1);
  x = clampi(x < 0 ? x + c.ww : x, 0, c.ww - 1);
  return c.luma[static_cast<size_t>(r) * c.ww + x];
}

__device__ __forceinline__ int taps5(const Cclm& c, int r0, int c0, int r1,
                                     int c1, int r2, int c2, int r3, int c3,
                                     int r4, int c4) {
  const int* t = kT5[c.tap];
  int acc = 0;
  if (t[0]) acc += t[0] * lum(c, r0, c0);
  if (t[1]) acc += t[1] * lum(c, r1, c1);
  if (t[2]) acc += t[2] * lum(c, r2, c2);
  if (t[3]) acc += t[3] * lum(c, r3, c3);
  if (t[4]) acc += t[4] * lum(c, r4, c4);
  return (acc + t[5]) >> t[6];
}

__device__ __forceinline__ int taps6(const Cclm& c, int ra, int rb, int c0,
                                     int c1, int c2) {
  // points (ra, c0), (ra, c1), (ra, c2), (rb, c0), (rb, c1), (rb, c2)
  const int* t = kT6[c.tap];
  int acc = 0;
  if (t[0]) acc += t[0] * lum(c, ra, c0);
  if (t[1]) acc += t[1] * lum(c, ra, c1);
  if (t[2]) acc += t[2] * lum(c, ra, c2);
  if (t[3]) acc += t[3] * lum(c, rb, c0);
  if (t[4]) acc += t[4] * lum(c, rb, c1);
  if (t[5]) acc += t[5] * lum(c, rb, c2);
  return (acc + t[6]) >> t[7];
}

__device__ int cclm_ds_top(const Cclm& c, const Params& p, const int* d,
                           int i) {
  const int lx = d[1] * c.sub_w, ly = d[2] * c.sub_h;
  const int xx = lx + c.sub_w * i;
  const int left_tap = (i == 0 && d[23] != 1) ? xx : xx - 1;
  if ((ly & ((1 << p.ctu_log2) - 1)) == 0) {
    const int* t = kT3[c.tap];
    const int r3 = ly - 1;
    int acc = 0;
    if (t[0]) acc += t[0] * lum(c, r3, xx);
    if (t[1]) acc += t[1] * lum(c, r3, left_tap);
    if (t[2]) acc += t[2] * lum(c, r3, xx + 1);
    return (acc + t[3]) >> t[4];
  }
  const int r = ly - c.sub_h;
  if (c.collocated) {
    return taps5(c, r - c.stro, xx, r, xx, r, left_tap, r, xx + 1,
                 r + c.stro, xx);
  }
  return taps6(c, r, r + c.stro, xx, left_tap, xx + 1);
}

__device__ int cclm_ds_left(const Cclm& c, const int* d, int j) {
  const int lx = d[1] * c.sub_w, ly = d[2] * c.sub_h;
  const int yy = ly + c.sub_h * j;
  const int base = lx - 2 - (c.sub_w - 1);
  if (c.collocated) {
    const int top_tap = (j == 0 && d[27] != 1) ? yy : yy - c.stro;
    return taps5(c, top_tap, base + 1, yy, base + 1, yy, base, yy, base + 2,
                 yy + c.stro, base + 1);
  }
  return taps6(c, yy, yy + c.stro, base + 1, base, base + 2);
}

// set-up of unit k by its warp: the four template points (lanes 0-3 top,
// 4-7 left), then lane 0's min/max fit into sm.scal[k] = (a, b, shift)
__device__ void cclm_setup(const Params& p, Shared& sm, int k, int lane) {
  const int* d = sm.d[k];
  const Cclm c = cclm_of(p);
  const int actual_top = d[24], actual_left = d[25];
  const bool above_avail = (d[26] & 1) == 1, left_avail = (d[26] & 2) == 2;
  const int above_is4 = !left_avail, left_is4 = !above_avail;
  const int start_t = actual_top >> (2 + above_is4);
  const int step_t = max(actual_top >> (1 + above_is4), 1);
  const int start_l = actual_left >> (2 + left_is4);
  const int step_l = max(actual_left >> (1 + left_is4), 1);
  const int cnt_t = above_avail ? min(actual_top, (1 + above_is4) << 1) : 0;
  const int cnt_l = left_avail ? min(actual_left, (1 + left_is4) << 1) : 0;
  if (lane < 8) {
    const int q = lane & 3;
    if (lane < 4) {
      const int pos = start_t + q * step_t;
      sm.red[k][q] = cclm_ds_top(c, p, d, pos);
      sm.red[k][8 + q] = sm.top[k][clampi(1 + pos, 0, kRL - 1)];
    } else {
      const int pos = start_l + max(q - cnt_t, 0) * step_l;
      sm.red[k][4 + q] = cclm_ds_left(c, d, pos);
      sm.red[k][12 + q] = sm.left[k][clampi(1 + pos, 0, kRL - 1)];
    }
  }
  __syncwarp();
  if (lane != 0) return;
  int sl[4], sc[4];
  for (int q = 0; q < 4; ++q) {
    const bool use_t = q < cnt_t;
    const bool use_l = q >= cnt_t && q < cnt_t + cnt_l;
    sl[q] = use_t ? sm.red[k][q] : use_l ? sm.red[k][4 + q] : 0;
    sc[q] = use_t ? sm.red[k][8 + q] : use_l ? sm.red[k][12 + q] : 0;
  }
  if (cnt_t + cnt_l == 2) {
    sl[2] = sl[1];
    sl[3] = sl[0];
    sc[2] = sc[1];
    sc[3] = sc[0];
    const int t0 = sl[0], u0 = sc[0];
    sl[0] = sl[1];
    sc[0] = sc[1];
    sl[1] = t0;
    sc[1] = u0;
  }
  // min group (0, 2), max group (1, 3): xGetLMParameters' network
  int m0l = sl[0], m0c = sc[0], m1l = sl[2], m1c = sc[2];
  int x0l = sl[1], x0c = sc[1], x1l = sl[3], x1c = sc[3];
  int tl, tc;
#define SWAP_IF(cond, al, ac, bl, bc) \
  if (cond) { tl = al; tc = ac; al = bl; ac = bc; bl = tl; bc = tc; }
  SWAP_IF(m0l > m1l, m0l, m0c, m1l, m1c)
  SWAP_IF(x0l > x1l, x0l, x0c, x1l, x1c)
  if (m0l > x1l) {
    SWAP_IF(true, m0l, m0c, x0l, x0c)
    SWAP_IF(true, m1l, m1c, x1l, x1c)
  }
  SWAP_IF(m1l > x0l, m1l, m1c, x0l, x0c)
#undef SWAP_IF
  const int min_l = (m0l + m1l + 1) >> 1, min_c = (m0c + m1c + 1) >> 1;
  const int max_l = (x0l + x1l + 1) >> 1, max_c = (x0c + x1c + 1) >> 1;
  const int diff = max_l - min_l, diff_c = max_c - min_c;
  int xsh = bitlen17(max(diff, 0)) - 1;
  const int norm_diff = ((diff * 16) >> clampi(xsh, 0, 31)) & 15;
  const int v = sm.consts[kDiv + norm_diff] | 8;
  xsh += norm_diff != 0;
  const int ysh = diff_c == 0 ? 0 : bitlen17(abs(diff_c));
  const int ysh_c = clampi(ysh, 0, 31);
  int a = (diff_c * v + (shl(1, ysh_c) >> 1)) >> ysh_c;
  int shift = 3 + xsh - ysh;
  if (shift < 1) a = a == 0 ? 0 : (a < 0 ? -15 : 15);
  shift = max(shift, 1);
  int b = min_c - ((a * min_l) >> shift);
  const bool any = left_avail || above_avail;
  const bool fit = any && diff > 0;
  sm.scal[k][0] = fit ? a : 0;
  sm.scal[k][1] = any ? (diff > 0 ? b : min_c) : 1 << (p.bd - 1);
  sm.scal[k][2] = fit ? shift : 0;
}

__device__ int pred_cclm(const Params& p, const int* d, const int* sc, int y,
                         int x) {
  const Cclm c = cclm_of(p);
  const int yy = d[2] * c.sub_h + c.sub_h * y;
  const int xx = d[1] * c.sub_w + c.sub_w * x;
  const bool no_left = x == 0 && d[23] != 1;
  int ds;
  if (c.collocated) {
    const int left_tap = no_left ? xx : xx - 1;
    const int top_tap = (y == 0 && d[27] != 1) ? yy : yy - c.stro;
    ds = taps5(c, top_tap, xx, yy, xx, yy, left_tap, yy, xx + 1,
               yy + c.stro, xx);
  } else {
    const int lx0 = no_left ? xx : max(xx - 1, 0);
    const int xs1 = min(xx + 1, c.lw - 1);
    ds = taps6(c, yy, yy + c.stro, xx, lx0, xs1);
  }
  return clampi(sc[1] + ((sc[0] * ds) >> sc[2]), 0, (1 << p.bd) - 1);
}

// ---------------------------------------------------------------- LMCS
// the chroma residual scale of unit k by its warp (calculateChromaAdj-
// VpduNei: the luma left of and above the VPDU's top-left CU, its bin's
// entry of the chroma table) into sm.scal[k][3]
__device__ void lmcs_setup(const Params& p, Shared& sm, int k, int lane) {
  const int* d = sm.d[k];
  const int* lm = sm.lm;
  const int num_nb = min(64, 1 << p.ctu_log2);
  const int log_nb = 31 - __clz(num_nb);
  const int xpos = d[30], ypos = d[31];
  const bool left_ok = (d[29] & 2) != 0, above_ok = (d[29] & 4) != 0;
  const int lim_l = clampi(lm[67] - ypos, 1, num_nb);
  const int lim_t = clampi(lm[68] - xpos, 1, num_nb);
  const int r0 = win_start(ypos, num_nb, p.hh);
  const int c0 = win_start(max(xpos - 1, 0), 1, p.ww);
  const int r1 = win_start(max(ypos - 1, 0), 1, p.hh);
  const int c1 = win_start(xpos, num_nb, p.ww);
  int sum_l = 0, sum_t = 0;
  for (int j = lane; j < num_nb; j += 32) {
    const int wl = j < lim_l - 1 ? 1 : j == lim_l - 1 ? num_nb - lim_l + 1 : 0;
    const int wt = j < lim_t - 1 ? 1 : j == lim_t - 1 ? num_nb - lim_t + 1 : 0;
    sum_l += p.planes[static_cast<size_t>(r0 + j) * p.ww + c0] * wl;
    sum_t += p.planes[static_cast<size_t>(r1) * p.ww + c1 + j] * wt;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum_l += __shfl_xor_sync(0xffffffffu, sum_l, o);
    sum_t += __shfl_xor_sync(0xffffffffu, sum_t, o);
  }
  if (lane != 0) return;
  const int rec_sum = (left_ok ? sum_l : 0) + (above_ok ? sum_t : 0);
  const int pelnum = left_ok + above_ok;
  const int luma_val =
      pelnum == 1 ? (rec_sum + (1 << (log_nb - 1))) >> log_nb
      : pelnum == 2 ? (rec_sum + (1 << log_nb)) >> (log_nb + 1)
                    : 1 << (p.bd - 1);
  int idx = lm[65];
  for (int i = 0; i < 16; ++i) {
    idx += (i >= lm[65] && i <= lm[66] && luma_val >= lm[1 + i]);
  }
  idx = min(idx, 15);
  sm.scal[k][3] = (idx >= 0 && idx < 16) ? lm[49 + idx] : 0;
}

__device__ __forceinline__ int scale_signal(int r, int scale, int bd) {
  const int max_abs = (1 << bd) - 1;
  const int rc = clampi(r, -max_abs - 1, max_abs);
  const int sign = rc < 0 ? -1 : 1;
  return clampi(sign * ((sign * rc * scale + (1 << 10)) >> 11), -32768,
                32767);
}

// -------------------------------------------------------------- kernel
__global__ void __launch_bounds__(kThreads)
    intra_wavefront_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pel_max = (1 << p.bd) - 1;
  const size_t plane = static_cast<size_t>(p.hh) * p.ww;
  for (int i = tid; i < kConstLen; i += kThreads) sm.consts[i] = p.consts[i];
  if (p.has_lmcs) {
    for (int i = tid; i < kLmLen; i += kThreads) sm.lm[i] = p.lm[i];
  }
  for (int s = 0; s < p.S; ++s) {
    // the step's rows; padding beyond K reads as invalid
    const int* rows = p.batches + static_cast<size_t>(s) * p.K * kD;
    for (int i = tid; i < kMaxK * kD; i += kThreads) {
      const int k = i / kD;
      sm.d[k][i % kD] = k < p.K ? rows[i] : 0;
    }
    __syncthreads();
    if (tid == 0) {
      int o = 0;
      for (int k = 0; k < kMaxK; ++k) {
        sm.off[k] = o;
        if (valid(sm, p, k)) {
          o += max(min(sm.d[k][4], kB), 0) * max(min(sm.d[k][3], kB), 0);
        }
      }
      sm.off[kMaxK] = o;
    }
    for (int i = tid; i < kMaxK * kRL; i += kThreads) {
      const int k = i / kRL, j = i % kRL;
      if (valid(sm, p, k)) {
        raw_refs(p, sm.d[k], j, &sm.raw_t[k][j], &sm.raw_l[k][j]);
      }
    }
    __syncthreads();
    // [1 2 1] smoothing of the interior, a shared filtered corner
    for (int i = tid; i < kMaxK * kRL; i += kThreads) {
      const int k = i / kRL, j = i % kRL;
      if (!valid(sm, p, k)) continue;
      const int* d = sm.d[k];
      const int* rt = sm.raw_t[k];
      const int* rl = sm.raw_l[k];
      int t = rt[j], l = rl[j];
      if (d[8] == 1) {
        if (j == 0) {
          t = l = (rl[1] + 2 * rt[0] + rt[1] + 2) >> 2;
        } else {
          const int jp = min(j + 1, kRL - 1);
          if (j <= 2 * d[3] - 1) t = (rt[j - 1] + 2 * t + rt[jp] + 2) >> 2;
          if (j <= 2 * d[4] - 1) l = (rl[j - 1] + 2 * l + rl[jp] + 2) >> 2;
        }
      }
      sm.top[k][j] = t;
      sm.left[k][j] = l;
    }
    __syncthreads();
    // the step's mode class is row 0's, as the plain version's
    const int mc = sm.d[0][7];
    if (warp < kMaxK && valid(sm, p, warp)) {
      const int k = warp;
      const int* d = sm.d[k];
      if (mc == 1) {
        const int w = d[3], h = d[4];
        int st = 0, sl = 0;
        for (int i = 1 + lane; i < kRL; i += 32) {
          if (i <= w) st += sm.top[k][i];
          if (i <= h) sl += sm.left[k][i];
        }
        for (int o = 16; o > 0; o >>= 1) {
          st += __shfl_xor_sync(0xffffffffu, st, o);
          sl += __shfl_xor_sync(0xffffffffu, sl, o);
        }
        const int s2 = (w >= h ? st : 0) + (w <= h ? sl : 0);
        const int shift = w == h ? d[5] + 1 : max(d[5], d[6]);
        if (lane == 0) sm.scal[k][0] = (s2 + (1 << max(shift - 1, 0))) >> shift;
      } else if (mc == 3) {
        mip_setup(p, sm, k, lane);
      } else if (mc == 4) {
        cclm_setup(p, sm, k, lane);
      }
      if (p.has_lmcs && (d[29] & 1)) {
        __syncwarp();
        lmcs_setup(p, sm, k, lane);
      }
    }
    __syncthreads();
    // every output sample of the step's units, before any write
    const int total = sm.off[kMaxK];
    for (int t = tid; t < total; t += kThreads) {
      int k = 0;
      while (k + 1 < kMaxK && sm.off[k + 1] <= t) ++k;
      const int* d = sm.d[k];
      const int* T = sm.top[k];
      const int* L = sm.left[k];
      const int w = min(d[3], kB);
      const int y = (t - sm.off[k]) / w, x = (t - sm.off[k]) % w;
      const size_t at = clampi(d[0], 0, 2) * plane +
                        static_cast<size_t>(win_start(d[2], kB, p.hh) + y) *
                            p.ww +
                        win_start(d[1], kB, p.ww) + x;
      int v;
      switch (mc) {
        case 1:
          v = sm.scal[k][0];
          break;
        case 2:
          v = pred_angular(p, d, T, L, sm.consts, y, x);
          break;
        case 3:
          v = pred_mip(d, T, L, sm.mip[k], y, x);
          break;
        case 4:
          v = pred_cclm(p, d, sm.scal[k], y, x);
          break;
        default:
          v = pred_planar(d, T, L, y, x);
      }
      if ((mc == 0 || mc == 1 || mc == 5) && d[27] == 1) {
        v = pdpc_dc_planar(d, T, L, v, y, x);
      }
      if (mc == 5) v = (d[25] * p.planes[at] + d[24] * v + 2) >> 2;
      if (d[9] == 1) {
        int r = p.resi[at];
        if (p.has_lmcs && (d[29] & 1)) r = scale_signal(r, sm.scal[k][3], p.bd);
        v += r;
      }
      sm.out[t] = static_cast<uint16_t>(clampi(v, 0, pel_max));
    }
    __syncthreads();
    // the masked writes; a later row wins where two units overlap
    for (int t = tid; t < total; t += kThreads) {
      int k = 0;
      while (k + 1 < kMaxK && sm.off[k + 1] <= t) ++k;
      const int* d = sm.d[k];
      const int w = min(d[3], kB);
      const int c = clampi(d[0], 0, 2);
      const int yy = win_start(d[2], kB, p.hh) + (t - sm.off[k]) / w;
      const int xx = win_start(d[1], kB, p.ww) + (t - sm.off[k]) % w;
      bool later = false;
      for (int k2 = k + 1; k2 < kMaxK; ++k2) {
        const int* e = sm.d[k2];
        if (!valid(sm, p, k2) || clampi(e[0], 0, 2) != c) continue;
        const int y0 = win_start(e[2], kB, p.hh), x0 = win_start(e[1], kB, p.ww);
        later |= yy >= y0 && yy < y0 + min(e[4], kB) && xx >= x0 &&
                 xx < x0 + min(e[3], kB);
      }
      if (!later) p.planes[c * plane + static_cast<size_t>(yy) * p.ww + xx] =
          sm.out[t];
    }
    __syncthreads();
  }
}

}  // namespace

// One launch over the whole [S, K, kD] batch on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int intra_wavefront_launch(int* planes, const int* resi,
                                      const int* batches, int S, int K,
                                      int hh, int ww, const int* consts,
                                      const int* lm, int bd, int cfmt,
                                      int collocated, int ctu_log2,
                                      int has_lmcs, void* stream) {
  if (K < 1 || K > kMaxK || S < 0 || hh < kRL || ww < kRL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(Shared));
  cudaError_t e = cudaFuncSetAttribute(
      intra_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Params p{planes, resi, batches, consts, lm, S, K, hh, ww,
           bd, cfmt, collocated, ctu_log2, has_lmcs};
  intra_wavefront_kernel<<<1, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
