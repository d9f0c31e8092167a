// The intra wavefront of one picture in one launch of one thread-block
// cluster: one phase a dependency level, the phase's units spread over
// the cluster's blocks, one cluster barrier between phases.
//
// Replaces vvdec_tpu/ops/intra_device.py::_intra_wavefront_fn (:823), a
// jax.jit program a picture: a lax.scan over the host's [S, K, D] steps
// (:935), a lax.switch on the step's mode class (:905) and a
// lax.fori_loop over the K masked block writes (:933).  It has no
// pallas_call.  Per unit (descriptor row d, layout in
// ops/intra_device.py):
//   gather:   the top / left reference runs (RL samples from 2-row and
//             2-column windows with clamped starts; an index the clamp
//             pushes out of the window reads 0; 1 << (bd-1) when no
//             reference is available), [1 2 1]-smoothed where d[8];
//   predict:  by the unit's own mode class d[7]: planar, DC, angular
//             (cubic / gauss / chroma 2-tap filters, the side projection,
//             both PDPC forms, the transpose of horizontal modes), MIP
//             (Haar downsample, the int32 matrix product, transpose,
//             linear upsampling), CCLM (template sampling off the luma
//             plane, the min/max fit, the division table) or CIIP (planar
//             blended with the inter prediction in the plane); PDPC of
//             planar / DC / CIIP where d[27];
//   residual: the LMCS chroma residual scale where d[29] & 1 (the
//             average of the luma left of and above the unit's VPDU),
//             added where d[9], clipped to [0, 2^bd - 1];
//   write:    the unit's h x w corner of its 64 x 64 window (start
//             clamped as lax.dynamic_update_slice clamps it) of the
//             stacked [3, hh, ww] int32 planes.
// Integer semantics follow the plain version (ops/cuda/intra.py
// intra_wavefront_ref): floor shifts, clamps as min(max(v, lo), hi).
//
// What bounds it on an H100: not the bytes (a 1080p intra frame moves a
// few megabytes, microseconds at 3.35 TB/s) but the dependency levels
// times the time one phase takes.  Each level reads what the levels
// before wrote, so the phases run one after another, and a phase costs
// its barriers (the cluster's and a chunk's block barriers: the
// empty-phase floor, about 1.4 us of a 3.5-4.5 us phase, PERF.md) and
// the latency of its dependent reads (references, the set-up's luma,
// each sample's residual), which the design overlaps.
//
// Design:
// - The host (ops/cuda/intra.py wavefront_phases, wavefront_plan) cuts
//   the steps into phases: consecutive steps of one level, split where
//   two units of one component would write the same sample (the later
//   row then starts a phase, so it still wins).  It cuts each unit into
//   slices of whole rows of at most 1024 samples (a plan row holds its
//   rows ys to ye in the pad field d[32]), deals each phase's slices,
//   heaviest first, over the cluster's blocks in snake order, so no
//   block has more than a slice of samples over another, and packs each
//   block's share into chunk records of up to kU rows, in phase order,
//   one after another, each as long as its rows.
//   A slice gathers its unit's references and repeats its set-up.
// - One cluster of 1-16 blocks (cudaLaunchKernelEx with a cluster
//   dimension; above 8 the non-portable size; 16 by default, whose empty
//   phase costs what 8's does, PERF.md).  A block walks its own
//   records; between phases every block passes
//   barrier.cluster.arrive.release / wait.acquire, which orders one
//   phase's global writes before the next phase's reads on every SM of
//   the cluster.  Plane reads bypass L1 (ld.global.cg), so no SM reads a
//   stale line.
// - Inside a phase the kernel rests on the level property: no unit reads
//   a sample another unit of its phase writes (the CPU tests check it on
//   every case and stream).  Each unit reads its references before its
//   own writes; samples are written straight to the planes.  Planes so
//   small that a unit's window is moved off their edge (never the
//   decoder's, padded by 64) void the property: the host then makes each
//   step a phase and launches one block `staged`, every sample of a
//   chunk into shared memory before any write, as the reference's step.
// - The next record is copied into shared memory with cp.async while
//   the current one runs.  Per chunk: references gathered and smoothed
//   in one pass (each thread reads the three raw samples it smooths);
//   per-unit set-up by one warp a unit, in lanes (DC sums and MIP's
//   boundary groups by warp reductions, CCLM's four template points in
//   eight lanes with the luma rows and columns normalised once a sample,
//   the LMCS scale in a second warp); then every sample, each thread
//   finding its row by a branch-free select over the chunk's offsets in
//   its registers.  A block arrives at the cluster barrier, reads its
//   first two samples' residuals (no plane), then waits; CCLM's luma
//   (template and samples) and the LMCS sums are read next, before the
//   references, so the latencies overlap and the set-up reads shared
//   memory only.  The set-up and its barrier are skipped for chunks of
//   planar / angular units.
// - The constant tables (ops/cuda/intra.py intra_consts: the cubic and
//   gauss filters, MIP_4x4 / 8x8 / 16x16, the CCLM division table) are
//   copied into each block's shared memory once.

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
constexpr int kU = 8;                      // rows a chunk record holds
constexpr int kRow = 36;                   // a plan row: d and 3 pad ints
constexpr int kRec = 4 + kU * kRow;        // record: phase, n, 2 pad, rows
constexpr int kHead = 20;                  // plan ints before the records
constexpr int kMaxCluster = 16;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLmLen = 69;
// the constant pool (ops/cuda/intra.py CONST_TABLES)
constexpr int kCubic = 0;      // [32][4]
constexpr int kGauss = 128;    // [32][4]
constexpr int kMip4 = 256;     // [16][16][4]
constexpr int kMip8 = 1280;    // [8][16][8]
constexpr int kMip16 = 2304;   // [6][64][7]
constexpr int kDiv = 4992;     // [16]
constexpr int kConstLen = 5008;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRow % 4 == 0, "records are copied in 16-byte pieces");
static_assert(kRow > kD, "a plan row holds a descriptor row");
static_assert(kHead % 4 == 0 && kHead > kMaxCluster, "plan head");
static_assert(2 * kU <= kWarps, "a set-up warp and an LMCS warp a unit");

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
  const int* plan;      // [kHead] each block's records' offsets, records
  const int* consts;    // [kConstLen]
  const int* lm;        // [kLmLen] or null without LMCS
  int n_phases, hh, ww, bd, cfmt, collocated, ctu_log2, has_lmcs, staged;
};

struct Shared {
  int rec[2][kRec];       // this chunk's record, and the next one in flight
                          // (kRec ints from its start: all of it and more)
  int top[kU][kRL];
  int left[kU][kRL];
  int mip[kU][64];        // MIP's 8 x 8 reduced prediction, transposed
  int scal[kU][4];        // DC value / CCLM a, b, shift / LMCS scale (3)
  int consts[kConstLen];
  int lm[kLmLen + 3];
  // staged launches: then kU x kB x kB uint16 output samples follow
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

// a plane sample another SM may have written before the last cluster
// barrier: read at L2, past this SM's L1
__device__ __forceinline__ int ldp(const int* a) { return __ldcg(a); }

// ------------------------------------------------- cluster and copies
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the cluster barrier, every thread of every block of the cluster: the
// arrival releases this block's writes of the phase, the wait acquires
// every block's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the kRec ints from a record's start (the record, and maybe some of the
// next) into shared memory, 16 bytes a thread, without waiting
__device__ __forceinline__ void copy_record(int* dst, const int* src,
                                            int tid) {
  for (int i = tid; i < kRec / 4; i += kThreads) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src + 4 * i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------- refs
// raw top / left reference sample j of unit d in its plane P (before
// smoothing): _gather_refs
__device__ __forceinline__ int raw_top(const Params& p, const int* d,
                                       const int* P, int j) {
  const int rt0 = clampi(min(d[11], d[12]), 0, p.hh - 2);
  const int ct0 = clampi(d[15], 0, p.ww - kRL);
  const int row = j < d[13] ? rt0 + (d[11] != rt0) : rt0 + (d[12] != rt0);
  const int jt = clampi(d[14] + j, d[15], d[16]) - ct0;
  return (jt >= 0 && jt < kRL)
             ? ldp(P + static_cast<size_t>(row) * p.ww + ct0 + jt) : 0;
}

__device__ __forceinline__ int raw_left(const Params& p, const int* d,
                                        const int* P, int j) {
  const int rl0 = clampi(d[21], 0, p.hh - kRL);
  const int cl0 = clampi(min(d[17], d[18]), 0, p.ww - 2);
  const int col = j < d[19] ? cl0 + (d[17] != cl0) : cl0 + (d[18] != cl0);
  const int jl = clampi(d[20] + j, d[21], d[22]) - rl0;
  return (jl >= 0 && jl < kRL)
             ? ldp(P + static_cast<size_t>(rl0 + jl) * p.ww + col) : 0;
}

// smoothed top and left reference j of unit d: the three raw samples
// the [1 2 1] filter reads (interior only, a shared filtered corner)
__device__ void gather_ref(const Params& p, const int* d, int j, int* top,
                           int* left) {
  if (d[10] == 1) {
    // no reference: a constant, which smoothing leaves as it is
    *top = *left = 1 << (p.bd - 1);
    return;
  }
  const int* P = p.planes +
                 static_cast<size_t>(clampi(d[0], 0, 2)) * p.hh * p.ww;
  int t = raw_top(p, d, P, j), l = raw_left(p, d, P, j);
  if (d[8] == 1) {
    if (j == 0) {
      t = l = (raw_left(p, d, P, 1) + 2 * t + raw_top(p, d, P, 1) + 2) >> 2;
    } else {
      const int jp = min(j + 1, kRL - 1);
      if (j <= 2 * d[3] - 1) {
        t = (raw_top(p, d, P, j - 1) + 2 * t + raw_top(p, d, P, jp) + 2) >> 2;
      }
      if (j <= 2 * d[4] - 1) {
        l = (raw_left(p, d, P, j - 1) + 2 * l + raw_left(p, d, P, jp) + 2) >>
            2;
      }
    }
  }
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

// the DC value of unit k by its warp into sm.scal[k][0]
__device__ void dc_setup(Shared& sm, const int* d, int k, int lane) {
  const int w = d[3], h = d[4];
  int st = 0, sl = 0;
  for (int i = 1 + lane; i < kRL; i += 32) {
    if (i <= w) st += sm.top[k][i];
    if (i <= h) sl += sm.left[k][i];
  }
  st = __reduce_add_sync(kFull, st);
  sl = __reduce_add_sync(kFull, sl);
  const int s2 = (w >= h ? st : 0) + (w <= h ? sl : 0);
  const int shift = w == h ? d[5] + 1 : max(d[5], d[6]);
  if (lane == 0) sm.scal[k][0] = (s2 + (1 << max(shift - 1, 0))) >> shift;
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
// set-up of unit k by its warp: the boundary groups by warp reductions
// (lane i sums top and left samples i and i + 32), the input vector, the
// matrix product into sm.mip[k] (transposed where d[25])
__device__ void mip_setup(const Params& p, Shared& sm, const int* d, int k,
                          int lane) {
  const int w = d[3], h = d[4], l2w = d[5], l2h = d[6];
  const int sid = d[26], mode = d[24];
  const bool transpose = d[25] == 1;
  const int log2bdry = 2 - (sid == 0);
  const int bdry = 1 << log2bdry;
  const int lgf_t = max(l2w - log2bdry, 0), lgf_l = max(l2h - log2bdry, 0);
  const int* T = sm.top[k];
  const int* L = sm.left[k];
  const int i0 = lane, i1 = lane + 32;
  const int t0 = i0 < w ? T[1 + i0] : 0, t1 = i1 < w ? T[1 + i1] : 0;
  const int l0 = i0 < h ? L[1 + i0] : 0, l1 = i1 < h ? L[1 + i1] : 0;
  int t_red[4], l_red[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int st = __reduce_add_sync(
        kFull, ((i0 >> lgf_t) == g ? t0 : 0) + ((i1 >> lgf_t) == g ? t1 : 0));
    const int sl = __reduce_add_sync(
        kFull, ((i0 >> lgf_l) == g ? l0 : 0) + ((i1 >> lgf_l) == g ? l1 : 0));
    t_red[g] = lgf_t > 0 ? (st + (1 << (lgf_t - 1))) >> lgf_t : st;
    l_red[g] = lgf_l > 0 ? (sl + (1 << (lgf_l - 1))) >> lgf_l : sl;
  }
  sm.mip[k][lane] = 0;
  sm.mip[k][lane + 32] = 0;
  __syncwarp();
  int inp[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool lo = i < bdry;
    const int i_lo = clampi(i, 0, 3), i_hi = clampi(i - bdry, 0, 3);
    const int bound = lo ? t_red[i_lo] : l_red[i_hi];
    const int bound_t = lo ? l_red[i_lo] : t_red[i_hi];
    inp[i] = transpose ? bound_t : bound;
  }
  const int in_off = inp[0];
  int sum = 0;
#pragma unroll
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

// the luma row (column) a tap at r (x) reads: a negative index wraps
// once at the plane less its padding and clamps at its last row
// (column), then the JAX gather's own wrap and clamp at the padded
// plane.  Each sample normalises its rows and columns once, not once a
// tap.
__device__ __forceinline__ int nrow(const Cclm& c, int r) {
  r = min(r < 0 ? r + c.lh : r, c.lh - 1);
  return clampi(r < 0 ? r + c.hh : r, 0, c.hh - 1);
}

__device__ __forceinline__ int ncol(const Cclm& c, int x) {
  x = min(x < 0 ? x + c.lw : x, c.lw - 1);
  return clampi(x < 0 ? x + c.ww : x, 0, c.ww - 1);
}

__device__ __forceinline__ int lum(const Cclm& c, int r, int x) {
  return ldp(c.luma + static_cast<size_t>(r) * c.ww + x);
}

// the 5-tap (collocated) cross: points (ra, ca), (rb, ca), (rb, cb),
// (rb, cc), (rc, ca) of normalised rows and columns
__device__ __forceinline__ int taps5(const Cclm& c, int ra, int rb, int rc,
                                     int ca, int cb, int cc) {
  const int* t = kT5[c.tap];
  int acc = 0;
  if (t[0]) acc += t[0] * lum(c, ra, ca);
  if (t[1]) acc += t[1] * lum(c, rb, ca);
  if (t[2]) acc += t[2] * lum(c, rb, cb);
  if (t[3]) acc += t[3] * lum(c, rb, cc);
  if (t[4]) acc += t[4] * lum(c, rc, ca);
  return (acc + t[5]) >> t[6];
}

// the 6-tap window: points (ra, c0), (ra, c1), (ra, c2), (rb, c0),
// (rb, c1), (rb, c2) of normalised rows and columns
__device__ __forceinline__ int taps6(const Cclm& c, int ra, int rb, int c0,
                                     int c1, int c2) {
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
  const int ca = ncol(c, xx), cb = ncol(c, left_tap), cc = ncol(c, xx + 1);
  if ((ly & ((1 << p.ctu_log2) - 1)) == 0) {
    const int* t = kT3[c.tap];
    const int r3 = nrow(c, ly - 1);
    int acc = 0;
    if (t[0]) acc += t[0] * lum(c, r3, ca);
    if (t[1]) acc += t[1] * lum(c, r3, cb);
    if (t[2]) acc += t[2] * lum(c, r3, cc);
    return (acc + t[3]) >> t[4];
  }
  const int r = ly - c.sub_h;
  if (c.collocated) {
    return taps5(c, nrow(c, r - c.stro), nrow(c, r), nrow(c, r + c.stro), ca,
                 cb, cc);
  }
  return taps6(c, nrow(c, r), nrow(c, r + c.stro), ca, cb, cc);
}

__device__ int cclm_ds_left(const Cclm& c, const int* d, int j) {
  const int lx = d[1] * c.sub_w, ly = d[2] * c.sub_h;
  const int yy = ly + c.sub_h * j;
  const int base = lx - 2 - (c.sub_w - 1);
  const int c0 = ncol(c, base + 1), c1 = ncol(c, base), c2 = ncol(c, base + 2);
  if (c.collocated) {
    const int top_tap = (j == 0 && d[27] != 1) ? yy : yy - c.stro;
    return taps5(c, nrow(c, top_tap), nrow(c, yy), nrow(c, yy + c.stro), c0,
                 c1, c2);
  }
  return taps6(c, nrow(c, yy), nrow(c, yy + c.stro), c0, c1, c2);
}

// CCLM's template: where its four top and four left points lie
struct Tmpl {
  int start_t, step_t, start_l, step_l, cnt_t, cnt_l;
  bool above, left;
};

__device__ __forceinline__ Tmpl tmpl_of(const int* d) {
  Tmpl g;
  const int actual_top = d[24], actual_left = d[25];
  g.above = (d[26] & 1) == 1;
  g.left = (d[26] & 2) == 2;
  const int above_is4 = !g.left, left_is4 = !g.above;
  g.start_t = actual_top >> (2 + above_is4);
  g.step_t = max(actual_top >> (1 + above_is4), 1);
  g.start_l = actual_left >> (2 + left_is4);
  g.step_l = max(actual_left >> (1 + left_is4), 1);
  g.cnt_t = g.above ? min(actual_top, (1 + above_is4) << 1) : 0;
  g.cnt_l = g.left ? min(actual_left, (1 + left_is4) << 1) : 0;
  return g;
}

// the template position of lane's point: lanes 0-3 top, 4-7 left
__device__ __forceinline__ int tmpl_pos(const Tmpl& g, int lane) {
  return lane < 4 ? g.start_t + lane * g.step_t
                  : g.start_l + max((lane & 3) - g.cnt_t, 0) * g.step_l;
}

// the downsampled luma of lane's template point (lanes 0-7; 0 beyond),
// read off the luma plane before the set-up
__device__ int cclm_template(const Params& p, const Cclm& c, const int* d,
                             int lane) {
  const Tmpl g = tmpl_of(d);
  if (lane < 4) return cclm_ds_top(c, p, d, tmpl_pos(g, lane));
  if (lane < 8) return cclm_ds_left(c, d, tmpl_pos(g, lane));
  return 0;
}

// set-up of unit k by its warp: the template points' luma lv (from
// cclm_template) and chroma, shuffled to every lane, then lane 0's
// min/max fit into sm.scal[k] = (a, b, shift)
__device__ void cclm_setup(const Params& p, Shared& sm, const int* d, int k,
                           int lane, int lv) {
  const Tmpl g = tmpl_of(d);
  const bool above_avail = g.above, left_avail = g.left;
  const int cnt_t = g.cnt_t, cnt_l = g.cnt_l;
  int cv = 0;
  if (lane < 8) {
    const int* ref = lane < 4 ? sm.top[k] : sm.left[k];
    cv = ref[clampi(1 + tmpl_pos(g, lane), 0, kRL - 1)];
  }
  int sl[4], sc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int lt = __shfl_sync(kFull, lv, q), ct = __shfl_sync(kFull, cv, q);
    const int ll = __shfl_sync(kFull, lv, 4 + q);
    const int cl = __shfl_sync(kFull, cv, 4 + q);
    const bool use_t = q < cnt_t;
    const bool use_l = q >= cnt_t && q < cnt_t + cnt_l;
    sl[q] = use_t ? lt : use_l ? ll : 0;
    sc[q] = use_t ? ct : use_l ? cl : 0;
  }
  if (lane != 0) return;
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

// the downsampled luma of CCLM sample (y, x), which the fit maps
__device__ int cclm_ds(const Cclm& c, const int* d, int y, int x) {
  const int yy = d[2] * c.sub_h + c.sub_h * y;
  const int xx = d[1] * c.sub_w + c.sub_w * x;
  const bool no_left = x == 0 && d[23] != 1;
  int ds;
  if (c.collocated) {
    const int left_tap = no_left ? xx : xx - 1;
    const int top_tap = (y == 0 && d[27] != 1) ? yy : yy - c.stro;
    ds = taps5(c, nrow(c, top_tap), nrow(c, yy), nrow(c, yy + c.stro),
               ncol(c, xx), ncol(c, left_tap), ncol(c, xx + 1));
  } else {
    const int lx0 = no_left ? xx : max(xx - 1, 0);
    const int xs1 = min(xx + 1, c.lw - 1);
    ds = taps6(c, nrow(c, yy), nrow(c, yy + c.stro), ncol(c, xx),
               ncol(c, lx0), ncol(c, xs1));
  }
  return ds;
}

// CCLM's prediction of a downsampled luma ds by the fit sc = (a, b, shift)
__device__ __forceinline__ int cclm_map(const Params& p, const int* sc,
                                        int ds) {
  return clampi(sc[1] + ((sc[0] * ds) >> sc[2]), 0, (1 << p.bd) - 1);
}

// ---------------------------------------------------------------- LMCS
// lane's share of the weighted luma left of and above the VPDU's
// top-left CU (calculateChromaAdjVpduNei), read before the set-up
__device__ void lmcs_sums(const Params& p, const int* lm, const int* d,
                          int lane, int* sum_l, int* sum_t) {
  const int num_nb = min(64, 1 << p.ctu_log2);
  const int xpos = d[30], ypos = d[31];
  const int lim_l = clampi(lm[67] - ypos, 1, num_nb);
  const int lim_t = clampi(lm[68] - xpos, 1, num_nb);
  const int r0 = win_start(ypos, num_nb, p.hh);
  const int c0 = win_start(max(xpos - 1, 0), 1, p.ww);
  const int r1 = win_start(max(ypos - 1, 0), 1, p.hh);
  const int c1 = win_start(xpos, num_nb, p.ww);
  int sl = 0, st = 0;
  for (int j = lane; j < num_nb; j += 32) {
    const int wl = j < lim_l - 1 ? 1 : j == lim_l - 1 ? num_nb - lim_l + 1 : 0;
    const int wt = j < lim_t - 1 ? 1 : j == lim_t - 1 ? num_nb - lim_t + 1 : 0;
    sl += ldp(p.planes + static_cast<size_t>(r0 + j) * p.ww + c0) * wl;
    st += ldp(p.planes + static_cast<size_t>(r1) * p.ww + c1 + j) * wt;
  }
  *sum_l = sl;
  *sum_t = st;
}

// the chroma residual scale of unit k by its warp, from the lanes'
// lmcs_sums: the average's bin's entry of the chroma table, into
// sm.scal[k][3]
__device__ void lmcs_setup(const Params& p, Shared& sm, const int* d, int k,
                           int lane, int sum_l, int sum_t) {
  const int* lm = sm.lm;
  const int num_nb = min(64, 1 << p.ctu_log2);
  const int log_nb = 31 - __clz(num_nb);
  const bool left_ok = (d[29] & 2) != 0, above_ok = (d[29] & 4) != 0;
  sum_l = __reduce_add_sync(kFull, sum_l);
  sum_t = __reduce_add_sync(kFull, sum_t);
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
// the rows ys to ye of its unit a plan row holds (its slice), from the
// pad field d[32] = ys | ye << 8
__device__ __forceinline__ int slice_y0(const int* d) { return d[32] & 255; }
__device__ __forceinline__ int slice_rows(const int* d) {
  return max((d[32] >> 8) - (d[32] & 255), 0);
}

// the plane index of sample (y, x) of unit d's h x w corner
__device__ __forceinline__ size_t sample_at(const Params& p, const int* d,
                                            int y, int x) {
  return clampi(d[0], 0, 2) * (static_cast<size_t>(p.hh) * p.ww) +
         static_cast<size_t>(win_start(d[2], kB, p.hh) + y) * p.ww +
         win_start(d[1], kB, p.ww) + x;
}

// sample t of a chunk: its row k (the last with off[k] <= t) and its
// index o in the row's slice, by a branch-free select over the chunk's
// offsets, which each thread holds in registers
__device__ __forceinline__ void locate(const int (&off)[kU + 1], int t,
                                       int& k, int& o) {
  int base = 0;
  k = 0;
#pragma unroll
  for (int j = 1; j < kU; ++j) {
    if (off[j] <= t) {
      k = j;
      base = off[j];
    }
  }
  o = t - base;
}

__global__ void __launch_bounds__(kThreads)
    intra_wavefront_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pel_max = (1 << p.bd) - 1;
  uint16_t* staged = reinterpret_cast<uint16_t*>(smem_raw + sizeof(Shared));
  const int rank = static_cast<int>(cluster_rank());
  const int* recs = p.plan + kHead;
  const int e0 = __ldg(p.plan + rank), e1 = __ldg(p.plan + rank + 1);
  if (e0 < e1) copy_record(sm.rec[0], recs + e0, tid);
  for (int i = tid; i < kConstLen; i += kThreads) sm.consts[i] = p.consts[i];
  if (p.has_lmcs) {
    for (int i = tid; i < kLmLen; i += kThreads) sm.lm[i] = p.lm[i];
  }
  const Cclm cc = cclm_of(p);
  int phase = 0;
  for (int e = e0, buf = 0; e < e1; buf ^= 1) {
    wait_copies();
    // this record has landed for every thread; the last chunk's shared
    // state is free
    __syncthreads();
    const int* rec = sm.rec[buf];
    const int nu = rec[1];
    const int* rows = rec + 4;
    e += 4 + nu * kRow;
    if (e < e1) copy_record(sm.rec[buf ^ 1], recs + e, tid);
    // a chunk of a later phase: arrive at the barrier that ends this
    // block's phase now, and wait once the reads that need no plane (the
    // residuals) are under way
    const bool later = phase < rec[0];
    if (later) cluster_arrive();
    // first output sample of each row's slice, in every thread
    int off[kU + 1];
    off[0] = 0;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int* d = rows + k * kRow;
      off[k + 1] = off[k] + ((k < nu && d[28] == 1)
                                 ? slice_rows(d) * max(min(d[3], kB), 0)
                                 : 0);
    }
    const int total = off[kU];
    // this thread's first two samples' residuals, read now: their
    // latency passes under the barrier's
    int pre_r[2], pre_ds[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tid + u * kThreads;
      pre_r[u] = pre_ds[u] = 0;
      if (t < total) {
        int k, o;
        locate(off, t, k, o);
        const int* d = rows + k * kRow;
        const int w = min(d[3], kB);
        if (d[9] == 1) {
          pre_r[u] = __ldg(p.resi + sample_at(p, d, slice_y0(d) + o / w,
                                              o % w));
        }
      }
    }
    if (later) {
      cluster_wait();
      // and the barriers of the phases this block has no unit in
      for (++phase; phase < rec[0]; ++phase) cluster_sync();
    }
    // the plane reads that need no reference, issued before the
    // references so their latencies overlap: CCLM's downsampled luma of
    // this thread's first two samples, its template points (lanes 0-7 of
    // warp k) and the LMCS sums (warp kU + k)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = tid + u * kThreads;
      if (t < total) {
        int k, o;
        locate(off, t, k, o);
        const int* d = rows + k * kRow;
        const int w = min(d[3], kB);
        if (d[7] == 4) pre_ds[u] = cclm_ds(cc, d, slice_y0(d) + o / w, o % w);
      }
    }
    int tmpl = 0, sum_l = 0, sum_t = 0;
    {
      const int k = warp % kU;
      const int* d = rows + k * kRow;
      if (k < nu && d[28] == 1) {
        if (warp < kU && d[7] == 4) {
          tmpl = cclm_template(p, cc, d, lane);
        } else if (warp >= kU && warp < 2 * kU && p.has_lmcs &&
                   (d[29] & 1)) {
          lmcs_sums(p, sm.lm, d, lane, &sum_l, &sum_t);
        }
      }
    }
    // the smoothed references of every unit
    for (int i = tid; i < kU * kRL; i += kThreads) {
      const int k = i / kRL, j = i - k * kRL;
      const int* d = rows + k * kRow;
      if (k < nu && d[28] == 1) gather_ref(p, d, j, &sm.top[k][j],
                                           &sm.left[k][j]);
    }
    __syncthreads();
    // per-unit set-up: warp k the class's, warp kU + k the LMCS scale
    bool setup = false;
    for (int k = 0; k < nu; ++k) {
      const int* d = rows + k * kRow;
      setup |= d[28] == 1 && (d[7] == 1 || d[7] == 3 || d[7] == 4 ||
                              (p.has_lmcs && (d[29] & 1)));
    }
    if (setup) {
      const int k = warp % kU;
      const int* d = rows + k * kRow;
      if (k < nu && d[28] == 1) {
        if (warp < kU) {
          if (d[7] == 1) {
            dc_setup(sm, d, k, lane);
          } else if (d[7] == 3) {
            mip_setup(p, sm, d, k, lane);
          } else if (d[7] == 4) {
            cclm_setup(p, sm, d, k, lane, tmpl);
          }
        } else if (warp < 2 * kU && p.has_lmcs && (d[29] & 1)) {
          lmcs_setup(p, sm, d, k, lane, sum_l, sum_t);
        }
      }
      __syncthreads();
    }
    // every output sample, straight to the planes (staged: to shared
    // memory, written after every read of the chunk)
#pragma unroll 1
    for (int i = 0, t = tid; t < total; ++i, t += kThreads) {
      int k, o;
      locate(off, t, k, o);
      const int* d = rows + k * kRow;
      const int* T = sm.top[k];
      const int* L = sm.left[k];
      const int w = min(d[3], kB);
      const int y = slice_y0(d) + o / w, x = o % w;
      const size_t at = sample_at(p, d, y, x);
      const int mc = d[7];
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
          v = cclm_map(p, sm.scal[k],
                       i == 0 ? pre_ds[0]
                              : i == 1 ? pre_ds[1] : cclm_ds(cc, d, y, x));
          break;
        default:
          v = pred_planar(d, T, L, y, x);
      }
      if ((mc == 0 || mc == 1 || mc == 5) && d[27] == 1) {
        v = pdpc_dc_planar(d, T, L, v, y, x);
      }
      if (mc == 5) v = (d[25] * ldp(p.planes + at) + d[24] * v + 2) >> 2;
      if (d[9] == 1) {
        int r = i == 0 ? pre_r[0] : i == 1 ? pre_r[1] : __ldg(p.resi + at);
        if (p.has_lmcs && (d[29] & 1)) r = scale_signal(r, sm.scal[k][3], p.bd);
        v += r;
      }
      v = clampi(v, 0, pel_max);
      if (p.staged) {
        staged[t] = static_cast<uint16_t>(v);
      } else {
        p.planes[at] = v;
      }
    }
    if (p.staged) {
      __syncthreads();
      for (int t = tid; t < total; t += kThreads) {
        int k, o;
        locate(off, t, k, o);
        const int* d = rows + k * kRow;
        const int w = min(d[3], kB);
        p.planes[sample_at(p, d, slice_y0(d) + o / w, o % w)] = staged[t];
      }
    }
  }
  // the barriers after this block's last unit
  for (; phase < p.n_phases - 1; ++phase) cluster_sync();
}

}  // namespace

// One launch of one cluster of `cluster` blocks over a host plan
// (ops/cuda/intra.py wavefront_plan) of n_phases phases on `stream`;
// `staged` (one block, a chunk a phase) writes each chunk's samples after
// all its reads.  Returns the cudaError_t of the launch (0 on success).
extern "C" int intra_wavefront_launch(int* planes, const int* resi,
                                      const int* plan, int n_phases,
                                      int cluster, int hh, int ww,
                                      const int* consts, const int* lm,
                                      int bd, int cfmt, int collocated,
                                      int ctu_log2, int has_lmcs,
                                      int staged, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || n_phases < 0 || hh < kRL ||
      ww < kRL || (staged && cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(
      sizeof(Shared) + (staged ? kU * kB * kB * sizeof(uint16_t) : 0));
  cudaError_t e = cudaFuncSetAttribute(
      intra_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cluster > 8) {
    e = cudaFuncSetAttribute(intra_wavefront_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Params p{planes, resi, plan, consts, lm, n_phases, hh, ww,
           bd, cfmt, collocated, ctu_log2, has_lmcs, staged};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, intra_wavefront_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
