// Dequantisation + separable inverse transform of every TU of a frame
// that takes the plain (non-transform-skip, non-LFNST, no scaling list)
// path, in one launch.
//
// Replaces the TPU kernel vvdec_tpu/ops/pallas/itx.py::itx_batch_pallas
// (pallas_call at :96, body _itx_kernel, helper _exact_i32_dot).  Per TU
// of h x w at (y, x) of component c:
//   dequant:    clip the level to [-imax-1, imax], times scale, rounded
//               >> rshift (or << -rshift), 0 where the level is 0, clip to
//               the 16-bit transform range;
//   vertical:   tmp[x][y'] = sum_k deq[k][x] * Mv[k][y'], (+64) >> 7, clip;
//   horizontal: res[y'][x'] = sum_k tmp[k][y'] * Mh[k][x'],
//               (+2^(s2-1)) >> s2 with s2 = 20 - bit_depth, clip.
// The TPU kernel ran once per TU shape group on an [N, h, w] int32 batch
// that XLA gathered from the coefficient plane and scattered back.
//
// What bounds it on an H100: a frame's whole ITX work is small (levels
// in at 2 bytes and residuals out at 4 bytes a coefficient, h + w
// multiply-adds a coefficient), bounded at about a microsecond.  Run as
// one launch per shape group (about 40 a frame, most of a few dozen TUs),
// launch latency, tail and the host's gather / scatter around each launch
// set the time, and a 64x64 TU on one block's CUDA cores takes tens of
// microseconds of dependent int32 multiply-adds.
//
// Design:
// - One launch per frame.  The host builds a work table (`tasks + 1`
//   task starts, then one row of kRowInts ints per TU: component, y, x,
//   log2 h, log2 w, the offsets of Mv and Mh in the matrix pool, and
//   scale, rshift, imax) and orders it: every TU with both sides >= 16 is
//   a task of its own, largest first; smaller TUs of one shape are packed
//   up to kSmallCap coefficients a task (a TU larger than that alone).
//   One block runs one task.
// - The kernel reads the levels (int16 from the frame's coefficient
//   plane, or int32) and writes int32 residuals into the padded residual
//   plane itself.  Window starts are clamped as lax.dynamic_slice clamps
//   them: reads to the coefficient plane's size, writes to the residual
//   plane's.  TU rectangles of one component are disjoint, so no two
//   blocks write one sample.
// - TUs with both sides >= 16 multiply on the int8 tensor cores
//   (mma.sync m16n8k32).  Each operand a (|a| <= 2^15) is split into
//   hi = a >> 8 (s8) and lo = a & 255 (u8); hi x M (s8 x s8) and lo x M
//   (u8 x s8) accumulate in int32 and recombine as (hi << 8) + lo, the
//   TPU kernel's _exact_i32_dot.  Every matrix entry fits s8 (|M| <= 91),
//   each partial sum stays below 2^21 and the true sum below 2^28, so the
//   result is exact.  The levels and both matrices (s8, at most 4 KB
//   each, transposed) go into shared memory with cp.async; the
//   dequantised levels and the vertical pass's output are kept there as
//   hi / lo byte planes.  A side of 16 is padded to the MMA's depth of 32
//   with zero operands.
// - Smaller TUs (a side of 2, 4 or 8) run on the CUDA cores in int32,
//   one coefficient per thread, matrices (as they stand, so that a warp's
//   loads coalesce) through the read-only cache.
// The pool holds each s8 matrix M [n][n] (row = frequency) at its offset
// as M^T, then M at the next 16-byte boundary (plain_offset).
// A frame's blocks (about 500 for 832x480) fit on the card at once, so
// what bounds the launch is the latency of its slowest block, a 64x64
// TU: the dependent loads of its table row and levels, three barriers
// and two passes.  Bytes and operations are far below that.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTrMin = -(1 << 15);
constexpr int kTrMax = (1 << 15) - 1;
constexpr int kSmallCap = kThreads;  // coefficients of a small-TU task
constexpr int kSmallMax = 8 * 64;   // the largest TU with a side below 16,
                                    // a task of its own
constexpr int kMaxSide = 64;
constexpr int kPad = 16;  // bytes after each s8 row: spreads a fragment
                          // load's 8 rows over distinct banks
constexpr int kTile = kMaxSide * (kMaxSide + kPad);  // one s8 plane
// large TU: A hi, A lo, Mv^T, Mh^T planes, then the staged levels (at
// most 64 x 64 int32), which the vertical pass's hi / lo planes reuse
constexpr int kSmemBytes = 4 * kTile + kMaxSide * kMaxSide * 4;
static_assert(2 * kTile <= kMaxSide * kMaxSide * 4, "t planes fit");

// fields of one TU row of the work table
enum { kComp, kY, kX, kLog2H, kLog2W, kMvOff, kMhOff, kScale, kRshift,
       kImax, kRowInts };

// a small task: deq and tmp of at most kSmallMax coefficients each, and
// the rows of at most kSmallCap / 4 TUs (2x2 the smallest)
static_assert(kSmallCap <= kSmallMax
              && (2 * kSmallMax + kSmallCap / 4 * kRowInts) * 4 <= kSmemBytes,
              "small tasks fit");

struct Plane {          // one component
  const void* coef;     // [coef_h][coef_w] levels, int16 or int32
  int* resi;            // [resi_h][resi_w] int32, written in place
  int coef_h, coef_w, resi_h, resi_w;
};
struct Planes {
  Plane c[3];
};

// Indexing the kernel argument with a run-time component would copy it
// to local memory in every thread; select with branches instead.
__device__ __forceinline__ Plane plane_of(const Planes& P, int comp) {
  return comp == 0 ? P.c[0] : (comp == 1 ? P.c[1] : P.c[2]);
}

// where M itself follows M^T in the matrix pool
__device__ __forceinline__ int plain_offset(int n) {
  return (n * n + 15) & ~15;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int dequant(int lv, int scale, int rs, int im) {
  if (lv == 0) return 0;
  const int prod = clampi(lv, -im - 1, im) * scale;
  int deq;
  if (rs > 0) {
    deq = (prod + (1 << (rs - 1))) >> rs;
  } else {
    // int32 wrap-around, as the reference's shift
    deq = -rs >= 32 ? 0 : (int)((unsigned)prod << (-rs));
  }
  return clampi(deq, kTrMin, kTrMax);
}

__device__ __forceinline__ unsigned ld32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// D += A (16x32, row) * B (32x8, col), int32 accumulate; A signed or
// unsigned bytes, B signed bytes.
template <bool kUnsignedA>
__device__ __forceinline__ void mma_k32(int (&d)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  if (kUnsignedA) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// One 16 x 8 output tile of C = A * B^T over depth kd: A is [M][kd] bytes
// (hi and lo planes), B^T is [N][kd] s8, both with row stride `st`.
// Returns the recombined exact int32 sums; element i of the result sits
// at row m0 + g + 8 * (i >> 1), column n0 + 2 * t + (i & 1).
__device__ __forceinline__ void tile_product(int (&c)[4],
                                             const unsigned char* a_hi,
                                             const unsigned char* a_lo,
                                             const unsigned char* bt, int st,
                                             int kd, int m0, int n0, int g,
                                             int t) {
  int hi[4] = {0, 0, 0, 0}, lo[4] = {0, 0, 0, 0};
  const int ra = (m0 + g) * st + 4 * t, rb = (n0 + g) * st + 4 * t;
  for (int k0 = 0; k0 < kd; k0 += 32) {
    const unsigned b[2] = {ld32(bt + rb + k0), ld32(bt + rb + k0 + 16)};
    unsigned a[4] = {ld32(a_hi + ra + k0), ld32(a_hi + ra + 8 * st + k0),
                     ld32(a_hi + ra + k0 + 16),
                     ld32(a_hi + ra + 8 * st + k0 + 16)};
    mma_k32<false>(hi, a, b);
    a[0] = ld32(a_lo + ra + k0);
    a[1] = ld32(a_lo + ra + 8 * st + k0);
    a[2] = ld32(a_lo + ra + k0 + 16);
    a[3] = ld32(a_lo + ra + 8 * st + k0 + 16);
    mma_k32<true>(lo, a, b);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = hi[i] * 256 + lo[i];
}

// Copy `rows` rows of `row_bytes` (a multiple of 16) from global to
// shared memory with cp.async where the source is 16-byte aligned, else
// element by element.
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_st,
                                           const T* src, size_t src_st,
                                           int rows, int row_bytes) {
  const int chunks = row_bytes >> 4;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) << 4;
    const unsigned char* s =
        reinterpret_cast<const unsigned char*>(src + r * src_st) + c;
    unsigned char* d = dst + r * dst_st + c;
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
      for (int j = 0; j < 16; j += sizeof(T))
        *reinterpret_cast<T*>(d + j) = *reinterpret_cast<const T*>(s + j);
    }
  }
}

// A TU with both sides >= 16, on the tensor cores.
template <typename LevelT>
__device__ __forceinline__ void large_tu(const int* __restrict__ row,
                                         const Planes& P,
                                         const int8_t* __restrict__ pool,
                                         int s2, unsigned char* smem) {
  const Plane pl = plane_of(P, row[kComp]);
  const int lh = row[kLog2H], lw = row[kLog2W];
  const int h = 1 << lh, w = 1 << lw;
  const int hk = max(h, 32), wk = max(w, 32);  // depths of the two passes
  const int sa = hk + kPad, sb = wk + kPad;    // s8 row strides
  unsigned char* a_hi = smem;                  // [w][sa]: deq^T hi bytes
  unsigned char* a_lo = smem + kTile;          // [w][sa]: deq^T lo bytes
  unsigned char* mvt = smem + 2 * kTile;       // [h][sa]: Mv^T
  unsigned char* mht = smem + 3 * kTile;       // [w][sb]: Mh^T
  const LevelT* stage = reinterpret_cast<const LevelT*>(smem + 4 * kTile);
  unsigned char* t_hi = smem + 4 * kTile;      // [h][sb]: tmp^T hi bytes
  unsigned char* t_lo = t_hi + kTile;          // [h][sb]: tmp^T lo bytes

  const int ry = clampi(row[kY], 0, pl.coef_h - h);
  const int rx = clampi(row[kX], 0, pl.coef_w - w);
  stage_rows(smem + 4 * kTile, w * (int)sizeof(LevelT),
             static_cast<const LevelT*>(pl.coef) + (size_t)ry * pl.coef_w + rx,
             (size_t)pl.coef_w, h, w * (int)sizeof(LevelT));
  stage_rows(mvt, sa, pool + row[kMvOff], (size_t)h, h, h);
  stage_rows(mht, sb, pool + row[kMhOff], (size_t)w, w, w);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // dequantise into deq^T hi / lo planes, four k at a time; k >= h (a
  // side of 16 padded to 32) gets zeros, so Mv^T's padding never counts
  const int scale = row[kScale], rs = row[kRshift], im = row[kImax];
  const int lkq = max(lh, 5) - 2;
  for (int i = threadIdx.x; i < (w << lkq); i += kThreads) {
    const int x = i >> lkq, k0 = (i & ((1 << lkq) - 1)) << 2;
    unsigned hi = 0, lo = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + j;
      const int d = k < h ? dequant((int)stage[k * w + x], scale, rs, im) : 0;
      hi |= (unsigned)((d >> 8) & 255) << (8 * j);
      lo |= (unsigned)(d & 255) << (8 * j);
    }
    *reinterpret_cast<unsigned*>(a_hi + x * sa + k0) = hi;
    *reinterpret_cast<unsigned*>(a_lo + x * sa + k0) = lo;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the staged levels are dead: zero the tmp^T padding (w = 16)
  for (int i = threadIdx.x; i < h * ((wk - w) >> 2); i += kThreads) {
    const int y = i / ((wk - w) >> 2), c = w + ((i % ((wk - w) >> 2)) << 2);
    *reinterpret_cast<unsigned*>(t_hi + y * sb + c) = 0;
    *reinterpret_cast<unsigned*>(t_lo + y * sb + c) = 0;
  }
  // vertical: C[x][y'] = sum_k deq^T[x][k] * Mv^T[y'][k]
  const int nt1 = h >> 3;
  for (int tile = warp; tile < (w >> 4) * nt1; tile += kWarps) {
    const int m0 = (tile / nt1) << 4, n0 = (tile % nt1) << 3;
    int c[4];
    tile_product(c, a_hi, a_lo, mvt, sa, hk, m0, n0, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = m0 + g + ((i >> 1) << 3), y = n0 + 2 * t + (i & 1);
      const int v = clampi((c[i] + 64) >> 7, kTrMin, kTrMax);
      t_hi[y * sb + x] = (unsigned char)((v >> 8) & 255);
      t_lo[y * sb + x] = (unsigned char)(v & 255);
    }
  }
  __syncthreads();

  // horizontal: C[y'][x'] = sum_x tmp^T[y'][x] * Mh^T[x'][x], into the
  // residual plane
  const int wy = clampi(row[kY], 0, pl.resi_h - h);
  const int wx = clampi(row[kX], 0, pl.resi_w - w);
  const int rnd = 1 << (s2 - 1);
  const int nt2 = w >> 3;
  for (int tile = warp; tile < (h >> 4) * nt2; tile += kWarps) {
    const int m0 = (tile / nt2) << 4, n0 = (tile % nt2) << 3;
    int c[4];
    tile_product(c, t_hi, t_lo, mht, sb, wk, m0, n0, g, t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = m0 + g + ((i >> 1) << 3), x = n0 + 2 * t + (i & 1);
      pl.resi[(size_t)(wy + y) * pl.resi_w + wx + x] =
          clampi((c[i] + rnd) >> s2, kTrMin, kTrMax);
    }
  }
}

// `ntu` TUs of one shape with a side below 16, on the CUDA cores.
template <typename LevelT>
__device__ __forceinline__ void small_tus(const int* __restrict__ rows,
                                          int ntu, const Planes& P,
                                          const int8_t* __restrict__ pool,
                                          int s2, int* smem) {
  const int lh = rows[kLog2H], lw = rows[kLog2W], lhw = lh + lw;
  const int h = 1 << lh, w = 1 << lw, hw = 1 << lhw;
  const int total = ntu << lhw;
  int* sdeq = smem;                  // [T][h][w]
  int* stmp = smem + kSmallMax;      // [T][w][h]
  int* srow = smem + 2 * kSmallMax;  // [T][kRowInts]: the task's rows
  for (int i = threadIdx.x; i < ntu * kRowInts; i += kThreads)
    srow[i] = rows[i];
  __syncthreads();

  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int* r = srow + (e >> lhw) * kRowInts;
    const Plane pl = plane_of(P, r[kComp]);
    const int y = clampi(r[kY], 0, pl.coef_h - h) + ((e & (hw - 1)) >> lw);
    const int x = clampi(r[kX], 0, pl.coef_w - w) + (e & (w - 1));
    const LevelT lv =
        static_cast<const LevelT*>(pl.coef)[(size_t)y * pl.coef_w + x];
    sdeq[e] = dequant((int)lv, r[kScale], r[kRshift], r[kImax]);
  }
  __syncthreads();

  // vertical: tmp[x][y'] = sum_k deq[k][x] * Mv[k][y']
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tu = e >> lhw, p = e & (hw - 1);
    const int x = p >> lh, y = p & (h - 1);
    const int8_t* m =
        pool + srow[tu * kRowInts + kMvOff] + plain_offset(h) + y;
    const int* d = sdeq + (tu << lhw) + x;
    int acc = 0;
    for (int k = 0; k < h; ++k) acc += d[k << lw] * (int)m[k << lh];
    stmp[e] = clampi((acc + 64) >> 7, kTrMin, kTrMax);
  }
  __syncthreads();

  // horizontal: res[y'][x'] = sum_k tmp[k][y'] * Mh[k][x']
  const int rnd = 1 << (s2 - 1);
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int tu = e >> lhw, p = e & (hw - 1);
    const int y = p >> lw, x = p & (w - 1);
    const int* r = srow + tu * kRowInts;
    const int8_t* m = pool + r[kMhOff] + plain_offset(w) + x;
    const int* tp = stmp + (tu << lhw) + y;
    int acc = 0;
    for (int k = 0; k < w; ++k) acc += tp[k << lh] * (int)m[k << lw];
    const Plane pl = plane_of(P, r[kComp]);
    const int oy = clampi(r[kY], 0, pl.resi_h - h) + y;
    const int ox = clampi(r[kX], 0, pl.resi_w - w) + x;
    pl.resi[(size_t)oy * pl.resi_w + ox] =
        clampi((acc + rnd) >> s2, kTrMin, kTrMax);
  }
}

template <typename LevelT>
__global__ void __launch_bounds__(kThreads)
itx_kernel(Planes P, const int* __restrict__ table, int n_tasks,
           const int8_t* __restrict__ pool, int s2) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  const int first = table[blockIdx.x], last = table[blockIdx.x + 1];
  const int* rows = table + n_tasks + 1 + (size_t)first * kRowInts;
  if (rows[kLog2H] >= 4 && rows[kLog2W] >= 4) {
    for (int i = 0; i < last - first; ++i) {
      large_tu<LevelT>(rows + i * kRowInts, P, pool, s2, smem);
      __syncthreads();
    }
  } else {
    small_tus<LevelT>(rows, last - first, P, pool, s2,
                      reinterpret_cast<int*>(smem));
  }
}

}  // namespace

// planes: host array of 3 x 6 int64, per component {coef pointer,
// coef_h, coef_w, resi pointer, resi_h, resi_w} (pointers of absent
// components 0); table: device int32 work table of n_tasks tasks; pool:
// device s8 matrix pool (16-byte aligned offsets, each M^T then M);
// level_bytes: 2 for
// int16 levels, 4 for int32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int itx_frame_launch(const long long* planes, const void* table,
                                int n_tasks, const void* pool, int s2,
                                int level_bytes, void* stream) {
  if (n_tasks <= 0) return 0;
  Planes P;
  for (int c = 0; c < 3; ++c) {
    const long long* d = planes + 6 * c;
    P.c[c] = {reinterpret_cast<const void*>(d[0]), reinterpret_cast<int*>(d[3]),
              (int)d[1], (int)d[2], (int)d[4], (int)d[5]};
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(table);
  const int8_t* mp = static_cast<const int8_t*>(pool);
  if (level_bytes == 2) {
    itx_kernel<int16_t><<<n_tasks, kThreads, 0, s>>>(P, tab, n_tasks, mp, s2);
  } else if (level_bytes == 4) {
    itx_kernel<int32_t><<<n_tasks, kThreads, 0, s>>>(P, tab, n_tasks, mp, s2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
