// SAO, ALF (4x4 classification, 7x7 luma and 5x5 chroma clipped
// diamonds) and CC-ALF of the device filter chain: SAO of every component
// in one launch, ALF and CC-ALF of every component in the next.
//
// Replaces the SAO and ALF closures of the reference's filter chain, the
// jax.jit program vvdec_tpu/ops/device_pipeline.py::_chain_fn (:503-634):
// _sao_plane per component, _classify_dense, the bank gathers of the
// per-sample coefficient and clip maps, _alf_diamond_dense_core
// (vvdec_tpu/ops/pipeline.py) for luma and chroma and _ccalf_dense_core.
// The port's plain version (the same helpers in PyTorch, composed by
// ops/cuda/sao_alf.py::sao_alf_ref) is the specification, bit for bit:
// int32 sums that wrap, the uint32 products of the direction test, JAX's
// gather index rules (a negative bank index wraps once, then clamps).
//
// What bounds it on an H100: bytes.  A 832x480 4:2:0 picture is 0.6 M
// samples; reading and writing its int32 planes once is 4.8 MB, 1.4 us at
// 3.35 TB/s (SAO and ALF as two launches, as here: twice that).  The plain
// version is ~1,060 whole-plane PyTorch ops a picture, bound by their
// launches on the host, and two [h, w, 12] int32 coefficient and clip maps.
//
// Design:
// - SAO (sao_kernel): one thread an output sample, blockIdx.y the
//   component, blockIdx.z the frame (the batched chain stacks its
//   pictures on a leading axis).  It reads the CTU's type and offsets from
//   the int16 parameter vector as the host uploaded it and its two
//   neighbours (clamped to the plane) from the input plane.
// - ALF (alf_ccalf_kernel): a block owns a 2-D output tile, luma 64 x 32
//   or chroma 32 x 32; blockIdx.x runs over the luma tiles, then Cb's,
//   then Cr's.  The block stages its tile with a halo in shared memory,
//   each staged sample read at the picture position clamped to the plane
//   (the plain version's clamped index tables): luma 3 samples a side (the
//   7x7 diamond and the classification's window), chroma 2, and for
//   CC-ALF the co-located post-SAO luma, rows ly-1..ly+2 and columns
//   lx-1..lx+1 of each chroma sample.  A luma tile classifies its 4x4
//   blocks into shared memory (one thread a block) and each sample then
//   filters with the bank row of (set_ctu[CTU], transpose, class), read
//   straight from the uploaded banks.  Nothing per sample goes to device
//   memory but the output planes.
// - The virtual-boundary rules are computed per row: the tap distances of
//   ALF (frame/alf_np._vb_row_offsets) at ctu - 4 (luma) and ctu/sub_h - 2
//   (chroma), the classification's row substitutions and 3-row sums, and
//   CC-ALF's row offsets and skipped rows at ctu - 4.
// - A chroma sample takes ALF first, then the CC-ALF correction from the
//   post-SAO luma, as the chain composes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the ALF launch's tiles and halos
constexpr int kLumaW = 64, kLumaH = 32, kLumaHalo = 3;
constexpr int kChromaW = 32, kChromaH = 32, kChromaHalo = 2;
constexpr int kLumaSW = kLumaW + 2 * kLumaHalo;        // 70
constexpr int kLumaSH = kLumaH + 2 * kLumaHalo;        // 38
constexpr int kBlocksX = kLumaW / 4, kBlocks = kBlocksX * (kLumaH / 4);
constexpr int kChromaSW = kChromaW + 2 * kChromaHalo;  // 36
constexpr int kChromaSH = kChromaH + 2 * kChromaHalo;  // 36
// the co-located luma of a 4:2:0 chroma tile, the largest: columns
// 2 * xc - 1 .. 2 * xc + 1, rows 2 * yc - 1 .. 2 * yc + 2
constexpr int kCcMax = (2 * (kChromaW - 1) + 3) * (2 * (kChromaH - 1) + 4);
constexpr int kLumaSmem = kLumaSW * kLumaSH + kBlocks;
constexpr int kChromaSmem = kChromaSW * kChromaSH + kCcMax;
constexpr int kSmem = kLumaSmem > kChromaSmem ? kLumaSmem : kChromaSmem;

// the fields of the parameter vector (device_pipeline._flat_layout), in
// the order of the wrapper's offsets (ops/cuda/sao_alf.py FIELDS)
enum Field {
  kSaoType, kSaoVals, kEnY, kSetCtu, kEnC, kAltCtu, kCcCtu, kBanksCo,
  kBanksCl, kCBanksCo, kCBanksCl, kCcBanks, kFields
};

struct Plane {
  const int* in;  // [F, H, W]
  int* out;       // [F, H, W]
  int H, W;
};

struct Args {
  Plane c[3];
  const short* flat;  // [F, stride] the uploaded int16 parameter vectors
  long long stride;
  int off[kFields];   // each field's offset in a picture's vector
  int bd, ctu, sub_w, sub_h, w_ctu, n_ctu, n_banks, n_cb, n_cc;
  int alf_luma, alf_chroma, cc_on;
  int luma_tiles, luma_tiles_x, chroma_tiles, chroma_tiles_x;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ Plane plane_of(const Args& a, int comp) {
  return comp == 0 ? a.c[0] : comp == 1 ? a.c[1] : a.c[2];
}

// The index a JAX gather reads for v along an axis of length n
// (intra_device._jidx): a negative index wraps once, then clamps.
__device__ __forceinline__ int jidx(int v, int n) {
  return clampi(v < 0 ? v + n : v, 0, n - 1);
}

// |v| of an int32 that may have wrapped, as torch.abs gives it.
__device__ __forceinline__ unsigned uabs(unsigned v) {
  return (int)v < 0 ? 0u - v : v;
}

// ALF's vertical tap distances d[1..3] of row y and its near-boundary
// flag (frame/alf_np._vb_row_offsets).
__device__ __forceinline__ void vb_rows(int y, int vb_h, int vb_pos,
                                        bool chroma, int d[4], bool* near) {
  const int yvb = y & (vb_h - 1);
  const int lim = chroma ? 2 : 4;
  d[0] = 0;
  d[1] = 1;
  d[2] = 2;
  d[3] = 3;
  *near = yvb == vb_pos - 1 || yvb == vb_pos;
  if (yvb < vb_pos && yvb >= vb_pos - lim) {
    d[1] = yvb == vb_pos - 1 ? 0 : 1;
    d[2] = yvb >= vb_pos - 2 ? d[1] : 2;
    d[3] = yvb >= vb_pos - 3 ? d[2] : 3;
  } else if (yvb >= vb_pos && yvb <= vb_pos + lim - 1) {
    d[1] = yvb == vb_pos ? 0 : 1;
    d[2] = yvb <= vb_pos + 1 ? d[1] : 2;
    d[3] = yvb <= vb_pos + 2 ? d[2] : 3;
  }
}

// The clipped difference pair of one diamond tap.
__device__ __forceinline__ int clip_pair(int pa, int pb, int s, int ck) {
  return clampi(pa - s, -ck, ck) + clampi(pb - s, -ck, ck);
}

// A staged window: sample (r, c) in picture coordinates, the window
// holding the plane's samples at the clamped positions.
struct Window {
  const int* s;
  int r0, c0, sw;
  __device__ __forceinline__ int operator()(int r, int c) const {
    return s[(r - r0) * sw + (c - c0)];
  }
  __device__ __forceinline__ unsigned u(int r, int c) const {
    return (unsigned)(*this)(r, c);
  }
};

// Stage rows r0.., columns c0.. (rows x cols) of plane `src` [H, W] at
// clamped positions into `dst`.
__device__ __forceinline__ void stage(int* dst, const int* src, int H, int W,
                                      int r0, int c0, int rows, int cols) {
  for (int k = threadIdx.x; k < rows * cols; k += kThreads) {
    const int r = clampi(r0 + k / cols, 0, H - 1);
    const int c = clampi(c0 + k % cols, 0, W - 1);
    dst[k] = __ldg(src + (size_t)r * W + c);
  }
}

// ------------------------------------------------------------------ SAO

__global__ void __launch_bounds__(kThreads) sao_kernel(Args a) {
  const int comp = blockIdx.y, f = blockIdx.z;
  const Plane P = plane_of(a, comp);
  const int H = P.H, W = P.W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)H * W) return;
  const int y = (int)(i / W), x = (int)(i % W);
  const int* plane = P.in + (size_t)f * H * W;
  const short* prm = a.flat + (size_t)f * a.stride;
  const int ctu_w = comp ? a.ctu / a.sub_w : a.ctu;
  const int ctu_h = comp ? a.ctu / a.sub_h : a.ctu;
  const int addr = comp * a.n_ctu + (y / ctu_h) * a.w_ctu + x / ctu_w;
  const int typ = __ldg(prm + a.off[kSaoType] + addr);
  const short* v = prm + a.off[kSaoVals] + (size_t)addr * 6;
  const int c = __ldg(plane + i);
  int out = c;
  if (typ != 255) {
    const bool on_x = x > 0 && x < W - 1, on_y = y > 0 && y < H - 1;
    int off;
    bool on;
    if (typ == 4) {
      // band offset: four bands from the CTU's first, wrapping past 31
      const int rel = ((c >> (a.bd - 5)) - __ldg(v)) & 31;
      off = rel < 4 ? __ldg(v + 1 + rel) : 0;
      on = true;
    } else {
      // edge offset: 0, 90, 135, 45 degrees; any other type reads as 0
      // degrees and is trimmed as a diagonal, as the plain version does
      const int k = typ >= 1 && typ <= 3 ? typ : 0;
      const int dy = k == 0 ? 0 : -1;
      const int dx = k == 1 ? 0 : k == 3 ? 1 : -1;
      const int na = __ldg(plane + (size_t)clampi(y + dy, 0, H - 1) * W +
                           clampi(x + dx, 0, W - 1));
      const int nb = __ldg(plane + (size_t)clampi(y - dy, 0, H - 1) * W +
                           clampi(x - dx, 0, W - 1));
      const int da = c - na, db = c - nb;
      const int edge = (da > 0) - (da < 0) + (db > 0) - (db < 0) + 2;
      off = __ldg(v + 1 + edge);
      on = typ == 0 ? on_x : typ == 1 ? on_y : on_x && on_y;
    }
    if (on) out = clampi(c + off, 0, (1 << a.bd) - 1);
  }
  P.out[(size_t)f * H * W + i] = out;
}

// ------------------------------------------------------ ALF and CC-ALF

// The class and transpose index of the 4x4 block (by, bx) from the staged
// luma (_classify_dense): laplacians on the half-sample grid, summed over
// the block's 4x4 (3x4 beside a virtual boundary) cells.
__device__ void classify(const Window& L, int by, int bx, int bd, int vb_h,
                         int vb_pos, int* cls_out, int* tr_out) {
  unsigned part[4][4];  // [direction][half-sample row]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = 4 * by - 2 + 2 * k;
    const bool lo = y > 0 && y % vb_h == vb_pos - 2;
    const bool hi = y > 0 && !lo && y % vb_h == vb_pos;
    const int r0 = hi ? y : y - 1, r1 = y, r2 = y + 1;
    const int r3 = lo ? y + 1 : y + 2;
    unsigned sv = 0, sh = 0, s0 = 0, s1 = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int x = 4 * bx - 2 + 2 * m;
      const unsigned y0v = 2u * L.u(r1, x), yup1 = 2u * L.u(r2, x + 1);
      sv += uabs(y0v - L.u(r0, x) - L.u(r2, x)) +
            uabs(yup1 - L.u(r1, x + 1) - L.u(r3, x + 1));
      sh += uabs(y0v - L.u(r1, x + 1) - L.u(r1, x - 1)) +
            uabs(yup1 - L.u(r2, x + 2) - L.u(r2, x));
      s0 += uabs(y0v - L.u(r0, x - 1) - L.u(r2, x + 1)) +
            uabs(yup1 - L.u(r1, x) - L.u(r3, x + 2));
      s1 += uabs(y0v - L.u(r2, x - 1) - L.u(r0, x + 1)) +
            uabs(yup1 - L.u(r3, x) - L.u(r1, x + 2));
    }
    part[0][k] = sv;
    part[1][k] = sh;
    part[2][k] = s0;
    part[3][k] = s1;
  }
  const int ymod = (4 * by) % vb_h;
  const bool blo = ymod == vb_pos - 4, bhi = ymod == vb_pos;
  int sum[4];
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const unsigned full = part[d][0] + part[d][1] + part[d][2] + part[d][3];
    sum[d] = (int)(blo ? full - part[d][3] : bhi ? full - part[d][0] : full);
  }
  const int sum_v = sum[0], sum_h = sum[1], sum_d0 = sum[2], sum_d1 = sum[3];
  const int shift = bd + 4;
  const unsigned temp_act = (unsigned)sum_v + (unsigned)sum_h;
  const int act = (int)(temp_act * ((blo || bhi) ? 96u : 64u)) >> shift;
  const int act_th[16] = {0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4};
  int cls = act_th[clampi(act, 0, 15)];
  const bool vgh = sum_v > sum_h;
  const int hv1 = vgh ? sum_v : sum_h, hv0 = vgh ? sum_h : sum_v;
  const int dir_hv = vgh ? 1 : 3;
  const bool dgd = sum_d0 > sum_d1;
  const int d1 = dgd ? sum_d0 : sum_d1, d0 = dgd ? sum_d1 : sum_d0;
  const int dir_d = dgd ? 0 : 2;
  const bool dsel = (unsigned)d1 * (unsigned)hv0 > (unsigned)hv1 * (unsigned)d0;
  const int hvd1 = dsel ? d1 : hv1, hvd0 = dsel ? d0 : hv0;
  const int main_dir = dsel ? dir_d : dir_hv, sec_dir = dsel ? dir_hv : dir_d;
  const bool strong = (unsigned)hvd1 * 2u > 9u * (unsigned)hvd0;
  const int strength =
      strong ? 2 : (hvd1 > (int)(2u * (unsigned)hvd0) ? 1 : 0);
  if (strength > 0) cls += (((main_dir & 1) << 1) + strength) * 5;
  const int transpose[8] = {0, 1, 0, 2, 2, 3, 1, 3};
  *cls_out = cls;
  *tr_out = transpose[main_dir * 2 + (sec_dir >> 1)];
}

// One luma tile: stage, classify, filter with the 7x7 diamond.
__device__ void luma_tile(const Args& a, int f, int t, int* smem) {
  const Plane P = a.c[0];
  const int H = P.H, W = P.W;
  const int y0 = (t / a.luma_tiles_x) * kLumaH;
  const int x0 = (t % a.luma_tiles_x) * kLumaW;
  const short* prm = a.flat + (size_t)f * a.stride;
  stage(smem, P.in + (size_t)f * H * W, H, W, y0 - kLumaHalo, x0 - kLumaHalo,
        kLumaSH, kLumaSW);
  const Window L{smem, y0 - kLumaHalo, x0 - kLumaHalo, kLumaSW};
  // per 4x4 block: the bank row's offset, or -1 where the CTU's ALF is off
  int* rows = smem + kLumaSW * kLumaSH;
  __syncthreads();
  const int vb_h = a.ctu, vb_pos = a.ctu - 4;
  if (threadIdx.x < kBlocks) {
    const int by = y0 / 4 + threadIdx.x / kBlocksX;
    const int bx = x0 / 4 + threadIdx.x % kBlocksX;
    int row = -1;
    if (by < H / 4 && bx < W / 4) {
      const int ctu4 = a.ctu >> 2;
      const int addr = (by / ctu4) * a.w_ctu + bx / ctu4;
      if (__ldg(prm + a.off[kEnY] + addr) != 0) {
        int cls, tr;
        classify(L, by, bx, a.bd, vb_h, vb_pos, &cls, &tr);
        const int bank = jidx(__ldg(prm + a.off[kSetCtu] + addr), a.n_banks);
        row = ((bank * 4 + tr) * 25 + cls) * 13;
      }
    }
    rows[threadIdx.x] = row;
  }
  __syncthreads();
  const int ty[12] = {3, 2, 2, 2, 1, 1, 1, 1, 1, 0, 0, 0};
  const int tx[12] = {0, 1, 0, -1, 2, 1, 0, -1, -2, 3, 2, 1};
  const int pel_max = (1 << a.bd) - 1;
  int* out = P.out + (size_t)f * H * W;
  for (int k = threadIdx.x; k < kLumaW * kLumaH; k += kThreads) {
    const int y = y0 + k / kLumaW, x = x0 + k % kLumaW;
    if (y >= H || x >= W) continue;
    const int s = L(y, x);
    const int row = rows[(k / kLumaW / 4) * kBlocksX + (k % kLumaW) / 4];
    int v = s;
    if (row >= 0) {
      const short* co = prm + a.off[kBanksCo] + row;
      const short* cl = prm + a.off[kBanksCl] + row;
      int d[4];
      bool near;
      vb_rows(y, vb_h, vb_pos, false, d, &near);
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int dd = d[ty[j]];
        acc += (unsigned)__ldg(co + j) *
               (unsigned)clip_pair(L(y + dd, x + tx[j]), L(y - dd, x - tx[j]),
                                   s, __ldg(cl + j));
      }
      const int o = near ? (int)(acc + 512u) >> 10 : (int)(acc + 64u) >> 7;
      v = clampi(o + s, 0, pel_max);
    }
    out[(size_t)y * W + x] = v;
  }
}

// One chroma tile of component comp: the 5x5 diamond, then CC-ALF.
__device__ void chroma_tile(const Args& a, int f, int comp, int t,
                            int* smem) {
  const Plane P = plane_of(a, comp), Y = a.c[0];
  const int H = P.H, W = P.W;
  const int sy = a.sub_h - 1, sx = a.sub_w - 1;
  const int y0 = (t / a.chroma_tiles_x) * kChromaH;
  const int x0 = (t % a.chroma_tiles_x) * kChromaW;
  const short* prm = a.flat + (size_t)f * a.stride;
  stage(smem, P.in + (size_t)f * H * W, H, W, y0 - kChromaHalo,
        x0 - kChromaHalo, kChromaSH, kChromaSW);
  const Window C{smem, y0 - kChromaHalo, x0 - kChromaHalo, kChromaSW};
  const int cc_rows = ((kChromaH - 1) << sy) + 4;
  const int cc_cols = ((kChromaW - 1) << sx) + 3;
  const Window Lc{smem + kChromaSW * kChromaSH, (y0 << sy) - 1,
                  (x0 << sx) - 1, cc_cols};
  if (a.cc_on) {
    stage(smem + kChromaSW * kChromaSH, Y.in + (size_t)f * Y.H * Y.W, Y.H,
          Y.W, (y0 << sy) - 1, (x0 << sx) - 1, cc_rows, cc_cols);
  }
  __syncthreads();
  const int k_c = comp - 1;
  const int pel_max = (1 << a.bd) - 1;
  const int ctu_c = a.ctu / a.sub_h;
  const int lc4h = ctu_c >> 2, lc4w = (a.ctu / a.sub_w) >> 2;
  const int ty[6] = {2, 1, 1, 1, 0, 0};
  const int tx[6] = {0, 1, 0, -1, 2, 1};
  int* out = P.out + (size_t)f * H * W;
  for (int k = threadIdx.x; k < kChromaW * kChromaH; k += kThreads) {
    const int y = y0 + k / kChromaW, x = x0 + k % kChromaW;
    if (y >= H || x >= W) continue;
    const int s = C(y, x);
    int v = s;
    if (a.alf_chroma) {
      const int addr = ((y >> 2) / lc4h) * a.w_ctu + (x >> 2) / lc4w;
      if (__ldg(prm + a.off[kEnC] + k_c * a.n_ctu + addr) != 0) {
        const int alt =
            jidx(__ldg(prm + a.off[kAltCtu] + k_c * a.n_ctu + addr), a.n_cb);
        const short* co = prm + a.off[kCBanksCo] + alt * 7;
        const short* cl = prm + a.off[kCBanksCl] + alt * 7;
        int d[4];
        bool near;
        vb_rows(y, ctu_c, ctu_c - 2, true, d, &near);
        unsigned acc = 0;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const int dd = d[ty[j]];
          acc += (unsigned)__ldg(co + j) *
                 (unsigned)clip_pair(C(y + dd, x + tx[j]),
                                     C(y - dd, x - tx[j]), s, __ldg(cl + j));
        }
        const int o = near ? (int)(acc + 512u) >> 10 : (int)(acc + 64u) >> 7;
        v = clampi(o + s, 0, pel_max);
      }
    }
    if (a.cc_on) {
      const int ly = y << sy, lx = x << sx;
      const int addr = (y / (a.ctu >> sy)) * a.w_ctu + x / (a.ctu >> sx);
      const int cidx = __ldg(prm + a.off[kCcCtu] + k_c * a.n_ctu + addr);
      const int vb_pos = a.ctu - 4, pos = ly & (a.ctu - 1);
      const bool skip = sy == 0 && (pos == vb_pos || pos == vb_pos + 1);
      if (cidx != 0 && !skip) {
        unsigned acc = 0;
        if (cidx >= 1 && cidx < a.n_cc) {
          const bool rz = pos == vb_pos - 1 || pos == vb_pos;
          const bool r31 = pos == vb_pos - 2 || pos == vb_pos + 1;
          const int up = rz ? 0 : -1, dn = rz ? 0 : 1;
          const int dn2 = rz ? 0 : r31 ? 1 : 2;
          const short* cf = prm + a.off[kCcBanks] + cidx * 7;
          const unsigned cur = Lc.u(ly, lx);
          acc = (unsigned)__ldg(cf + 0) * (Lc.u(ly + up, lx) - cur) +
                (unsigned)__ldg(cf + 1) * (Lc.u(ly, lx - 1) - cur) +
                (unsigned)__ldg(cf + 2) * (Lc.u(ly, lx + 1) - cur) +
                (unsigned)__ldg(cf + 3) * (Lc.u(ly + dn, lx - 1) - cur) +
                (unsigned)__ldg(cf + 4) * (Lc.u(ly + dn, lx) - cur) +
                (unsigned)__ldg(cf + 5) * (Lc.u(ly + dn, lx + 1) - cur) +
                (unsigned)__ldg(cf + 6) * (Lc.u(ly + dn2, lx) - cur);
        }
        const int half = (1 << a.bd) >> 1;
        const int corr = clampi(((int)(acc + 64u) >> 7) + half, 0, pel_max) -
                         half;
        v = clampi(corr + v, 0, pel_max);
      }
    }
    out[(size_t)y * W + x] = v;
  }
}

__global__ void __launch_bounds__(kThreads) alf_ccalf_kernel(Args a) {
  __shared__ int smem[kSmem];
  const int f = blockIdx.z;
  const int t = blockIdx.x;
  if (t < a.luma_tiles) {
    luma_tile(a, f, t, smem);
  } else {
    const int c = t - a.luma_tiles;
    chroma_tile(a, f, 1 + c / a.chroma_tiles, c % a.chroma_tiles, smem);
  }
}

}  // namespace

// planes: host array of 3 x 4 int64, per component {in pointer, out
// pointer, H, W} (absent components: zeros), the planes int32 [F, H, W];
// flat: device int16 [F, stride], the uploaded parameter vectors; off:
// host array of the 12 field offsets (Field's order; -1 where absent);
// stage 0 runs SAO on every component, stage 1 ALF on luma (alf_luma)
// and ALF and CC-ALF on both chroma planes (alf_chroma or cc_on, and
// three components).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int sao_alf_launch(const long long* planes, int num_comp, int F,
                              const void* flat, long long stride,
                              const long long* off, int bd, int ctu,
                              int sub_w, int sub_h, int w_ctu, int n_ctu,
                              int n_banks, int n_cb, int n_cc, int alf_luma,
                              int alf_chroma, int cc_on, int stage,
                              void* stream) {
  if (F <= 0 || num_comp <= 0) return 0;
  Args a;
  long long most = 0;
  for (int c = 0; c < 3; ++c) {
    const long long* d = planes + 4 * c;
    a.c[c] = {reinterpret_cast<const int*>(d[0]), reinterpret_cast<int*>(d[1]),
              (int)d[2], (int)d[3]};
    if (c < num_comp && d[2] * d[3] > most) most = d[2] * d[3];
  }
  a.flat = static_cast<const short*>(flat);
  a.stride = stride;
  for (int k = 0; k < kFields; ++k) a.off[k] = (int)off[k];
  a.bd = bd;
  a.ctu = ctu;
  a.sub_w = sub_w;
  a.sub_h = sub_h;
  a.w_ctu = w_ctu;
  a.n_ctu = n_ctu;
  a.n_banks = n_banks;
  a.n_cb = n_cb;
  a.n_cc = n_cc;
  a.alf_luma = alf_luma;
  a.alf_chroma = alf_chroma;
  a.cc_on = cc_on;
  a.luma_tiles_x = (a.c[0].W + kLumaW - 1) / kLumaW;
  a.luma_tiles =
      alf_luma ? a.luma_tiles_x * ((a.c[0].H + kLumaH - 1) / kLumaH) : 0;
  const bool chroma = num_comp > 1 && (alf_chroma || cc_on);
  a.chroma_tiles_x = chroma ? (a.c[1].W + kChromaW - 1) / kChromaW : 1;
  a.chroma_tiles =
      chroma ? a.chroma_tiles_x * ((a.c[1].H + kChromaH - 1) / kChromaH) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    if (most == 0) return 0;
    const dim3 grid((unsigned)((most + kThreads - 1) / kThreads),
                    (unsigned)num_comp, (unsigned)F);
    sao_kernel<<<grid, kThreads, 0, s>>>(a);
  } else {
    const long long blocks = a.luma_tiles + 2LL * a.chroma_tiles;
    if (blocks == 0) return 0;
    alf_ccalf_kernel<<<dim3((unsigned)blocks, 1, (unsigned)F), kThreads, 0,
                       s>>>(a);
  }
  return (int)cudaGetLastError();
}
