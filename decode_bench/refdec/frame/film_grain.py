"""FGC-SEI-driven film grain synthesis (output side) — exact VFGS model.

Bit-exact port of the reference's VFGS hardware model
(source/Lib/FilmGrain/FilmGrain.cpp + FilmGrainImpl.cpp, based on
InterDigital VersatileFilmGrain / RDD-5):

  - frequency-filtered 64x64 luma / 32x32 chroma grain patterns built from
    the fixed Gaussian LUT through an exact integer iDCT2
    (make_sei_ff_pattern64/32), or AR-filtered patterns for model_id 1
    (make_ar_pattern)
  - per-intensity-interval pattern/scale LUTs with dedup + hole filling
    (FilmGrain::init_sei)
  - per-16x16-block seed stream continuing across frames in output order
    (prepareBlockSeeds, prng), random pattern offsets and sign flips per
    block with 2-line vertical overlap blending and horizontal deblocking
    between blocks (FilmGrainImpl::add_grain_block)

The per-line pixel pipeline is vectorized over the blocks of a line; all
arithmetic is the model's integer arithmetic.
"""

from __future__ import annotations

import os

import numpy as np

_T = np.load(os.path.join(os.path.dirname(__file__), "..", "ops",
                          "tables_vfgs.npz"))
GAUSSIAN_LUT = _T["GAUSSIAN_LUT"].astype(np.int32)   # [2048]
SEED_LUT = _T["SEED_LUT"].astype(np.uint32)          # [256]

VFGS_MAX_PATTERNS = 8
SEI_MAX_MODEL_VALUES = 6


def _prng(x: int) -> int:
    """32-bit PRNG, bit-reversed RDD-5 (FilmGrainImpl.h:71)."""
    x &= 0xFFFFFFFF
    s = ((x << 30) ^ (x << 2)) & 0x80000000
    return (s | (x >> 1)) & 0xFFFFFFFF


def _round(a, s):
    return (a + (1 << (s - 1))) >> s


def _dct2_64() -> np.ndarray:
    from refdec.ops.tables import tr_matrix
    return tr_matrix("DCT2", 64).astype(np.int32)


def _idct2(B: np.ndarray) -> np.ndarray:
    """Exact integer iDCT2 with clipping (idct2_64 / idct2_32)."""
    n = B.shape[0]
    D = _dct2_64() if n == 64 else _dct2_64()[::2, :32]
    s1, o1 = (9, 256) if n == 64 else (8, 128)
    # pass 1 (vertical): X[j][i] = (256 + sum_k D[k][j] * B[k][i]) >> s1
    X = (D.T.astype(np.int64) @ B.astype(np.int64) + o1) >> s1
    X = X.astype(np.int64)
    # pass 2 (horizontal) + clip
    R = (X @ D.astype(np.int64) + 256) >> 9
    return np.clip(R, -127, 127).astype(np.int8)


def _make_sei_ff_pattern(size: int, fh: int, fv: int) -> np.ndarray:
    """make_sei_ff_pattern64/32 (FilmGrain.cpp:405,432)."""
    step = 4 if size == 64 else 2
    fh = step * (fh + 1)
    fv = step * (fv + 1)
    n = int(SEED_LUT[0 if size == 64 else 1])
    B = np.zeros((size, size), dtype=np.int32)
    for l in range(size):
        for k in range(0, size, step):
            if k < fh and l < fv:
                for d in range(step):
                    B[l][k + d] = GAUSSIAN_LUT[(n + d) & 2047]
            n = _prng(n)
    B[0][0] = 0
    return _idct2(B)


def _make_ar_pattern(size: int, ar_coef, scale: int, seed: int) -> np.ndarray:
    """make_ar_pattern (FilmGrain.cpp:457), nb_coef == 6, shift == 1."""
    shift = 1
    coef = np.zeros((4, 7), dtype=np.int64)
    coef[3][2] = ar_coef[1]
    coef[2][3] = (ar_coef[1] * ar_coef[4]) >> scale
    coef[2][2] = (ar_coef[3] * ar_coef[4]) >> scale
    coef[2][4] = (ar_coef[3] * ar_coef[4]) >> scale
    coef[3][1] = ar_coef[5]
    coef[1][3] = (ar_coef[5] * ar_coef[4] * ar_coef[4]) >> (2 * scale)

    subx = suby = 2 if size == 32 else 1
    width = 44 if subx > 1 else 82
    height = 38 if suby > 1 else 73
    buf = np.zeros((height, width), dtype=np.int64)
    rnd = seed
    for y in range(height):
        for x in range(width):
            g = 0
            if y >= 3 and x >= 3 and x < width - 3:
                for j in range(-3, 1):
                    for i in range(-3, 4):
                        if i >= 0 and j >= 0:
                            break
                        g += int(coef[3 + j][3 + i]) * int(buf[y + j][x + i])
                g = _round(g, scale)
            g += _round(int(GAUSSIAN_LUT[rnd & 2047]), shift)
            rnd = _prng(rnd)
            buf[y][x] = max(-127, min(127, g))
    P = np.zeros((size, size), dtype=np.int8)
    oy = 3 + 6 // suby
    ox = 3 + 6 // subx
    P[: 64 // suby, : 64 // subx] = buf[oy: oy + 64 // suby,
                                        ox: ox + 64 // subx]
    return P


class FilmGrainSynthesizer:
    """Stateful VFGS synthesizer — the FilmGrain + FilmGrainImpl pair.

    One instance per decoder; grain seeds evolve across frames in output
    order (FilmGrain::prepareBlockSeeds member state)."""

    def __init__(self) -> None:
        # hw state
        self.pattern = np.zeros((2, VFGS_MAX_PATTERNS + 1, 64, 64),
                                dtype=np.int16)
        self.sLUT = np.zeros((3, 256), dtype=np.uint8)
        self.pLUT = np.zeros((3, 256), dtype=np.uint8)
        self.scale_shift = 5 + 6
        self.bs = 0
        self.csubx = 2
        self.csuby = 2
        # fw state
        self._line_rnd = 0xDEADBEEF
        self._line_rnd_up = 0xDEADBEEF
        self._prev_frame_line_rnd_up = 0xDEADBEEF
        self._line_seeds: list[int] = []
        self.fgs = None  # dict mirror of the fgs_sei struct

    # ---------------- fw: SEI -> hw state ----------------
    def update_fgc(self, fgc) -> None:
        """FilmGrain::updateFGC + init_sei."""
        cmv = np.zeros((3, 256, SEI_MAX_MODEL_VALUES), dtype=np.int64)
        present = [False, False, False]
        n_int = [0, 0, 0]
        model_id = fgc.model_id
        lsf = fgc.log2_scale_factor
        lower = np.zeros((3, 256), dtype=np.int32)
        upper = np.zeros((3, 256), dtype=np.int32)
        for c in range(3):
            cm = fgc.comp_model[c]
            if not cm.present:
                continue
            present[c] = True
            n_int[c] = len(cm.intervals)
            for i, (lo, hi, vals) in enumerate(cm.intervals):
                lower[c][i] = lo
                upper[c][i] = hi
                nv = len(vals)
                for v in range(nv):
                    cmv[c][i][v] = vals[v]
                # default model values (switch fallthrough, FilmGrain.cpp)
                if nv <= 1:
                    cmv[c][i][1] = 0 if model_id else 8
                if nv <= 2:
                    cmv[c][i][2] = 0 if model_id else cmv[c][i][1]
                if nv <= 3:
                    cmv[c][i][3] = 0
                if nv <= 4:
                    cmv[c][i][4] = model_id << lsf
                    cmv[c][i][5] = 0
        # 4:2:0 conversion of chroma model values (model 0)
        if model_id == 0:
            for c in (1, 2):
                if present[c]:
                    for k in range(n_int[c]):
                        cmv[c][k][1] = max(2, min(14, int(cmv[c][k][1]) << 1))
                        cmv[c][k][2] = max(2, min(14, int(cmv[c][k][2]) << 1))
                        cmv[c][k][0] >>= 1
        self.fgs = dict(model_id=model_id, log2_scale_factor=lsf,
                        present=present, n_int=n_int, cmv=cmv,
                        lower=lower, upper=upper)
        self._init_sei()

    def _same_pattern(self, a, b) -> bool:
        """Compare model values [1..5] of two flat interval ids."""
        cmv = self.fgs["cmv"].reshape(-1)
        for i in range(1, SEI_MAX_MODEL_VALUES):
            if cmv[a + i] != cmv[b + i]:
                return False
        return True

    def _init_sei(self) -> None:
        fgs = self.fgs
        cmv = fgs["cmv"]
        flat = cmv.reshape(-1)
        np_ = 0
        intensities = [0] * VFGS_MAX_PATTERNS
        patterns = [-1] * VFGS_MAX_PATTERNS
        all0 = 1
        for c in range(3):
            slut = np.zeros(256, dtype=np.uint8)
            if c < 2:
                np_ = 0
                intensities = [0] * VFGS_MAX_PATTERNS
                patterns = [-1] * VFGS_MAX_PATTERNS
            # 1. collect distinct patterns, sorted by intensity
            if fgs["present"][c]:
                for k in range(fgs["n_int"][c]):
                    a = int(fgs["lower"][c][k])
                    pid = SEI_MAX_MODEL_VALUES * (k + 256 * c)
                    i = 0
                    while i < VFGS_MAX_PATTERNS:
                        if patterns[i] >= 0 \
                                and self._same_pattern(patterns[i], pid):
                            break
                        i += 1
                    if i == VFGS_MAX_PATTERNS and np_ < VFGS_MAX_PATTERNS:
                        i = np_
                        while i > 0:
                            if intensities[i - 1] > a:
                                intensities[i] = intensities[i - 1]
                                patterns[i] = patterns[i - 1]
                                i -= 1
                            else:
                                break
                        intensities[i] = a
                        patterns[i] = pid
                        np_ += 1
            if c == 0 or c == 2:
                # 2. register patterns
                for i in range(np_):
                    coef = flat[patterns[i]: patterns[i]
                                + SEI_MAX_MODEL_VALUES]
                    if c == 0:
                        if fgs["model_id"]:
                            P = _make_ar_pattern(
                                64, coef, fgs["log2_scale_factor"],
                                int(SEED_LUT[0]))
                        else:
                            P = _make_sei_ff_pattern(64, int(coef[1]),
                                                     int(coef[2]))
                        self.pattern[0][i][:64, :64] = P
                    else:
                        if fgs["model_id"]:
                            P = _make_ar_pattern(
                                32, coef, fgs["log2_scale_factor"],
                                int(SEED_LUT[1]))
                        else:
                            P = _make_sei_ff_pattern(32, int(coef[1]),
                                                     int(coef[2]))
                        # set_chroma_pattern: rows of width 64/csubx
                        self.pattern[1][i] = 0
                        rw = 64 // self.csubx
                        flatP = np.asarray(P, dtype=np.int16).reshape(-1)
                        rh = 64 // self.csuby
                        src = 64 // self.csuby
                        for r in range(rh):
                            row = flatP[src * r: src * r + rw]
                            self.pattern[1][i][r][: len(row)] = row
                # 3. fill LUTs
                for cc in range(min(c, 1), c + 1):
                    plut = np.full(256, 255, dtype=np.int32)
                    if fgs["present"][cc]:
                        for k in range(fgs["n_int"][cc]):
                            a = int(fgs["lower"][cc][k])
                            b = int(fgs["upper"][cc][k])
                            pid = SEI_MAX_MODEL_VALUES * (k + 256 * cc)
                            i = 0
                            while i < VFGS_MAX_PATTERNS:
                                if patterns[i] >= 0 and self._same_pattern(
                                        patterns[i], pid):
                                    break
                                i += 1
                            for level in range(a, b + 1):
                                slut[level] = int(cmv[cc][k][0]) & 0xFF
                                if i < VFGS_MAX_PATTERNS:
                                    plut[level] = i << 4
                        # fill holes: repeat last
                        i = 0
                        tmp = 0
                        for k in range(256):
                            if plut[k] == 255:
                                plut[k] = i
                            else:
                                i = int(plut[k])
                            tmp += int(plut[k])
                        if tmp != 0:
                            all0 = 0
                    else:
                        plut[:] = 0
                        all0 = 1
                    self.sLUT[cc] = slut
                    self.pLUT[cc] = plut.astype(np.uint8)
        self.scale_shift = (fgs["log2_scale_factor"]
                            - (1 if fgs["model_id"] else 0)) + 6 - self.bs

    # ---------------- per-frame setup ----------------
    def set_depth(self, depth: int) -> None:
        if self.bs == 0 and depth > 8:
            self.scale_shift -= 2
        if self.bs == 2 and depth == 8:
            self.scale_shift += 2
        self.bs = depth - 8

    def set_color_format(self, chroma_format_idc: int) -> None:
        self.csubx, self.csuby = {0: (0, 0), 1: (2, 2), 2: (2, 1),
                                  3: (1, 1)}[chroma_format_idc]

    def prepare_block_seeds(self, width: int, height: int) -> None:
        n_rows = (height + 15) // 16
        self._prev_frame_line_rnd_up = self._line_rnd_up
        self._line_seeds = [0] * n_rows
        rnd = 0
        for y in range(n_rows):
            if y != 0:
                self._line_rnd_up = self._line_rnd
                self._line_rnd = rnd
            self._line_seeds[y] = self._line_rnd
            rnd = self._line_rnd
            for _ in range((width + 15) // 16):
                rnd = _prng(rnd)

    # ---------------- hw: grain application ----------------
    @staticmethod
    def _rnd_chain(seed: int, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint64)
        r = seed
        for i in range(n):
            out[i] = r
            r = _prng(r)
        return out

    @staticmethod
    def _offsets(rnds: np.ndarray, c: int, csubx: int, csuby: int):
        """get_offset_y/u/v vectorized over blocks; returns (s, ox, oy)."""
        r = rnds
        if c == 0:
            s = np.where((r >> 31) & 1, -1, 1).astype(np.int64)
            ox = (((r >> 0) & 0x3FF) * 13 >> 10) * 4
            oy = (((r >> 14) & 0x3FF) * 12 >> 10) * 4
        elif c == 1:
            s = np.where((r >> 2) & 1, -1, 1).astype(np.int64)
            ox = (((r >> 10) & 0x3FF) * 13 >> 10) * (4 // csubx)
            bf = ((r >> 24) & 0x0FF) | ((r << 8) & 0x300)
            oy = ((bf * 12) >> 10) * (4 // csuby)
        else:
            s = np.where((r >> 15) & 1, -1, 1).astype(np.int64)
            ox = (((r >> 20) & 0x3FF) * 13 >> 10) * (4 // csubx)
            oy = (((r >> 4) & 0x3FF) * 12 >> 10) * (4 // csuby)
        return s, ox.astype(np.int64), oy.astype(np.int64)

    def _grain_line(self, line: np.ndarray, c: int, y: int,
                    rnds: np.ndarray, rnds_up: np.ndarray) -> np.ndarray:
        """Grain for one component line; returns the updated line."""
        subx = self.csubx if c else 1
        suby = self.csuby if c else 1
        nblk = len(rnds)
        bw = 16 // subx
        j = y & 0xF
        if y > 15 and j == 0:
            oc1, oc2 = (20, 20) if suby > 1 else (12, 24)
        elif y > 15 and j == 1:
            oc1, oc2 = 24, 12
        else:
            oc1 = oc2 = 0

        s, ox, oy = self._offsets(rnds, c, self.csubx, self.csuby)
        s_up, ox_up, oy_up = self._offsets(rnds_up, c, self.csubx,
                                           self.csuby)
        oy = oy + j // suby
        oy_up = oy_up + (16 + j) // suby

        w = len(line)
        total = nblk * bw
        # intensity per pixel (edge-clamped for partial last block)
        pix_idx = np.minimum(np.arange(total), w - 1)
        vals = line[pix_idx].astype(np.int64)
        intensity = (vals >> self.bs).astype(np.int64)
        intensity = np.clip(intensity, 0, 255)
        pi = (self.pLUT[c][intensity] >> 4).astype(np.int64)
        scale = self.sLUT[c][intensity].astype(np.int64)

        cidx = 1 if c else 0
        cols = np.tile(np.arange(bw, dtype=np.int64), nblk)
        blk = np.repeat(np.arange(nblk, dtype=np.int64), bw)
        P = self.pattern[cidx][pi, oy[blk], ox[blk] + cols].astype(np.int64)
        P = P * s[blk]
        if oc1:
            Pu = self.pattern[cidx][pi, oy_up[blk],
                                    ox_up[blk] + cols].astype(np.int64)
            P = _round(P * oc1 + Pu * oc2 * s_up[blk], 5)
        grain = P

        # horizontal deblock across block seams (scale_and_output)
        if nblk > 1:
            g = grain
            seams = np.arange(1, nblk) * bw
            l1 = g[seams - 2]
            l0 = g[seams - 1]
            r0 = g[seams]
            r1 = g[seams + 1]
            g[seams - 1] = _round(l1 + 3 * l0 + r0, 2)
            g[seams] = _round(l0 + 3 * r0 + r1, 2)

        add = _round(scale * grain, self.scale_shift)
        lo = 0
        hi = 255 << self.bs
        new = np.clip(vals + add, lo, hi)
        res = line.copy()
        res[: min(w, total)] = new[: min(w, total)].astype(line.dtype)
        return res

    def apply(self, planes: list, bit_depth: int,
              chroma_format_idc: int) -> list:
        """VVDecImpl::xAddGrain for one output frame (in output order)."""
        if self.fgs is None:
            return planes
        self.set_depth(bit_depth)
        self.set_color_format(chroma_format_idc)
        h, w = planes[0].shape
        self.prepare_block_seeds(w, h)
        out = [p.copy() for p in planes]
        nblk = (w + 15) // 16
        has_chroma = chroma_format_idc != 0 and len(planes) > 1
        suby = self.csuby if has_chroma else 1
        for y in range(h):
            rnd_up0 = self._prev_frame_line_rnd_up if y < 16 \
                else self._line_seeds[y // 16 - 1]
            rnd0 = self._line_seeds[y // 16]
            rnds = self._rnd_chain(rnd0, nblk)
            rnds_up = self._rnd_chain(rnd_up0, nblk)
            if self.fgs["present"][0]:
                out[0][y] = self._grain_line(out[0][y], 0, y, rnds, rnds_up)
            if has_chroma and not ((y & 1) and suby > 1):
                cy = y // suby
                if cy < out[1].shape[0]:
                    if self.fgs["present"][1]:
                        out[1][cy] = self._grain_line(out[1][cy], 1, y,
                                                      rnds, rnds_up)
                    if self.fgs["present"][2]:
                        out[2][cy] = self._grain_line(out[2][cy], 2, y,
                                                      rnds, rnds_up)
        return out
