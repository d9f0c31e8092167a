"""Numpy golden LMCS (luma mapping with chroma scaling).

Behavioral parity (re-designed, not ported):
  - model build:     Reshape::constructReshaper (Reshape.cpp:316)
  - forward map:     rspFwdCore (Buffer.cpp:321)
  - inverse map:     inverse LUT build (Reshape.cpp:371-376) applied per
                     CTU in the RSP stage (rspCtuBcw :377)
  - chroma scaling:  Reshape::calculateChromaAdjVpduNei (Reshape.cpp:190),
                     getPWLIdxInv (:281), AreaBuf::scaleSignal
                     (Buffer.cpp:412)
"""

from __future__ import annotations

import numpy as np

PIC_CODE_CW_BINS = 16
FP_PREC = 11
CSCALE_FP_PREC = 11


class Reshaper:
    """Per-picture LMCS model (fwd/inv piecewise-linear maps + chroma
    scaling LUT) built from an LMCS APS."""

    def __init__(self, info, bit_depth: int, chroma_adj_enabled: bool):
        self.bd = bit_depth
        self.chroma_adj_enabled = chroma_adj_enabled
        self.min_bin = info.min_bin_idx
        self.max_bin = info.max_bin_idx
        lut_size = 1 << bit_depth
        init_cw = lut_size // PIC_CODE_CW_BINS
        self.init_cw = init_cw
        bin_cw = [0] * PIC_CODE_CW_BINS
        for i in range(info.min_bin_idx, info.max_bin_idx + 1):
            bin_cw[i] = info.cw_delta[i] + init_cw
        self.bin_cw = bin_cw
        self.reshape_pivot = [0] * (PIC_CODE_CW_BINS + 1)
        self.input_pivot = [0] * (PIC_CODE_CW_BINS + 1)
        self.fwd_scale = [0] * PIC_CODE_CW_BINS
        self.inv_scale = [0] * PIC_CODE_CW_BINS
        self.chroma_adj_lut = [0] * PIC_CODE_CW_BINS
        log2_bin = init_cw.bit_length() - 1
        for i in range(PIC_CODE_CW_BINS):
            self.reshape_pivot[i + 1] = self.reshape_pivot[i] + bin_cw[i]
            self.input_pivot[i + 1] = self.input_pivot[i] + init_cw
            self.fwd_scale[i] = (bin_cw[i] * (1 << FP_PREC)
                                 + (1 << (log2_bin - 1))) >> log2_bin
            if bin_cw[i] == 0:
                self.inv_scale[i] = 0
                self.chroma_adj_lut[i] = 1 << CSCALE_FP_PREC
            else:
                self.inv_scale[i] = (init_cw * (1 << FP_PREC)) // bin_cw[i]
                self.chroma_adj_lut[i] = (init_cw * (1 << FP_PREC)) \
                    // (bin_cw[i] + info.crs_offset)
        # inverse LUT over the full sample range
        samples = np.arange(lut_size)
        idx = self._pwl_idx_inv_vec(samples)
        piv = np.array(self.reshape_pivot[:PIC_CODE_CW_BINS], dtype=np.int64)
        ipiv = np.array(self.input_pivot[:PIC_CODE_CW_BINS], dtype=np.int64)
        isc = np.array(self.inv_scale, dtype=np.int64)
        inv = ipiv[idx] + ((isc[idx] * (samples - piv[idx])
                            + (1 << (FP_PREC - 1))) >> FP_PREC)
        self.inv_lut = np.clip(inv, 0, lut_size - 1).astype(np.int32)
        # per-VPDU chroma-scale cache
        self._vpdu_cache: dict[tuple[int, int], int] = {}

    def _pwl_idx_inv_vec(self, vals: np.ndarray) -> np.ndarray:
        """Vectorized getPWLIdxInv: first bin in [min,max] whose next pivot
        exceeds the value; min(idx, 15)."""
        piv = np.array(self.reshape_pivot, dtype=np.int64)
        idx = np.full(vals.shape, self.min_bin, dtype=np.int64)
        # idxS walks while lumaVal >= pivot[idxS+1]
        for i in range(self.min_bin, self.max_bin + 1):
            idx = np.where((idx == i) & (vals >= piv[i + 1]), i + 1, idx)
        return np.minimum(idx, PIC_CODE_CW_BINS - 1)

    def pwl_idx_inv(self, v: int) -> int:
        for i in range(self.min_bin, self.max_bin + 1):
            if v < self.reshape_pivot[i + 1]:
                return min(i, PIC_CODE_CW_BINS - 1)
        return min(self.max_bin + 1, PIC_CODE_CW_BINS - 1)

    def fwd_map(self, arr: np.ndarray) -> np.ndarray:
        """rspFwdCore: forward (original -> reshaped) mapping."""
        shift = self.init_cw.bit_length() - 1
        a = arr.astype(np.int64)
        idx = a >> shift
        piv = np.array(self.reshape_pivot[:PIC_CODE_CW_BINS], dtype=np.int64)
        ipiv = np.array(self.input_pivot[:PIC_CODE_CW_BINS], dtype=np.int64)
        fsc = np.array(self.fwd_scale, dtype=np.int64)
        out = piv[idx] + ((fsc[idx] * (a - ipiv[idx]) + (1 << 10)) >> 11)
        return np.clip(out, 0, (1 << self.bd) - 1)

    def inv_map(self, arr: np.ndarray) -> np.ndarray:
        return self.inv_lut[arr.astype(np.int64)]

    def scale_signal(self, resi: np.ndarray, scale_inv: int) -> np.ndarray:
        """AreaBuf::scaleSignal (Buffer.cpp:412)."""
        max_abs = (1 << self.bd) - 1
        r = np.clip(resi.astype(np.int64), -max_abs - 1, max_abs)
        sign = np.where(r >= 0, 1, -1)
        val = sign * ((sign * r * scale_inv + (1 << (CSCALE_FP_PREC - 1)))
                      >> CSCALE_FP_PREC)
        return np.clip(val, -32768, 32767)

    def chroma_adj_vpdu(self, recon, cs, luma_x: int, luma_y: int) -> int:
        """calculateChromaAdjVpduNei (Reshape.cpp:190): chroma residual
        scale for the VPDU containing luma pos, from the reconstructed
        (reshaped-domain) luma above/left of the VPDU's top-left CU."""
        ctu = cs.sps.ctu_size
        num_nb = min(64, ctu)
        mask = 63 if ctu == 128 else (ctu - 1)
        vx = luma_x & ~mask
        vy = luma_y & ~mask
        key = (vx, vy)
        if key in self._vpdu_cache:
            return self._vpdu_cache[key]
        top_left = cs.cu_at(vx, vy, 0)
        x_pos, y_pos = top_left.x, top_left.y
        cu_above = cs.cu_at_restricted(x_pos, y_pos - 1, top_left, 0)
        cu_left = cs.cu_at_restricted(x_pos - 1, y_pos, top_left, 0)
        reco_y = recon[0]
        rec_sum = 0
        pelnum = 0
        if cu_left is not None:
            for i in range(num_nb):
                k = (cs.h - y_pos - 1) if (y_pos + i) >= cs.h else i
                rec_sum += int(reco_y[y_pos + k, x_pos - 1])
            pelnum += num_nb
        if cu_above is not None:
            for i in range(num_nb):
                k = (cs.w - x_pos - 1) if (x_pos + i) >= cs.w else i
                rec_sum += int(reco_y[y_pos - 1, x_pos + k])
            pelnum += num_nb
        log_nb = num_nb.bit_length() - 1
        if pelnum == num_nb:
            luma_val = (rec_sum + (1 << (log_nb - 1))) >> log_nb
        elif pelnum == 2 * num_nb:
            luma_val = (rec_sum + (1 << log_nb)) >> (log_nb + 1)
        else:
            luma_val = 1 << (self.bd - 1)
        scale = self.chroma_adj_lut[self.pwl_idx_inv(luma_val)]
        self._vpdu_cache[key] = scale
        return scale
