"""VVC CABAC arithmetic-coding engine: context models, decoder, encoder.

The decoder implements the H.266 clause 9.3 arithmetic decoding process with
the two-window adaptive probability model.  Behavioral parity: vvdec
BinDecoder (source/Lib/DecoderLib/BinDecoder.cpp:81-384) and BinProbModel
(source/Lib/CommonLib/Contexts.h:71-150) — every arithmetic operation here is
bit-identical to the standard.  The encoder is the standard's dual, used by
the test bitstream generator; decoder/encoder round-trip tests plus decoding
via the reference binary pin both down.

This pure-Python engine is the reference implementation; the production hot
path lives in the C extension (refdec/native) with identical semantics.
"""

from __future__ import annotations

import numpy as np

from refdec.cabac import ctx_tables

PROB_BITS = 15
MASK_0 = ((0xFFFFFFFF << 5) & 0x7FFF) & ~(~0 << PROB_BITS)  # bits 5..14
MASK_1 = ((0xFFFFFFFF << 1) & 0x7FFF)

RENORM_TABLE_32 = bytes([
    6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
])

NUM_CTX = ctx_tables.NUM_CTX

# slice-type init table selection: tables are ordered [B, P, I]
INIT_TABLES = (ctx_tables.INIT_B, ctx_tables.INIT_P, ctx_tables.INIT_I)


class CtxState:
    """All 372 context models as flat arrays (vectorized init, scalar update).

    state0: 10-bit estimate stored in 15-bit scale (multiple of 32)
    state1: 14-bit estimate stored in 15-bit scale (multiple of 2)
    """

    __slots__ = ("state0", "state1", "rate0", "rate1", "d00", "d10")

    def __init__(self) -> None:
        self.state0 = np.zeros(NUM_CTX, dtype=np.int32)
        self.state1 = np.zeros(NUM_CTX, dtype=np.int32)
        self.rate0 = np.zeros(NUM_CTX, dtype=np.int32)
        self.rate1 = np.zeros(NUM_CTX, dtype=np.int32)
        self.d00 = np.zeros(NUM_CTX, dtype=np.int32)  # delta0[bin==0]
        self.d10 = np.zeros(NUM_CTX, dtype=np.int32)  # delta1[bin==0]

    def init(self, qp: int, init_id: int) -> None:
        """init_id: 0=B, 1=P, 2=I table."""
        qp = max(0, min(63, qp))
        init = np.frombuffer(INIT_TABLES[init_id], dtype=np.uint8).astype(np.int32)
        rates = np.frombuffer(ctx_tables.RATES, dtype=np.uint8).astype(np.int32)
        slope = (init >> 3) - 4
        offset = (init & 7) * 18 + 1
        inistate = ((slope * (qp - 16)) >> 1) + offset
        state_clip = np.clip(inistate, 1, 127)
        p1 = state_clip << 8
        self.state0 = (p1 & MASK_0).astype(np.int32)
        self.state1 = (p1 & MASK_1).astype(np.int32)
        r0 = 2 + ((rates >> 2) & 3)
        r1 = 3 + r0 + (rates & 3)
        self.rate0 = r0 + 5
        self.rate1 = r1 + 1
        self.d00 = (0xFFFF >> (16 - self.rate0)).astype(np.int32)
        self.d10 = (0xFFFF >> (16 - self.rate1)).astype(np.int32)

    def copy(self) -> "CtxState":
        c = CtxState.__new__(CtxState)
        c.state0 = self.state0.copy()
        c.state1 = self.state1.copy()
        c.rate0 = self.rate0.copy()
        c.rate1 = self.rate1.copy()
        c.d00 = self.d00.copy()
        c.d10 = self.d10.copy()
        return c

    # -- scalar per-context ops (hot path; ported to C later) --------------
    def lps_mps(self, ctx: int, rng: int) -> tuple[int, int]:
        q = (int(self.state0[ctx]) + int(self.state1[ctx])) >> 8
        mps = q >> 7
        qs = (q ^ 0xFF) if mps else q
        lps = ((qs >> 2) * (rng >> 5) >> 1) + 4
        return lps, mps

    def update(self, ctx: int, bin_val: int) -> None:
        s0 = int(self.state0[ctx])
        s1 = int(self.state1[ctx])
        if bin_val:
            d0 = 0x7FFF
            d1 = 0x7FFF
        else:
            d0 = int(self.d00[ctx])
            d1 = int(self.d10[ctx])
        self.state0[ctx] = s0 + ((d0 - s0) >> int(self.rate0[ctx])) * 32
        self.state1[ctx] = s1 + ((d1 - s1) >> int(self.rate1[ctx])) * 2


class CabacDecoder:
    """Arithmetic decoder over an RBSP byte range."""

    __slots__ = ("data", "pos", "end", "range", "value", "bits_needed", "ctx")

    def __init__(self, data: bytes, start_byte: int = 0, end_byte: int | None = None):
        self.data = data
        self.pos = start_byte
        self.end = len(data) if end_byte is None else end_byte
        self.ctx = CtxState()
        self.range = 510
        self.value = 0
        self.bits_needed = -8

    def _read_byte(self) -> int:
        if self.pos >= self.end:
            self.pos += 1
            return 0
        b = self.data[self.pos]
        self.pos += 1
        return b

    def start(self) -> None:
        self.range = 510
        self.value = (self._read_byte() << 8) + self._read_byte()
        self.bits_needed = -8

    def reset(self, qp: int, init_id: int) -> None:
        self.ctx.init(qp, init_id)
        self.start()

    def restart(self, start_byte: int, end_byte: int | None = None) -> None:
        """Re-init the arithmetic engine at a new substream entry point
        (tile / WPP row); contexts are managed by the caller."""
        self.pos = start_byte
        self.end = len(self.data) if end_byte is None else end_byte
        self.start()

    def finish_ok(self) -> bool:
        """Check the stop/alignment pattern at the end of the CABAC stream
        (parity: BinDecoder::finish, BinDecoder.cpp:90)."""
        prev = self.data[self.pos - 1] if 0 < self.pos <= len(self.data) else 0
        return ((prev << (8 + self.bits_needed)) & 0xFF) == 0x80

    # ------------------------------------------------------------------
    def decode_bin(self, ctx_id: int) -> int:
        rng = self.range
        value = self.value
        lps, bin_val = self.ctx.lps_mps(ctx_id, rng)
        rng -= lps
        sr = rng << 7
        if value >= sr:
            # LPS path
            bin_val ^= 1
            num_bits = RENORM_TABLE_32[lps >> 3]
            value = (value - sr) << num_bits
            rng = lps << num_bits
            self.bits_needed += num_bits
        elif rng < 256:
            # MPS renorm (1 bit)
            value <<= 1
            rng <<= 1
            self.bits_needed += 1
        if self.bits_needed >= 0:
            value += self._read_byte() << self.bits_needed
            self.bits_needed -= 8
        self.range = rng
        self.value = value
        self.ctx.update(ctx_id, bin_val)
        return bin_val

    def decode_bin_ep(self) -> int:
        value = self.value << 1
        self.bits_needed += 1
        if self.bits_needed >= 0:
            value += self._read_byte()
            self.bits_needed = -8
        sr = self.range << 7
        bin_val = 0
        if value >= sr:
            value -= sr
            bin_val = 1
        self.value = value
        return bin_val

    def decode_bins_ep(self, num_bins: int) -> int:
        if self.range == 256:
            return self._decode_aligned_bins_ep(num_bins)
        rem = num_bins
        bins = 0
        value = self.value
        rng = self.range
        bits_needed = self.bits_needed
        while rem > 8:
            value = (value << 8) + (self._read_byte() << (8 + bits_needed))
            sr = rng << 15
            for _ in range(8):
                bins += bins
                sr >>= 1
                if value >= sr:
                    bins += 1
                    value -= sr
            rem -= 8
        bits_needed += rem
        value <<= rem
        if bits_needed >= 0:
            value += self._read_byte() << bits_needed
            bits_needed -= 8
        sr = rng << (rem + 7)
        for _ in range(rem):
            bins += bins
            sr >>= 1
            if value >= sr:
                bins += 1
                value -= sr
        self.value = value
        self.range = rng
        self.bits_needed = bits_needed
        return bins

    def _decode_aligned_bins_ep(self, num_bins: int) -> int:
        rem = num_bins
        bins = 0
        while rem > 0:
            n = min(rem, 8)
            mask = (1 << n) - 1
            new_bins = (self.value >> (15 - n)) & mask
            bins = (bins << n) | new_bins
            self.value = (self.value << n) & 0x7FFF
            rem -= n
            self.bits_needed += n
            if self.bits_needed >= 0:
                self.value |= self._read_byte() << self.bits_needed
                self.bits_needed -= 8
        return bins

    def decode_rem_abs_ep(self, rice: int, cutoff: int, max_log2_dyn: int) -> int:
        max_prefix = 32 - max_log2_dyn
        prefix = 0
        code = 0
        while True:
            prefix += 1
            code = self.decode_bin_ep()
            if not (code and prefix < max_prefix):
                break
        prefix -= 1 - code
        length = rice
        if prefix < cutoff:
            offset = prefix << rice
        else:
            offset = ((1 << (prefix - cutoff)) + cutoff - 1) << rice
            length += (max_log2_dyn - rice) if prefix == max_prefix else (prefix - cutoff)
        return offset + self.decode_bins_ep(length)

    def decode_bin_trm(self) -> int:
        self.range -= 2
        sr = self.range << 7
        if self.value >= sr:
            return 1
        if self.range < 256:
            self.range += self.range
            self.value += self.value
            self.bits_needed += 1
            if self.bits_needed == 0:
                self.value += self._read_byte()
                self.bits_needed = -8
        return 0

    def align(self) -> None:
        self.range = 256


class CabacEncoder:
    """Arithmetic encoder — the dual of CabacDecoder, for the test encoder."""

    def __init__(self) -> None:
        self.ctx = CtxState()
        self.out = bytearray()
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    def reset(self, qp: int, init_id: int) -> None:
        self.ctx.init(qp, init_id)
        self.out = bytearray()
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF

    def restart_substream(self) -> None:
        """Reset the arithmetic state for the next tile / WPP substream;
        contexts are managed by the caller."""
        self.out = bytearray()
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered = 0
        self.buffered_byte = 0xFF
        self._tail_bits = (0, 0)

    def _write_out(self) -> None:
        lead = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= (0xFFFFFFFF >> self.bits_left)
        if lead == 0xFF:
            self.num_buffered += 1
        elif self.num_buffered > 0:
            carry = lead >> 8
            byte = self.buffered_byte + carry
            self.buffered_byte = lead & 0xFF
            self.out.append(byte & 0xFF)
            byte = (0xFF + carry) & 0xFF
            while self.num_buffered > 1:
                self.out.append(byte)
                self.num_buffered -= 1
        else:
            self.num_buffered = 1
            self.buffered_byte = lead & 0xFF

    def encode_bin(self, bin_val: int, ctx_id: int) -> None:
        lps, mps = self.ctx.lps_mps(ctx_id, self.range)
        self.range -= lps
        if bin_val != mps:
            num_bits = RENORM_TABLE_32[lps >> 3]
            self.bits_left -= num_bits
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            if self.bits_left < 12:
                self._write_out()
        elif self.range < 256:
            self.bits_left -= 1
            self.low <<= 1
            self.range <<= 1
            if self.bits_left < 12:
                self._write_out()
        self.ctx.update(ctx_id, bin_val)

    def encode_bin_ep(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, bins: int, num_bins: int) -> None:
        for i in range(num_bins - 1, -1, -1):
            self.encode_bin_ep((bins >> i) & 1)

    def encode_rem_abs_ep(self, value: int, rice: int, cutoff: int,
                          max_log2_dyn: int) -> None:
        """Dual of decode_rem_abs_ep."""
        quotient = value >> rice
        if quotient < cutoff:
            # prefix of `quotient` ones + 0, then `rice` suffix bits
            for _ in range(quotient):
                self.encode_bin_ep(1)
            if quotient < 32 - max_log2_dyn:
                self.encode_bin_ep(0)
            self.encode_bins_ep(value & ((1 << rice) - 1), rice)
        else:
            # exp-golomb escape
            max_prefix = 32 - max_log2_dyn
            # find prefix >= cutoff such that value fits
            prefix = cutoff
            while True:
                if prefix == max_prefix:
                    length = max_log2_dyn
                else:
                    length = rice + prefix - cutoff
                offset = (((1 << (prefix - cutoff)) + cutoff - 1) << rice)
                if value < offset + (1 << length) or prefix == max_prefix:
                    break
                prefix += 1
            for _ in range(prefix):
                self.encode_bin_ep(1)
            if prefix < max_prefix:
                self.encode_bin_ep(0)
            self.encode_bins_ep(value - offset, length)

    def encode_bin_trm(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.bits_left -= 7
            self.low = (self.low + self.range) << 7
            self.range = 2 << 7
            if self.bits_left < 12:
                self._write_out()
        elif self.range >= 256:
            return
        else:
            self.bits_left -= 1
            self.low <<= 1
            self.range <<= 1
            if self.bits_left < 12:
                self._write_out()

    def align(self) -> None:
        self.range = 256

    def finish(self) -> bytes:
        """Flush; returns the CABAC byte string (caller appends the
        rbsp stop bit/alignment via a BitWriter)."""
        if self.low >> (32 - self.bits_left):
            self.out.append((self.buffered_byte + 1) & 0xFF)
            while self.num_buffered > 1:
                self.out.append(0x00)
                self.num_buffered -= 1
            self.low -= 1 << (32 - self.bits_left)
            self.num_buffered = 0
        else:
            if self.num_buffered > 0:
                self.out.append(self.buffered_byte)
            while self.num_buffered > 1:
                self.out.append(0xFF)
                self.num_buffered -= 1
            self.num_buffered = 0
        # write remaining 24 - bits_left bits of low, MSB first
        bits = 24 - self.bits_left
        val = (self.low >> 8) & ((1 << bits) - 1) if bits > 0 else 0
        # pack into bytes: final stream must end such that the decoder's
        # stop-pattern check passes; the slice-data writer appends the
        # rbsp_stop_one_bit via the surrounding BitWriter.
        nbytes, remainder = divmod(bits, 8)
        acc = val
        by = []
        total_bits = bits
        while total_bits >= 8:
            total_bits -= 8
            by.append((acc >> total_bits) & 0xFF)
        self.out.extend(by)
        self._tail_bits = (acc & ((1 << total_bits) - 1), total_bits)
        return bytes(self.out)

    @property
    def tail_bits(self) -> tuple[int, int]:
        """(value, nbits) of sub-byte bits remaining after finish()."""
        return getattr(self, "_tail_bits", (0, 0))


# ======================================================================
# native engine (C extension) — same semantics, production hot path
# ======================================================================
class _NativeSnapshot:
    """Opaque context snapshot for WPP/tile save-restore."""

    __slots__ = ("blob",)

    def __init__(self, blob: bytes) -> None:
        self.blob = blob

    def copy(self) -> "_NativeSnapshot":
        return _NativeSnapshot(self.blob)


class _NativeCtx:
    """Context-state handle matching the CtxState surface used by
    CtuDecoder.code_slice (init / copy / assignment)."""

    __slots__ = ("_dec",)

    def __init__(self, dec) -> None:
        self._dec = dec

    def init(self, qp: int, init_id: int) -> None:
        self._dec._d.ctx_init(qp, init_id)

    def copy(self) -> _NativeSnapshot:
        return _NativeSnapshot(self._dec._d.ctx_save())


class NativeCabacDecoder:
    """CabacDecoder drop-in backed by the C extension
    (refdec/native/cabac.c)."""

    __slots__ = ("_d",)

    _INIT_ARGS = None

    @classmethod
    def _tables(cls):
        if cls._INIT_ARGS is None:
            cls._INIT_ARGS = (ctx_tables.INIT_B, ctx_tables.INIT_P,
                              ctx_tables.INIT_I, ctx_tables.RATES)
        return cls._INIT_ARGS

    def __init__(self, data: bytes, start_byte: int = 0,
                 end_byte: int | None = None):
        from refdec.native import native_cabac
        b, p, i, r = self._tables()
        self._d = native_cabac().Decoder(
            data, start_byte, end_byte, num_ctx=NUM_CTX,
            init_b=b, init_p=p, init_i=i, rates=r)

    # -- engine ---------------------------------------------------------
    def reset(self, qp: int, init_id: int) -> None:
        self._d.ctx_init(qp, init_id)
        self._d.start()

    def restart(self, start_byte: int, end_byte: int | None = None) -> None:
        self._d.restart(start_byte, end_byte)

    def decode_bin(self, ctx_id: int) -> int:
        return self._d.decode_bin(ctx_id)

    def decode_bin_ep(self) -> int:
        return self._d.decode_bin_ep()

    def decode_bins_ep(self, n: int) -> int:
        return self._d.decode_bins_ep(n)

    def decode_rem_abs_ep(self, rice: int, cutoff: int,
                          max_log2_dyn: int) -> int:
        return self._d.decode_rem_abs_ep(rice, cutoff, max_log2_dyn)

    def decode_bin_trm(self) -> int:
        return self._d.decode_bin_trm()

    def align(self) -> None:
        self._d.align()

    def finish_ok(self) -> bool:
        return self._d.finish_ok()

    @property
    def data(self):
        return self._d.data

    @property
    def ctx(self):
        return _NativeCtx(self)

    @ctx.setter
    def ctx(self, value) -> None:
        if isinstance(value, _NativeSnapshot):
            self._d.ctx_load(value.blob)
        elif isinstance(value, _NativeCtx):
            if value._dec is not self:
                self._d.ctx_load(value._dec._d.ctx_save())
        else:
            raise TypeError("cannot assign this ctx type to a native decoder")


def make_cabac_decoder(data: bytes, start_byte: int = 0,
                       end_byte: int | None = None):
    """CabacDecoder factory: native engine when available, else Python."""
    import os
    if os.environ.get("REFDEC_NO_NATIVE") != "1":
        from refdec.native import native_cabac
        if native_cabac() is not None:
            return NativeCabacDecoder(data, start_byte, end_byte)
    return CabacDecoder(data, start_byte, end_byte)
