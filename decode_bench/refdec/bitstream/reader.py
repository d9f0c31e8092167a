"""MSB-first bit reader over RBSP bytes, with Exp-Golomb codes.

Behavioral parity: vvdec InputBitstream (source/Lib/CommonLib/BitStream.{h,cpp})
and the ue(v)/se(v) readers in VLCReader.cpp — re-implemented from the H.266
syntax definitions, not ported.
"""

from __future__ import annotations


class BitReader:
    """Reads bits MSB-first from a bytes-like RBSP buffer."""

    __slots__ = ("data", "nbits", "pos")

    def __init__(self, data: bytes | bytearray | memoryview, pos: int = 0):
        self.data = bytes(data)
        self.nbits = 8 * len(self.data)
        self.pos = pos  # bit position

    # -- core -------------------------------------------------------------
    def u(self, n: int) -> int:
        """Read n bits as an unsigned integer (n may be 0)."""
        if n == 0:
            return 0
        pos = self.pos
        end = pos + n
        if end > self.nbits:
            raise EOFError(f"bitstream overrun: want {n} bits at {pos}/{self.nbits}")
        self.pos = end
        # Extract from the containing byte span.
        first_byte = pos >> 3
        last_byte = (end - 1) >> 3
        chunk = int.from_bytes(self.data[first_byte : last_byte + 1], "big")
        shift = ((last_byte + 1) << 3) - end
        return (chunk >> shift) & ((1 << n) - 1)

    def flag(self) -> bool:
        return bool(self.u(1))

    def ue(self) -> int:
        """Unsigned Exp-Golomb (ue(v))."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid exp-golomb code (>32 leading zeros)")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        """Signed Exp-Golomb (se(v)): 0,1,-1,2,-2,..."""
        k = self.ue()
        if k & 1:
            return (k + 1) >> 1
        return -(k >> 1)

    # -- positioning ------------------------------------------------------
    def byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def bits_left(self) -> int:
        return self.nbits - self.pos

    def more_rbsp_data(self) -> bool:
        """H.266 more_rbsp_data(): true if there is data before the final
        rbsp_stop_one_bit + alignment zeros."""
        if self.pos >= self.nbits:
            return False
        # Find last byte that is non-zero (the one holding rbsp_stop_one_bit).
        data = self.data
        last = len(data) - 1
        while last >= 0 and data[last] == 0:
            last -= 1
        if last < 0:
            return False
        # Position of the stop bit = lowest set bit of data[last].
        b = data[last]
        low = (b & -b).bit_length() - 1  # index from LSB
        stop_pos = (last << 3) + (7 - low)
        return self.pos < stop_pos

    def byte_pos(self) -> int:
        return self.pos >> 3

    def read_bytes(self, n: int) -> bytes:
        """Read n aligned bytes (reader must be byte-aligned)."""
        assert self.byte_aligned()
        p = self.pos >> 3
        if p + n > len(self.data):
            raise EOFError("bitstream overrun in read_bytes")
        self.pos += n << 3
        return self.data[p : p + n]
