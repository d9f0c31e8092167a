"""MSB-first bit writer with Exp-Golomb codes — the dual of bitstream.reader."""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []  # avoid int ops on huge ints; chunked flush
        self._buf = bytearray()
        self._cur = 0
        self._ncur = 0

    def u(self, value: int, n: int) -> None:
        assert 0 <= value < (1 << n), (value, n)
        cur, ncur = self._cur, self._ncur
        cur = (cur << n) | value
        ncur += n
        while ncur >= 8:
            ncur -= 8
            self._buf.append((cur >> ncur) & 0xFF)
        self._cur = cur & ((1 << ncur) - 1)
        self._ncur = ncur

    def flag(self, b) -> None:
        self.u(1 if b else 0, 1)

    def ue(self, value: int) -> None:
        assert value >= 0
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int) -> None:
        if value <= 0:
            self.ue(-2 * value)
        else:
            self.ue(2 * value - 1)

    def byte_align(self, bit: int = 0) -> None:
        while self._ncur % 8 != 0:
            self.u(bit, 1)

    def rbsp_trailing(self) -> None:
        self.u(1, 1)
        self.byte_align(0)

    def align_with_one_then_zeros(self) -> None:
        """byte_alignment(): one 1-bit then 0-bits to alignment."""
        self.u(1, 1)
        self.byte_align(0)

    @property
    def bitpos(self) -> int:
        return len(self._buf) * 8 + self._ncur

    def bytes(self) -> bytes:
        assert self._ncur == 0, "writer not byte-aligned"
        return bytes(self._buf)
