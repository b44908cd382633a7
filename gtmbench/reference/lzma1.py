"""LZMA1-alone decoder in plain Python: the benchmark's frozen copy of
the port's fallback decoder (tiler_tpu_torch/bitstream/pylzma1.py), so
that the stream's parse does not depend on the program under test.
Streams with lc + lp <= 4 go through the standard library's liblzma
(gtm.py); this one takes the lc=8 streams that liblzma refuses, at
about 1 MB/s. Raises ValueError on malformed input.
"""
from __future__ import annotations

_TOP = 1 << 24
_MODEL_TOTAL = 1 << 11
_INIT_PROB = _MODEL_TOTAL // 2
_MATCH_MIN = 2


class _RC:
    """Range decoder over a bytes buffer. Mirrors native/lzma1.cc's
    conventions exactly (trailing normalize, zero-fill overrun flag,
    first coded byte skipped unchecked) so `consumed` counts match the
    fast path byte for byte on concatenated keyframe streams."""

    __slots__ = ('data', 'pos', 'rng', 'code', 'overrun')

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.rng = 0xFFFFFFFF
        self.overrun = False
        self._next()  # first byte of the coded stream: skip
        c = 0
        for _ in range(4):
            c = (c << 8) | self._next()
        self.code = c

    def _next(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.overrun = True
        return 0

    def _norm(self):
        if self.rng < _TOP:
            self.rng = (self.rng << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) | self._next()) & 0xFFFFFFFF

    def bit(self, probs, i) -> int:
        p = probs[i]
        bound = (self.rng >> 11) * p
        if self.code < bound:
            self.rng = bound
            probs[i] = p + ((_MODEL_TOTAL - p) >> 5)
            b = 0
        else:
            self.code -= bound
            self.rng -= bound
            probs[i] = p - (p >> 5)
            b = 1
        self._norm()
        return b

    def direct(self, n: int) -> int:
        v = 0
        for _ in range(n):
            self.rng >>= 1
            if self.code >= self.rng:
                self.code -= self.rng
                v = (v << 1) | 1
            else:
                v <<= 1
            self._norm()
        return v

    def tree(self, probs, base: int, nbits: int) -> int:
        m = 1
        for _ in range(nbits):
            m = (m << 1) | self.bit(probs, base + m)
        return m - (1 << nbits)

    def rtree(self, probs, base: int, nbits: int) -> int:
        m = 1
        sym = 0
        for i in range(nbits):
            b = self.bit(probs, base + m)
            m = (m << 1) | b
            sym |= b << i
        return sym


class _LenDec:
    __slots__ = ('choice', 'low', 'mid', 'high')

    def __init__(self):
        self.choice = [_INIT_PROB] * 2
        self.low = [_INIT_PROB] * (16 * 8)
        self.mid = [_INIT_PROB] * (16 * 8)
        self.high = [_INIT_PROB] * 256

    def decode(self, rc: _RC, pos_state: int) -> int:
        if not rc.bit(self.choice, 0):
            return rc.tree(self.low, pos_state * 8, 3)
        if not rc.bit(self.choice, 1):
            return 8 + rc.tree(self.mid, pos_state * 8, 3)
        return 16 + rc.tree(self.high, 0, 8)


def decode_alone(data: bytes, max_out: int = 1 << 30):
    """Decode one LZMA-alone stream from the head of `data`.

    Returns (decompressed bytes, consumed input bytes) — the consumed
    count is what lets concatenated keyframe streams split (the JS
    player's per-stream header re-read, lzma.js:692-721).
    """
    if len(data) < 13:
        raise ValueError('lzma: truncated header')
    props = data[0]
    if props >= 225:
        raise ValueError('lzma: bad props byte')
    lc = props % 9
    rest = props // 9
    lp = rest % 5
    pb = rest // 5
    usize_raw = data[5:13]
    usize = None
    if usize_raw != b'\xff' * 8:
        usize = int.from_bytes(usize_raw, 'little')
        if usize > max_out:
            raise ValueError('lzma: declared size exceeds cap')

    rc = _RC(data, 13)
    lit = [_INIT_PROB] * (0x300 << (lc + lp))
    is_match = [_INIT_PROB] * (12 * 16)
    is_rep = [_INIT_PROB] * 12
    is_rep_g0 = [_INIT_PROB] * 12
    is_rep_g1 = [_INIT_PROB] * 12
    is_rep_g2 = [_INIT_PROB] * 12
    is_rep0_long = [_INIT_PROB] * (12 * 16)
    pos_slot = [_INIT_PROB] * (4 * 64)
    spec_pos = [_INIT_PROB] * 115
    align = [_INIT_PROB] * 16
    len_dec = _LenDec()
    rep_len_dec = _LenDec()

    out = bytearray()
    state = 0
    rep0 = rep1 = rep2 = rep3 = 0
    pb_mask = (1 << pb) - 1
    lp_mask = (1 << lp) - 1

    while usize is None or len(out) < usize:
        if rc.overrun:
            raise ValueError('lzma: truncated stream')
        if len(out) > max_out:
            raise ValueError('lzma: output exceeds cap')
        pos_state = len(out) & pb_mask
        if not rc.bit(is_match, state * 16 + pos_state):
            # literal
            prev = out[-1] if out else 0
            # (for lc==0, prev >> 8 is simply 0 in Python — no C shift UB)
            lit_state = ((len(out) & lp_mask) << lc) + (prev >> (8 - lc))
            base = 0x300 * lit_state
            if state >= 7:
                if rep0 + 1 > len(out):
                    raise ValueError('lzma: match byte before start')
                match_byte = out[-rep0 - 1]
                sym = 1
                while sym < 0x100:
                    match_bit = (match_byte >> 7) & 1
                    match_byte = (match_byte << 1) & 0xFF
                    b = rc.bit(lit, base + ((1 + match_bit) << 8) + sym)
                    sym = (sym << 1) | b
                    if match_bit != b:
                        while sym < 0x100:
                            sym = (sym << 1) | rc.bit(lit, base + sym)
                        break
            else:
                sym = 1
                while sym < 0x100:
                    sym = (sym << 1) | rc.bit(lit, base + sym)
            out.append(sym & 0xFF)
            state = 0 if state < 4 else (state - 3 if state < 10
                                         else state - 6)
            continue
        if rc.bit(is_rep, state):
            # rep match
            if not rc.bit(is_rep_g0, state):
                if not rc.bit(is_rep0_long, state * 16 + pos_state):
                    # short rep
                    if rep0 + 1 > len(out):
                        raise ValueError('lzma: short rep before start')
                    out.append(out[-rep0 - 1])
                    state = 9 if state < 7 else 11
                    continue
            else:
                if not rc.bit(is_rep_g1, state):
                    dist = rep1
                elif not rc.bit(is_rep_g2, state):
                    dist = rep2
                    rep2 = rep1
                else:
                    dist = rep3
                    rep3 = rep2
                    rep2 = rep1
                rep1 = rep0
                rep0 = dist
            length = rep_len_dec.decode(rc, pos_state) + _MATCH_MIN
            state = 8 if state < 7 else 11
        else:
            # normal match
            rep3 = rep2
            rep2 = rep1
            rep1 = rep0
            length = len_dec.decode(rc, pos_state) + _MATCH_MIN
            state = 7 if state < 7 else 10
            l2p = length - _MATCH_MIN
            if l2p > 3:
                l2p = 3
            slot = rc.tree(pos_slot, l2p * 64, 6)
            if slot < 4:
                rep0 = slot
            else:
                nd = (slot >> 1) - 1
                rep0 = (2 | (slot & 1)) << nd
                if slot < 14:
                    rep0 += rc.rtree(spec_pos, rep0 - slot - 1, nd)
                else:
                    rep0 += rc.direct(nd - 4) << 4
                    rep0 += rc.rtree(align, 0, 4)
                if rep0 == 0xFFFFFFFF:
                    # end-of-stream marker (trailing normalizes already
                    # ran inside the bit decodes — consumed matches the
                    # native decoder's count exactly). A stream truncated
                    # inside the final range-coder bytes whose zero-fill
                    # still decodes to this marker is NOT a clean end:
                    # reject it (parity with lzma1.cc, which returns -3
                    # on the same condition).
                    if rc.overrun:
                        raise ValueError('lzma: truncated stream')
                    return bytes(out), rc.pos
        if rep0 + 1 > len(out):
            raise ValueError('lzma: match distance before start')
        src = len(out) - rep0 - 1
        for _ in range(length):
            out.append(out[src])
            src += 1
    # size-terminated stream (no EOS marker required)
    return bytes(out), rc.pos
