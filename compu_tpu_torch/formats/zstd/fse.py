"""FSE (Finite State Entropy, tANS) — RFC 8878 §4.1.

The port's copy of ``compu_tpu/formats/zstd/fse.py``: the zstd
symbol-spread algorithm, the decode table, the backward bit reader both
zstd bitstream kinds use, both bit writers, the encoder-side state machine
(classic FSE CTable semantics: deltaNbBits / deltaFindState), and the
table description reader and writer.
"""

from __future__ import annotations

import numpy as np

from ..base import CodecFailure

ERR_FSE = 301


class BackwardBitReader:
    """zstd bitstreams are written forward and read backward: the last
    non-zero byte's highest set bit is a sentinel; reads consume high bits
    downward. Modeled as one big little-endian integer."""

    __slots__ = ("value", "bits")

    def __init__(self, data: bytes) -> None:
        if not data or data[-1] == 0:
            raise CodecFailure(ERR_FSE, "corrupt bitstream (no sentinel)")
        self.value = int.from_bytes(data, "little")
        self.bits = (len(data) - 1) * 8 + data[-1].bit_length() - 1  # drop sentinel

    def read(self, n: int) -> int:
        """Read n bits (n may be 0). zstd permits the bit counter to go
        negative at the tail (reads yield zero bits)."""
        self.bits -= n
        if self.bits >= 0:
            return (self.value >> self.bits) & ((1 << n) - 1)
        if self.bits < -64:
            raise CodecFailure(ERR_FSE, "bitstream over-read")
        shift = -self.bits
        return ((self.value << shift) & ((1 << n) - 1)) if n else 0

    @property
    def exhausted(self) -> bool:
        return self.bits <= 0


class BackwardBitWriter:
    """Writer whose pushes are read back IN PUSH ORDER by
    :class:`BackwardBitReader` (first push lands at the top, right under
    the sentinel). Used for Huffman literal streams (decoder consumes
    literals first-to-last)."""

    __slots__ = ("value", "bits")

    def __init__(self) -> None:
        self.value = 0
        self.bits = 0

    def push(self, value: int, n: int) -> None:
        if n == 0:
            return
        # int() guards against numpy scalars (a np.int64 shifted by a
        # Python-int bit count >= 64 raises OverflowError)
        self.value = (self.value << int(n)) | (int(value) & ((1 << int(n)) - 1))
        self.bits += int(n)

    def finish(self) -> bytes:
        """Place the sentinel bit on top and pad up to a whole byte."""
        v = self.value | (1 << self.bits)
        return v.to_bytes((self.bits + 8) // 8, "little")


class ForwardBitWriter:
    """Writer whose pushes are read back in REVERSE push order by
    :class:`BackwardBitReader` (classic FSE pairing: encoder pushes while
    walking symbols backward, decoder reads walking forward)."""

    __slots__ = ("value", "bits")

    def __init__(self) -> None:
        self.value = 0
        self.bits = 0

    def push(self, value: int, n: int) -> None:
        if n == 0:
            return
        # int() guards against numpy scalars (see BackwardBitWriter.push)
        self.value |= (int(value) & ((1 << int(n)) - 1)) << self.bits
        self.bits += int(n)

    def finish(self) -> bytes:
        v = self.value | (1 << self.bits)
        return v.to_bytes((self.bits + 8) // 8, "little")


def _spread_symbols(norm_counts, table_log: int) -> np.ndarray:
    size = 1 << table_log
    table = np.full(size, -1, dtype=np.int32)
    high = size - 1
    for s, c in enumerate(norm_counts):
        if c == -1:
            table[high] = s
            high -= 1
    pos = 0
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    for s, c in enumerate(norm_counts):
        if c <= 0:
            continue
        for _ in range(c):
            table[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0 or (table < 0).any():
        raise CodecFailure(ERR_FSE, "corrupt FSE distribution")
    return table


class FseDecodeTable:
    __slots__ = ("table_log", "symbol", "nbits", "baseline")

    def __init__(self, norm_counts, table_log: int) -> None:
        """RFC 8878 §4.1.1 decoding table."""
        self.table_log = table_log
        size = 1 << table_log
        table = _spread_symbols(norm_counts, table_log)
        symbol_next = [c if c > 0 else 1 for c in norm_counts]
        nbits = np.zeros(size, dtype=np.int32)
        baseline = np.zeros(size, dtype=np.int32)
        for i in range(size):
            s = int(table[i])
            x = symbol_next[s]
            symbol_next[s] += 1
            nb = table_log - (x.bit_length() - 1)
            nbits[i] = nb
            baseline[i] = (x << nb) - size
        self.symbol = table
        self.nbits = nbits
        self.baseline = baseline


class FseEncodeTable:
    """Classic FSE CTable (encode runs the decode automaton backward).

    encode(state, symbol) -> (bits_value, nbits, new_state); symbols are
    fed in REVERSE stream order and the final state is flushed as the
    decoder's initial state.
    """

    __slots__ = ("table_log", "state_table", "delta_nbits", "delta_find")

    def __init__(self, norm_counts, table_log: int) -> None:
        self.table_log = table_log
        size = 1 << table_log
        spread = _spread_symbols(norm_counts, table_log)
        nsyms = len(norm_counts)
        freqs = [c if c > 0 else (1 if c == -1 else 0) for c in norm_counts]
        cumul = np.zeros(nsyms + 1, dtype=np.int64)
        for s in range(nsyms):
            cumul[s + 1] = cumul[s] + freqs[s]
        # stateTable: k-th occurrence (cumulative order) of symbol s maps
        # to state (size + cell_index), cells visited in spread order.
        self.state_table = np.zeros(size, dtype=np.int64)
        cum = cumul[:-1].copy()
        for u in range(size):
            s = int(spread[u])
            self.state_table[cum[s]] = size + u
            cum[s] += 1
        self.delta_nbits = np.zeros(nsyms, dtype=np.int64)
        self.delta_find = np.zeros(nsyms, dtype=np.int64)
        for s in range(nsyms):
            f = freqs[s]
            if f == 0:
                continue
            if f == 1:
                self.delta_nbits[s] = (table_log << 16) - (1 << table_log)
            else:
                max_bits = table_log - ((f - 1).bit_length() - 1)
                self.delta_nbits[s] = (max_bits << 16) - (f << max_bits)
            self.delta_find[s] = cumul[s] - f

    def init_state(self, symbol: int) -> int:
        nbits_out = (int(self.delta_nbits[symbol]) + (1 << 15)) >> 16
        value = (nbits_out << 16) - int(self.delta_nbits[symbol])
        return int(self.state_table[(value >> nbits_out) + int(self.delta_find[symbol])])

    def encode(self, state: int, symbol: int, writer: BackwardBitWriter) -> int:
        nbits_out = (state + int(self.delta_nbits[symbol])) >> 16
        writer.push(state, nbits_out)
        return int(
            self.state_table[(state >> nbits_out) + int(self.delta_find[symbol])]
        )

    def flush(self, state: int, writer: BackwardBitWriter) -> None:
        writer.push(state, self.table_log)


def read_norm_counts(data: bytes, bit_pos: int, max_symbol: int, max_log: int):
    """Parse an FSE table description (forward bitstream; zstd
    FSE_readNCount semantics). Returns (norm_counts, table_log, new_bit_pos
    rounded up to a byte boundary is NOT applied — caller decides)."""

    def read_bits(pos, n):
        if n == 0:
            return 0, pos
        end = (pos + n + 7) // 8
        if pos // 8 >= len(data):
            raise CodecFailure(ERR_FSE, "truncated FSE header")
        # Zero-extend past the end: speculative wide reads near the tail are
        # legal (validity is enforced by the remaining==1 invariant).
        chunk = int.from_bytes(data[pos // 8 : min(end, len(data))], "little")
        return (chunk >> (pos % 8)) & ((1 << n) - 1), pos + n

    pos = bit_pos
    acc, pos = read_bits(pos, 4)
    table_log = acc + 5
    if table_log > max_log:
        raise CodecFailure(ERR_FSE, "FSE accuracy too large")
    size = 1 << table_log
    remaining = size + 1
    threshold = size
    nbits = table_log + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            # Runs of zero-probability symbols: 2-bit repeat flags.
            while True:
                rep, pos = read_bits(pos, 2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            previous0 = False
            if len(counts) > max_symbol:
                break
            continue
        maxv = (2 * threshold - 1) - remaining
        val, npos = read_bits(pos, nbits)
        if (val & (threshold - 1)) < maxv:
            count = val & (threshold - 1)
            pos += nbits - 1
        else:
            count = val & (2 * threshold - 1)
            if count >= threshold:
                count -= maxv
            pos += nbits
        count -= 1  # shift: transmitted value = probability + 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise CodecFailure(ERR_FSE, "corrupt FSE distribution header")
    counts += [0] * (max_symbol + 1 - len(counts))
    return counts, table_log, pos


def write_norm_counts(counts, table_log: int) -> bytes:
    """Serialize an FSE table description (inverse of read_norm_counts)."""
    bits_buf = 0
    bits_n = 0
    out = bytearray()

    def push(value, n):
        nonlocal bits_buf, bits_n
        bits_buf |= (value & ((1 << n) - 1)) << bits_n
        bits_n += n
        while bits_n >= 8:
            out.append(bits_buf & 0xFF)
            bits_buf >>= 8
            bits_n -= 8

    push(table_log - 5, 4)
    size = 1 << table_log
    remaining = size + 1
    threshold = size
    nbits = table_log + 1
    i = 0
    while remaining > 1 and i < len(counts):
        count = counts[i]
        i += 1
        value = count + 1
        maxv = (2 * threshold - 1) - remaining
        if value < maxv:
            push(value, nbits - 1)
        else:
            v = value
            if v >= threshold:
                v += maxv
            push(v, nbits)
        remaining -= -count if count < 0 else count
        if count == 0:
            # emit zero-run repeats
            run = 0
            while i < len(counts) and counts[i] == 0 and remaining > 1:
                run += 1
                i += 1
            while run >= 3:
                push(3, 2)
                run -= 3
            push(run, 2)
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if bits_n:
        out.append(bits_buf & 0xFF)
    return bytes(out)
