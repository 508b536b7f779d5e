"""zstd-flavor canonical Huffman (RFC 8878 §4.2): code lengths capped at
11 bits, the weight description (FSE-compressed or direct), backward
literal streams, and the decode table.

The port's copy of ``compu_tpu/formats/zstd/huff.py`` (``HufTable``,
``decode_weights``, ``HufEncoder``, ``normalize_counts``). The weight
description's FSE stream, and a literal stream of more than 64 bytes, are
written by the host runtime (``native_enc.fse_pair_stream``,
``native_enc.huf_stream``), as the reference's are; ``fse_pair_stream_py``
and ``HufEncoder.encode_stream_py`` are their Python twins.
"""

from __future__ import annotations

import numpy as np

from ..base import CodecFailure
from ...ops.huffman import length_limited_lengths
from . import native_enc
from .fse import (
    BackwardBitReader,
    BackwardBitWriter,
    ForwardBitWriter,
    FseDecodeTable,
    FseEncodeTable,
    read_norm_counts,
    write_norm_counts,
)

ERR_HUF = 302
MAX_BITS = 11


class HufTable:
    """Decode table: flat 2^M entries indexed by the next M stream bits
    (read MSB-down by the backward reader)."""

    __slots__ = ("max_bits", "symbol", "nbits")

    def __init__(self, weights: list[int]) -> None:
        total = sum((1 << (w - 1)) for w in weights if w > 0)
        if total == 0:
            raise CodecFailure(ERR_HUF, "empty huffman table")
        m = (total - 1).bit_length()
        if (1 << m) != total or m > MAX_BITS:
            raise CodecFailure(ERR_HUF, "invalid huffman weights")
        self.max_bits = m
        size = 1 << m
        self.symbol = np.zeros(size, dtype=np.int32)
        self.nbits = np.zeros(size, dtype=np.int32)
        # Canonical fill: ascending weight (longest codes first), symbols in
        # natural order within a weight; each weight-w symbol spans 2^(w-1)
        # consecutive cells.
        pos = 0
        for w in range(1, m + 1):
            span = 1 << (w - 1)
            nb = m + 1 - w
            for s, ws in enumerate(weights):
                if ws == w:
                    self.symbol[pos : pos + span] = s
                    self.nbits[pos : pos + span] = nb
                    pos += span
        if pos != size:
            raise CodecFailure(ERR_HUF, "oversubscribed huffman weights")

    def decode_stream(self, data: bytes, count: int) -> bytes:
        """Decode ``count`` symbols from one backward stream. The bit
        counter may run 32 bits past the stream's start (zero bits are
        read there); a symbol past that, or an empty cell, is corrupt."""
        reader = BackwardBitReader(data)
        m = self.max_bits
        out = bytearray()
        sym = self.symbol
        nbits = self.nbits
        value = reader.value
        bits = reader.bits
        mask = (1 << m) - 1
        for _ in range(count):
            bits -= m
            idx = (value >> bits) & mask if bits >= 0 else (value << -bits) & mask
            nb = int(nbits[idx])
            if nb == 0:
                raise CodecFailure(ERR_HUF, "corrupt huffman stream")
            out.append(int(sym[idx]))
            bits += m - nb
            if bits < -32:
                raise CodecFailure(ERR_HUF, "huffman stream over-read")
        return bytes(out)


def decode_weights(data: bytes):
    """Parse a Huffman tree description. Returns (weights list incl. the
    derived last weight, bytes consumed)."""
    if not data:
        raise CodecFailure(ERR_HUF, "empty tree description")
    header = data[0]
    if header >= 128:
        n = header - 127
        nbytes = (n + 1) // 2
        if len(data) < 1 + nbytes:
            raise CodecFailure(ERR_HUF, "truncated direct weights")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append((b >> 4) if i % 2 == 0 else (b & 0x0F))
        consumed = 1 + nbytes
    else:
        csize = header
        if len(data) < 1 + csize:
            raise CodecFailure(ERR_HUF, "truncated FSE weights")
        blob = data[1 : 1 + csize]
        counts, table_log, bitpos = read_norm_counts(blob, 0, 255, 6)
        table = FseDecodeTable(counts, table_log)
        payload = blob[(bitpos + 7) // 8 :]
        reader = BackwardBitReader(payload)
        state1 = reader.read(table_log)
        state2 = reader.read(table_log)
        weights = []
        while True:
            weights.append(int(table.symbol[state1]))
            state1 = int(table.baseline[state1]) + reader.read(int(table.nbits[state1]))
            if reader.bits < 0:
                weights.append(int(table.symbol[state2]))
                break
            weights.append(int(table.symbol[state2]))
            state2 = int(table.baseline[state2]) + reader.read(int(table.nbits[state2]))
            if reader.bits < 0:
                weights.append(int(table.symbol[state1]))
                break
            if len(weights) > 254:
                raise CodecFailure(ERR_HUF, "too many weights")
        consumed = 1 + csize
    # Derive the last weight (power-of-two completion).
    total = sum((1 << (w - 1)) for w in weights if w > 0)
    if total == 0:
        raise CodecFailure(ERR_HUF, "no weights")
    pow2 = 1 << (total - 1).bit_length()
    if pow2 == total:
        pow2 <<= 1  # last symbol must have nonzero weight
    missing = pow2 - total
    last_w = missing.bit_length()
    if (1 << (last_w - 1)) != missing:
        raise CodecFailure(ERR_HUF, "invalid weight total")
    weights.append(last_w)
    return weights, consumed


class HufEncoder:
    """Builds weights/codes from a histogram and encodes streams."""

    def __init__(self, freqs: np.ndarray) -> None:
        lengths = length_limited_lengths(freqs, MAX_BITS)
        used = np.nonzero(lengths)[0]
        if len(used) < 2:
            raise CodecFailure(ERR_HUF, "huffman needs >= 2 symbols")
        m = int(lengths.max())
        self.max_bits = m
        self.max_symbol = int(used[-1])
        self.weights = [
            (m + 1 - int(lengths[s])) if lengths[s] else 0
            for s in range(self.max_symbol + 1)
        ]
        # Canonical codes in the same fill order as HufTable.
        self.code = np.zeros(self.max_symbol + 1, dtype=np.uint32)
        self.nbits = np.zeros(self.max_symbol + 1, dtype=np.int32)
        pos = 0
        for w in range(1, m + 1):
            span = 1 << (w - 1)
            nb = m + 1 - w
            for s in range(self.max_symbol + 1):
                if self.weights[s] == w:
                    self.code[s] = pos >> (m - nb)
                    self.nbits[s] = nb
                    pos += span

    def describe(self) -> bytes:
        """Serialize the tree: FSE-compressed weights when profitable, else
        direct 4-bit weights (header >= 128; only possible for <= 128
        weights — larger alphabets must FSE-compress or the caller falls
        back to raw literals)."""
        # Weights cover symbols 0..max_symbol; the last one is derived.
        transmitted = self.weights[: self.max_symbol]
        n = len(transmitted)
        fse_blob = self._describe_fse(transmitted)
        direct = None
        if n <= 128:
            direct = bytearray([127 + n])
            for i in range(0, n, 2):
                hi = transmitted[i] << 4
                lo = transmitted[i + 1] if i + 1 < n else 0
                direct.append(hi | lo)
        if fse_blob is not None and (direct is None or len(fse_blob) < len(direct)):
            return bytes(fse_blob)
        if direct is None:
            raise CodecFailure(ERR_HUF, "weights not serializable")
        return bytes(direct)

    def _describe_fse(self, transmitted: list[int]) -> bytearray | None:
        """FSE-compress the weight sequence (two interleaved states; state A
        decodes even positions, B odd). Returns None when not applicable —
        the caller falls back to direct weights. The result is self-checked
        against our own weight decoder (the stream-end termination rule can
        make skewed tables emit extra weights)."""
        if len(transmitted) < 4:
            return None
        freqs = np.bincount(np.asarray(transmitted, dtype=np.int64), minlength=2)
        norm, table_log = normalize_counts(freqs, len(transmitted), 6)
        if norm is None:
            return None
        try:
            enc = FseEncodeTable(norm, table_log)
        except CodecFailure:
            return None
        header = write_norm_counts(norm, table_log)
        payload = native_enc.fse_pair_stream(transmitted, enc)
        if payload is None:
            return None
        total = len(header) + len(payload)
        if total >= 128:
            return None
        blob = bytearray([total])
        blob.extend(header)
        blob.extend(payload)
        # Self-check: the termination rule must reproduce exactly these
        # weights (plus the derived last one).
        try:
            got, consumed = decode_weights(bytes(blob) + b"\0")
        except CodecFailure:
            return None
        if consumed != len(blob) or got[:-1] != transmitted:
            return None
        return blob

    def encode_stream(self, data: bytes) -> bytes:
        """One backward literal stream: the host runtime's above 64 bytes,
        else ``encode_stream_py``."""
        if len(data) > 64:
            return native_enc.huf_stream(data, self.code, self.nbits)
        return self.encode_stream_py(data)

    def encode_stream_py(self, data: bytes) -> bytes:
        """The Python twin of ``encode_stream``."""
        writer = BackwardBitWriter()
        code = self.code
        nbits = self.nbits
        for b in data:
            writer.push(int(code[b]), int(nbits[b]))
        return writer.finish()


def fse_pair_stream_py(transmitted, enc) -> bytes | None:
    """The Python twin of ``native_enc.fse_pair_stream``: the weights
    coded backward by two interleaved FSE states (A the even positions, B
    the odd; the decoder reads A's init, B's init, then the updates
    forward, the exact reverse of the push order). None for fewer than two
    weights."""
    writer = ForwardBitWriter()
    state_a = state_b = None
    for i in range(len(transmitted) - 1, -1, -1):
        w = transmitted[i]
        if i % 2 == 0:
            state_a = enc.init_state(w) if state_a is None else enc.encode(state_a, w, writer)
        else:
            state_b = enc.init_state(w) if state_b is None else enc.encode(state_b, w, writer)
    if state_a is None or state_b is None:
        return None
    enc.flush(state_b, writer)
    enc.flush(state_a, writer)
    return writer.finish()


def normalize_counts(freqs: np.ndarray, total: int, max_log: int):
    """Normalize a histogram to sum to 2^table_log with zstd semantics
    (-1 for less-than-one probabilities). Returns (norm, table_log) or
    (None, 0) when the alphabet is degenerate."""
    freqs = np.asarray(freqs, dtype=np.int64)
    used = np.nonzero(freqs)[0]
    if len(used) < 2:
        return None, 0
    # Accuracy heuristic (libzstd FSE_optimalTableLog shape): enough
    # resolution for the sample size, at least enough cells for the
    # alphabet, within the format cap.
    table_log = max(5, int(total - 1).bit_length() - 2, int(len(used)).bit_length())
    table_log = min(max_log, table_log)
    size = 1 << table_log
    if len(used) > size:
        return None, 0
    norm = np.zeros(len(freqs), dtype=np.int64)
    # Largest-remainder style normalization with -1 floors.
    scale = size / total
    small = freqs[used] * size < total  # would round to 0
    norm[used[small]] = -1
    budget = size - int(small.sum())
    big = used[~small]
    if len(big) == 0:
        return None, 0
    shares = freqs[big].astype(np.float64) * scale
    base = np.maximum(1, np.floor(shares).astype(np.int64))
    excess = budget - int(base.sum())
    if excess < 0:
        # Trim from the largest.
        order = np.argsort(-base)
        i = 0
        while excess < 0:
            j = order[i % len(order)]
            if base[j] > 1:
                base[j] -= 1
                excess += 1
            i += 1
    elif excess > 0:
        frac = shares - np.floor(shares)
        order = np.argsort(-frac)
        for k in range(excess):
            base[order[k % len(order)]] += 1
    norm[big] = base
    assert int(norm[norm > 0].sum()) + int((norm == -1).sum()) == size
    return [int(x) for x in norm], table_log
