"""The benchmark corpus: a deterministic Silesia-like mix of text,
structured records and binary bytes.

The port's copy of ``bench.py::build_corpus``. The text part is
``tests/data/alice29.txt``, found from the repository root rather than the
working directory, so the corpus is the same wherever a script runs.
"""

from __future__ import annotations

import pathlib

import numpy as np

TEXT_PATH = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data" / "alice29.txt"


def build_corpus(total: int = 16 << 20) -> bytes:
    """``total`` bytes: a third mutated text, a third JSON-like records, a
    sixth low-entropy bytes and a sixth noise, all from seed 1234."""
    rng = np.random.default_rng(1234)
    pieces = []
    text = TEXT_PATH.read_bytes()
    # Text with small mutations, so blocks differ.
    while sum(map(len, pieces)) < total // 3:
        t = bytearray(text)
        for _ in range(32):
            t[int(rng.integers(0, len(t)))] = int(rng.integers(32, 127))
        pieces.append(bytes(t))
    # Structured: repetitive records with counters.
    rec = b"".join(
        b'{"id": %08d, "name": "item-%d", "flags": [1,2,3]}\n' % (i, i % 977)
        for i in range(20000)
    )
    while sum(map(len, pieces)) < 2 * total // 3:
        pieces.append(rec)
    # Binary: low-entropy bytes and some noise.
    pieces.append(rng.integers(0, 16, total // 6, dtype=np.uint8).tobytes())
    pieces.append(rng.integers(0, 256, total // 6, dtype=np.uint8).tobytes())
    return b"".join(pieces)[:total]
