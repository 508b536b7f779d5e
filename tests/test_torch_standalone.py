"""The port stands alone: it imports nothing of the JAX package, of JAX or
of ``bench``, and its copies of the reference's host pieces (the corpus
builder, the checksum algebra, the block index) give the reference's
values on the CPU.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch.ops import checksum  # noqa: E402
from compu_tpu_torch.parallel.scheduler import BlockIndex  # noqa: E402
from compu_tpu_torch.utils.corpus import build_corpus  # noqa: E402

FORBIDDEN = ("compu_tpu", "jax", "jaxlib", "bench")


def test_port_and_smoke_imports_stand_alone(tmp_path):
    """Every module of compu_tpu_torch, and chip_smoke's imports (the
    module without its main), in a fresh interpreter started outside the
    repository: none of the forbidden packages is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import compu_tpu_torch\n"
        "for m in pkgutil.walk_packages(compu_tpu_torch.__path__, 'compu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('standalone-ok', len([m for m in sys.modules if m.startswith('compu_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone-ok" in proc.stdout


def test_corpus_equals_bench(monkeypatch):
    """The port's corpus is bench.build_corpus's, byte for byte; the
    reference reads its text from the working directory, the copy from the
    repository root."""
    monkeypatch.chdir(ROOT)
    import bench

    assert build_corpus(1 << 20) == bench.build_corpus(1 << 20)


def test_corpus_independent_of_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    corpus = build_corpus(1 << 16)
    assert len(corpus) == 1 << 16
    assert corpus[:100] == (ROOT / "tests" / "data" / "alice29.txt").read_bytes()[:100]


def _pairs(seed, count=8):
    """Seeded (value1, value2, length) triples, lengths from 0 to 2^24."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 255, 1 << 18, *rng.integers(0, 1 << 24, count - 4).tolist()]
    return [(int(a), int(b), int(n)) for a, b, n in
            zip(rng.integers(0, 1 << 32, count, dtype=np.uint64),
                rng.integers(0, 1 << 32, count, dtype=np.uint64), lens)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_combine_equals_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, b, n in _pairs(seed):
        assert checksum.crc32_combine(a, b, n) == ref.crc32_combine(a, b, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adler32_combine_equals_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, b, n in _pairs(seed):
        assert checksum.adler32_combine(a, b, n) == ref.adler32_combine(a, b, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc_shift_unshift_equal_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, _, n in _pairs(seed):
        shifted = checksum.crc_shift(a, n)
        assert shifted == ref.crc_shift(a, n)
        assert checksum.crc_unshift(shifted, n) == ref.crc_unshift(shifted, n) == a


def test_checksum_tables_equal_reference():
    from compu_tpu.ops import checksum as ref

    assert checksum.ADLER_MOD == ref.ADLER_MOD
    assert np.array_equal(checksum.CRC_TABLE, ref.CRC_TABLE)
    for n in (1, 7, 1024):
        assert np.array_equal(checksum.zero_shift_operator(n), ref.zero_shift_operator(n))
    op = checksum.zero_shift_operator(3)
    assert np.array_equal(checksum._gf2_matmul(op, op), ref._gf2_matmul(op, op))


def test_combines_give_zlib_values():
    """Combining per-block checksums gives the stream's, as the framing
    relies on."""
    import zlib

    data = (ROOT / "tests" / "data" / "alice29.txt").read_bytes()[:50_000]
    a, b = data[:12_345], data[12_345:]
    assert checksum.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(data)
    assert checksum.adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                    len(b)) == zlib.adler32(data)


@pytest.mark.parametrize("mode", ["zlib", "gzip", "deflate"])
def test_stream_header_equals_reference(mode):
    """The port's one header function gives the reference framing's header
    at every level; at level 6 it is also the reference scheduler's."""
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.formats.deflate.options import ZlibOptions as RefOptions
    from compu_tpu.formats.deflate.pipeline import DeflateEncoder as RefEncoder
    from compu_tpu_torch.formats.deflate.options import ZlibMode, stream_header

    for level in range(10):
        ref = RefEncoder(RefOptions(mode=RefMode(mode), level=level))._header()
        assert stream_header(ZlibMode(mode), level) == ref


def test_block_index_bytes_equal_reference():
    from compu_tpu.parallel.scheduler import BlockIndex as RefIndex

    fields = ([1 << 18, 5], [2, 70_000], [69_998, 12])
    blob = BlockIndex(*fields).to_bytes()
    assert blob == RefIndex(*fields).to_bytes()
    back = BlockIndex.from_bytes(blob)
    assert (back.raw_lengths, back.compressed_offsets, back.compressed_lengths) == fields
