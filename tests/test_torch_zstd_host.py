"""The port's zstd host route (``ZstdOptions(device_lz=False)``) against the
JAX package's (``compu_tpu``) on the CPU.

Every frame is bytes, so every comparison is exact (tolerance 0):

* levels -5..22, window_log 17 and 20, the checksum on and off, and every
  ``ZstdStrategy``: the frame equals the reference's with the same
  options, and ``zstandard`` decodes it;
* inputs fed with flushes between pieces, so that a block parses against
  the previous blocks' window (the history path, level >= 5) and a chunk
  of more than 49,152 bytes shares one chain walk (level >= 12);
* window_log 10-16, where the port cuts frame blocks at 2^window_log (the
  reference's frames there are refused by stock zstd): ``zstandard`` and
  the port's decoder give the data back;
* the host runtime's cost-model parse and repeat-offset promotion equal
  their Python twins;
* ``tests/test_zstd.py``'s encoder cases and ``tests/test_options_knobs.py``'s
  zstd cases, on the host route.

Inputs are made from a numpy seed (corpus slices and random bytes), at
most 96 KiB each. The reference is imported inside the tests, so the file
imports neither JAX nor ``compu_tpu`` at collection.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import decoder  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, EncodeStatus, Interface  # noqa: E402
from compu_tpu_torch.formats.zstd import encode as zenc  # noqa: E402
from compu_tpu_torch.formats.zstd import native_enc as znative  # noqa: E402
from compu_tpu_torch.formats.zstd.options import (  # noqa: E402
    ZstdDecodeOptions,
    ZstdOptions,
    ZstdStrategy,
)
from compu_tpu_torch.utils.corpus import build_corpus  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
LEVELS = [-5, 0, 1, 3, 9, 12, 19, 22]


@functools.lru_cache(maxsize=1)
def _corpus() -> bytes:
    return build_corpus(1 << 20)


def sample(n: int, seed: int) -> bytes:
    """``n`` bytes from a numpy seed: slices of the benchmark corpus (text,
    records, low-entropy bytes) at random offsets, and random bytes."""
    rng = np.random.default_rng(seed)
    c = _corpus()
    out = bytearray()
    while len(out) < n:
        if rng.random() < 0.15:
            out += rng.integers(0, 256, int(rng.integers(64, 2048)), dtype=np.uint8).tobytes()
        else:
            k = int(rng.integers(2048, 16384))
            at = int(rng.integers(0, len(c) * 5 // 6 - k))
            out += c[at:at + k]
    return bytes(out[:n])


def port_frame(data: bytes, pieces=None, **opts) -> bytes:
    """The port's frame of ``data``, one-shot or fed in ``pieces`` with a
    flush after each."""
    enc = Interface.zstd(ZstdOptions(device_lz=False, **opts))
    vec = ByteVec()
    for piece in pieces or []:
        enc.encode_vec_full(piece, vec, EncodeOp.Flush)
    res = enc.encode_vec_full(b"" if pieces else data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished, res
    return vec.data()


def ref_frame(data: bytes, pieces=None, strategy=None, **opts) -> bytes:
    """The reference's host-route frame, fed as ``port_frame`` feeds."""
    import compu_tpu
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions
    from compu_tpu.formats.zstd.options import ZstdStrategy as RefStrategy

    if strategy is not None:
        opts["strategy"] = RefStrategy(strategy.value)
    enc = compu_tpu.encoder.Interface.zstd(RefOptions(device_lz=False, **opts))
    vec = compu_tpu.ByteVec()
    for piece in pieces or []:
        enc.encode_vec_full(piece, vec, compu_tpu.EncodeOp.Flush)
    enc.encode_vec_full(b"" if pieces else data, vec, compu_tpu.EncodeOp.Finish)
    return vec.data()


def zstd_decode(frame: bytes, n: int) -> bytes:
    import zstandard

    return zstandard.ZstdDecompressor().decompress(frame, max_output_size=n)


def port_decode(frame: bytes) -> bytes:
    vec = ByteVec()
    dec = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=False), device="cpu")
    res = dec.decode_vec_full(frame, vec)
    assert res.status is decoder.DecodeStatus.Finished, res
    return vec.data()


@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("window_log", [17, 20])
@pytest.mark.parametrize("level", LEVELS)
def test_levels_equal_reference(level, window_log, checksum):
    data = sample(96 << 10 if level >= 12 else 40 << 10, level + 100)
    got = port_frame(data, level=level, window_log=window_log, checksum=checksum)
    assert got == ref_frame(data, level=level, window_log=window_log, checksum=checksum)
    assert zstd_decode(got, len(data)) == data


@pytest.mark.parametrize("strategy", list(ZstdStrategy))
def test_strategies_equal_reference(strategy):
    data = sample(48 << 10, strategy.value)
    got = port_frame(data, level=3, strategy=strategy)
    assert got == ref_frame(data, level=3, strategy=strategy)
    assert zstd_decode(got, len(data)) == data


@pytest.mark.parametrize("level", [3, 5, 9, 12, 19])
def test_flushed_pieces_equal_reference(monkeypatch, level):
    """Pieces with a flush after each: every piece is a block (or, from
    level 12 above 49,152 bytes, sub-blocks over one chain walk) whose
    matches reach into the earlier pieces' window from level 5."""
    data = sample(96 << 10, 7 * level)
    cuts = [0, 60_000, 61_000, 80_000, len(data)]
    pieces = [data[a:b] for a, b in zip(cuts, cuts[1:])]
    routes = []
    block = zenc.compress_block

    def spy(data, level, **kw):
        routes.append((len(kw.get("history", b"")), kw.get("matches") is not None))
        return block(data, level, **kw)

    monkeypatch.setattr(zenc, "compress_block", spy)
    got = port_frame(data, pieces, level=level)
    assert got == ref_frame(data, pieces, level=level)
    assert zstd_decode(got, len(data)) == data
    assert port_decode(got) == data
    assert any(h > 0 for h, _ in routes) == (level >= 5)
    assert any(m for _, m in routes) == (level >= 12)


@pytest.mark.parametrize("window_log", [10, 11, 12, 13, 14, 15, 16])
def test_small_windows_decode(window_log):
    """Frame blocks of at most 2^window_log bytes (RFC 8878's
    Block_Maximum_Size): zstandard and the port's decoder read them."""
    data = sample(40 << 10, window_log)
    for level in (3, 19):
        got = port_frame(data, level=level, window_log=window_log)
        assert zstd_decode(got, len(data)) == data
        assert port_decode(got) == data


def test_optimal_parse_equals_python_twin(monkeypatch):
    """Every round of the cost-model parse through the host runtime equals
    ``_optimal_dp_py`` on the same arguments, with a history prefix and a
    carried repeat offset; and the parse equals the reference's."""
    from compu_tpu.formats.zstd import encode as ref_enc

    full = np.frombuffer(sample(6000, 3), np.uint8)
    calls = []
    native = znative.optimal_parse

    def spy(*args):
        out = native(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(znative, "optimal_parse", spy)
    for hist, level, rep in ((0, 9, None), (2000, 19, [7, 4, 8])):
        calls.clear()
        got = zenc._zstd_optimal_tokens(full, hist, level, 1 << 17, rep_in=rep)
        want = ref_enc._zstd_optimal_tokens(full, hist, level, 1 << 17, rep_in=rep)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert len(calls) == (3 if level >= 15 else 2)
        for args, out in calls:
            twin = zenc._optimal_dp_py(*args)
            assert all(np.array_equal(a, b) for a, b in zip(out, twin))


@pytest.mark.parametrize("nseq", [40, 300])
def test_promote_rep_offsets_equals_reference(nseq):
    """The promotion's Python loop (64 sequences or fewer) and the host
    runtime's (more) equal the reference's on sequences of a real parse."""
    from compu_tpu.formats.zstd import encode as ref_enc

    data = sample(40_000, nseq)
    full = np.frombuffer(data, np.uint8)
    tok = zenc._zstd_optimal_tokens(full, 20_000, 9, 1 << 17)
    _, seqs = zenc._sequences_from_tokens(full[20_000:], *tok)
    seqs = [tuple(int(v) for v in s) for s in seqs][:nseq]
    assert len(seqs) == nseq
    got = np.asarray(zenc._promote_rep_offsets(full, 20_000, seqs, [3, 9, 27]), np.int64)
    want = np.asarray(ref_enc._promote_rep_offsets(full, 20_000, seqs, [3, 9, 27]), np.int64)
    assert np.array_equal(got, want)
    assert np.array_equal(znative.promote_rep(full.tobytes(), 20_000, seqs, [3, 9, 27]), got)


def test_defaults_take_the_device_route():
    """``device_lz`` defaults to True in the port (the reference's default
    is False): ``Interface.zstd()`` and ``Interface.brotli()`` run the
    device LZ stage unless asked for the host."""
    from compu_tpu_torch.formats.brotli.options import BrotliOptions

    assert ZstdOptions().device_lz is True
    assert BrotliOptions().device_lz is True
    enc = Interface.zstd(device="cpu")
    assert enc._backend._stream.tokenizer is not None
    assert enc._backend.block_size == enc._backend._stream.tokenizer_span


@pytest.mark.parametrize("fmt", ["zstd", "brotli"])
def test_host_route_builds_no_tokenizer(monkeypatch, fmt):
    """A host-route encode on the CPU makes no ``DeviceTokenizer`` and
    names no device; its frame decodes."""
    from compu_tpu_torch.formats import device_lz
    from compu_tpu_torch.formats.brotli.options import BrotliOptions

    def refuse(*args, **kwargs):
        raise AssertionError("a host-route encode made a DeviceTokenizer")

    monkeypatch.setattr(device_lz.DeviceTokenizer, "__init__", refuse)
    data = sample(30_000, 11)
    if fmt == "zstd":
        enc = Interface.zstd(ZstdOptions(level=19, device_lz=False))
        assert enc._backend.block_size == zenc.MAX_BLOCK
    else:
        enc = Interface.brotli(BrotliOptions(quality=5, device_lz=False))
    stream = enc._backend._stream
    vec = ByteVec()
    assert enc.encode_vec_full(data, vec, EncodeOp.Finish).status is EncodeStatus.Finished
    assert stream.tokenizer is None and stream.device is None
    if fmt == "zstd":
        assert zstd_decode(vec.data(), len(data)) == data
    else:
        out = ByteVec()
        decoder.Interface.brotli().decode_vec_full(vec.data(), out)
        assert out.data() == data


# -- tests/test_zstd.py's encoder cases, on the host route ------------------------------
ALICE96 = ALICE[: 96 << 10]


@pytest.mark.parametrize("level", [1, 3, 6, 12])
def test_libzstd_accepts_our_streams(level):
    got = port_frame(ALICE96, level=level)
    assert zstd_decode(got, len(ALICE96)) == ALICE96
    assert got == ref_frame(ALICE96, level=level)


def test_multi_block_stream():
    """More than two frame blocks: three flushed pieces of the 96 KiB."""
    pieces = [ALICE96[:40_000], ALICE96[40_000:70_000], ALICE96[70_000:]]
    got = port_frame(ALICE96, pieces, level=3)
    assert zstd_decode(got, len(ALICE96)) == ALICE96
    assert port_decode(got) == ALICE96


def test_window_log_cap():
    got = port_frame(ALICE96, window_log=20)
    vec = ByteVec()
    dec = decoder.Interface.zstd(ZstdDecodeOptions(window_log_max=10, device_literals=False),
                                 device="cpu")
    assert dec.decode_vec_full(got, vec).is_error  # window beyond the configured cap


def test_corrupt_checksum():
    blob = bytearray(port_frame(ALICE96, checksum=True))
    blob[-1] ^= 0xFF
    dec = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=False), device="cpu")
    result = dec.decode_vec_full(bytes(blob), ByteVec())
    assert result.is_error
    assert dec.describe_error(result.status) is not None


@pytest.mark.parametrize("kind", ["run", "noise"])
def test_rle_and_raw_blocks(kind):
    data = (b"a" * 70_000 if kind == "run"
            else np.random.default_rng(1).integers(0, 256, 4096, dtype=np.uint8).tobytes())
    got = port_frame(data)
    assert got == ref_frame(data)
    assert zstd_decode(got, len(data)) == data
    assert port_decode(got) == data


# -- tests/test_options_knobs.py's zstd cases, on the host route ------------------------
def test_zstd_strategy_changes_output_and_roundtrips():
    sizes = {}
    for strat in (ZstdStrategy.Fast, ZstdStrategy.Greedy, ZstdStrategy.BtOpt):
        blob = port_frame(ALICE96, level=3, strategy=strat)
        assert port_decode(blob) == ALICE96
        sizes[strat] = len(blob)
    # A stronger strategy at the same level must compress harder.
    assert sizes[ZstdStrategy.BtOpt] < sizes[ZstdStrategy.Fast]
    assert sizes[ZstdStrategy.Greedy] != sizes[ZstdStrategy.Fast]


def test_zstd_negative_and_zero_levels():
    blob_fast = port_frame(ALICE96, level=-5)
    blob_zero = port_frame(ALICE96, level=0)
    blob_mid = port_frame(ALICE96, level=9)
    assert port_decode(blob_fast) == ALICE96
    assert port_decode(blob_zero) == ALICE96
    # fast levels trade ratio away; level 0 behaves like the default (3)
    assert len(blob_fast) > len(blob_mid)
    assert len(blob_zero) == len(port_frame(ALICE96, level=3))
    with pytest.raises(ValueError):
        ZstdOptions(level=-131073)
    with pytest.raises(ValueError):
        ZstdOptions(level=23)
