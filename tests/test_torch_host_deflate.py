"""The port's host DEFLATE pair, ``encoder.Interface.zlib()`` /
``zlib_native()`` and ``decoder.Interface.zlib()`` / ``zlib_native()``,
against the JAX package's (``compu_tpu``) on the CPU: every level,
strategy, two ``mem_level`` values and the three framings give the
reference's bytes, which stdlib ``zlib`` decodes; chunked feeds of 1, 7 and
65,536 bytes give the one-shot bytes; the decoders give the reference's
bytes, statuses, error codes and remaining counts on the golden fixtures
and on truncated, corrupted and trailing-garbage streams. Inputs are made
from a numpy seed; every comparison is exact. Also the state machine's
cases of ``tests/test_state_machine.py`` on the port's host backends,
``BlockParallelDecoder(host=True)`` and the dry run's ``Inflate`` decode.
"""

import pathlib
import sys
import zlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch import decoder, encoder  # noqa: E402
from compu_tpu_torch.buffer import Buffer  # noqa: E402
from compu_tpu_torch.detection import Detection  # noqa: E402
from compu_tpu_torch.formats.deflate.options import (  # noqa: E402
    ZlibMode, ZlibOptions, ZlibStrategy)
from compu_tpu_torch.status import (  # noqa: E402
    DecodeError, DecodeStatus, EncodeOp, EncodeStatus)
from compu_tpu_torch.vec import ByteVec  # noqa: E402

DATA = ROOT / "tests" / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
TINY = b"X" * 10 + b"Y" * 10
MODES = ("zlib", "gzip", "deflate")


def corpus(n: int, seed: int) -> bytes:
    """``n`` bytes from a numpy seed: text cut from alice29 at random
    offsets, runs of one byte, repeats at random distances, noise."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind = int(rng.integers(0, 4))
        k = int(rng.integers(8, 600))
        if kind == 0:
            at = int(rng.integers(0, len(ALICE) - k))
            out += ALICE[at:at + k]
        elif kind == 1:
            out += bytes([int(rng.integers(0, 256))]) * k
        elif kind == 2 and len(out) > 16:
            d = int(rng.integers(1, min(len(out), 30_000) + 1))
            for _ in range(k):
                out.append(out[-d])
        else:
            out += rng.integers(0, 256, k // 4, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def _ref():
    import compu_tpu
    from compu_tpu.formats.deflate import options

    return compu_tpu, options


def _status(res):
    """A decode result's status as comparable across the two packages."""
    return ("error", res.status.code) if res.is_error else res.status.name


def port_encode(data: bytes, native: bool = False, **opts) -> bytes:
    mode = opts.pop("mode", "zlib")
    make = encoder.Interface.zlib_native if native else encoder.Interface.zlib
    vec = ByteVec()
    res = make(ZlibOptions(mode=ZlibMode(mode), **opts)).encode_vec_full(data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    return vec.data()


def ref_encode(data: bytes, native: bool = False, **opts) -> bytes:
    ct, o = _ref()
    mode = opts.pop("mode", "zlib")
    if "strategy" in opts:
        opts["strategy"] = o.ZlibStrategy(opts["strategy"].value)
    make = ct.encoder.Interface.zlib_native if native else ct.encoder.Interface.zlib
    vec = ct.ByteVec()
    make(o.ZlibOptions(mode=o.ZlibMode(mode), **opts)).encode_vec_full(data, vec, ct.EncodeOp.Finish)
    return vec.data()


def stdlib_decode(blob: bytes, mode: str) -> bytes:
    return zlib.decompress(blob, wbits={"zlib": 15, "gzip": 31, "deflate": -15}[mode])


# -- the encoders -----------------------------------------------------------------
@pytest.mark.parametrize("level", range(10))
@pytest.mark.parametrize("mode", MODES)
def test_zlib_encode_equals_reference(level, mode):
    """Both host encoders at every level and framing: the reference's
    bytes; stdlib zlib gives the input back."""
    data = corpus(48_000, level)
    for native in (False, True):
        got = port_encode(data, native, mode=mode, level=level)
        assert got == ref_encode(data, native, mode=mode, level=level)
        assert stdlib_decode(got, mode) == data


@pytest.mark.parametrize("strategy", list(ZlibStrategy))
@pytest.mark.parametrize("mem_level", [8, 4])
def test_zlib_strategies_and_mem_levels_equal_reference(strategy, mem_level):
    mode = MODES[(len(strategy.value) + mem_level) % 3]
    data = corpus(40_000, mem_level)
    got = port_encode(data, mode=mode, level=6, strategy=strategy, mem_level=mem_level)
    assert got == ref_encode(data, mode=mode, level=6, strategy=strategy, mem_level=mem_level)
    assert stdlib_decode(got, mode) == data
    got = port_encode(data, True, mode=mode, level=6, strategy=strategy, mem_level=mem_level)
    assert got == ref_encode(data, True, mode=mode, level=6, strategy=strategy,
                             mem_level=mem_level)
    assert stdlib_decode(got, mode) == data


def _feed(enc, data: bytes, chunk: int, flush_at: int, ops=EncodeOp) -> bytes:
    """``data[:flush_at]`` fed ``chunk`` bytes a Process call into a 4 KiB
    output buffer, a Flush, the rest fed the same way, then a Finish with
    no input; returns every byte written. ``ops`` is the encoder's package's
    ``EncodeOp``."""
    out = bytearray()
    buf = bytearray(4096)

    def call(piece, op):
        while True:
            res = enc.encode(piece, buf, op)
            out.extend(buf[: len(buf) - res.output_remain])
            piece = piece[len(piece) - res.input_remain:]
            if res.status.name != "NeedOutput" and not piece:
                return res.status.name

    def feed(part):
        for at in range(0, len(part), chunk):
            call(part[at: at + chunk], ops.Process)

    feed(memoryview(data)[:flush_at])
    assert call(b"", ops.Flush) == "Continue"
    feed(memoryview(data)[flush_at:])
    assert call(b"", ops.Finish) == "Finished"
    return bytes(out)


@pytest.mark.parametrize("level", range(10))
@pytest.mark.parametrize("chunk", [1, 7, 65_536])
def test_chunked_encode_equals_one_shot(level, chunk):
    """The bit carry across pipeline blocks (cut here at 16 KiB) and
    across a Flush: chunked feeds give the one-shot bytes, and both
    encoders give the reference's."""
    ct, o = _ref()
    mode = MODES[level % 3]
    data = corpus(40_000 if chunk > 1 else 20_000, 100 + level)
    for native in (False, True):
        make = encoder.Interface.zlib_native if native else encoder.Interface.zlib
        ref_make = ct.encoder.Interface.zlib_native if native else ct.encoder.Interface.zlib
        opts = dict(mode=mode, level=level)
        encs = [make(ZlibOptions(**{**opts, "mode": ZlibMode(mode)})) for _ in range(2)]
        ref = ref_make(o.ZlibOptions(mode=o.ZlibMode(mode), level=level))
        for e in (*encs, ref):
            e._backend.block_size = 1 << 14
        one_shot = _feed(encs[0], data, len(data), flush_at=len(data) // 3)
        assert _feed(encs[1], data, chunk, flush_at=len(data) // 3) == one_shot
        assert _feed(ref, data, chunk, len(data) // 3, ct.EncodeOp) == one_shot
        assert stdlib_decode(one_shot, mode) == data


@pytest.mark.parametrize("seed", range(4))
def test_long_stored_run_after_a_partial_byte(seed):
    """A stored run past 65,535 bytes (two stored blocks) that starts
    mid-byte, after a Huffman block: every block after the first starts
    byte-aligned, so only the first pads. The reference pads each from the
    carried bits and writes a stream stdlib zlib refuses (a repair in the
    port; the 16 MB smoke corpus has such a run); both of the port's
    encoders' streams decode, by stdlib zlib and both port decoders."""
    ct, o = _ref()
    rng = np.random.default_rng(seed)
    data = (ALICE[: 30_000 + 777 * seed] + rng.integers(0, 256, 110_000, np.uint8).tobytes()
            + ALICE[:20_000])
    got = port_encode(data, level=6)
    ref = ref_encode(data, level=6)
    assert got != ref
    with pytest.raises(zlib.error):
        zlib.decompress(ref)
    for stream in (got, port_encode(data, True, level=6)):
        assert zlib.decompress(stream) == data
        for kind in DECODERS:
            assert decode_full(port_decoder(kind), stream, ByteVec) == ("Finished", 0, data)
    head = 30_000 + 777 * seed  # the same bytes with the run cut short equal the reference's
    assert port_encode(data[: head + 60_000], level=6) == ref_encode(data[: head + 60_000], level=6)


def test_multi_block_stream_equals_reference():
    """More than one 1 MiB pipeline block: the window resets a block, the
    bits carry on; the stream is the reference's and decodes."""
    data = (ALICE * 8)[: (1 << 20) + 131_072]
    got = port_encode(data, level=6)
    assert got == ref_encode(data, level=6)
    assert zlib.decompress(got) == data
    vec = ByteVec()
    assert decoder.Interface.zlib_native().decode_vec_full(got, vec).status is DecodeStatus.Finished
    assert vec.data() == data


# -- the decoders -------------------------------------------------------------------
DECODERS = ["zlib", "zlib_native"]


def port_decoder(kind, mode="auto"):
    return getattr(decoder.Interface, kind)(ZlibMode(mode))


def ref_decoder(kind, mode="auto"):
    ct, o = _ref()
    return getattr(ct.decoder.Interface, kind)(o.ZlibMode(mode))


def decode_full(dec, blob, vec_cls):
    vec = vec_cls()
    res = dec.decode_vec_full(blob, vec)
    return _status(res), res.input_remain, vec.data()


@pytest.mark.parametrize("kind", DECODERS)
@pytest.mark.parametrize("fixture,plain", [("alice29.txt.gz", "alice29.txt"),
                                           ("10x10y.gz", "10x10y"),
                                           ("alice29.txt.zz", "alice29.txt"),
                                           ("10x10y.zz", "10x10y")])
def test_golden_fixture_decodes_as_reference(kind, fixture, plain):
    ct, _ = _ref()
    blob = (DATA / fixture).read_bytes()
    got = decode_full(port_decoder(kind), blob, ByteVec)
    assert got == ("Finished", 0, (DATA / plain).read_bytes())
    assert got == decode_full(ref_decoder(kind), blob, ct.ByteVec)


@pytest.mark.parametrize("kind", DECODERS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("damage", ["truncate", "flip", "trailing"])
def test_damaged_stream_decodes_as_reference(kind, mode, damage):
    """Truncated streams (NeedInput, never a false Finished), flipped bytes
    (the reference's error code or output) and trailing garbage (Finished
    with the garbage left in ``input_remain``), each as the reference."""
    ct, _ = _ref()
    data = corpus(30_000, len(mode))
    blob = zlib.compressobj(6, zlib.DEFLATED, {"zlib": 15, "gzip": 31, "deflate": -15}[mode])
    blob = blob.compress(data) + blob.flush()
    rng = np.random.default_rng(hash((kind, mode, damage)) % 2**32)
    for trial in range(10):
        bad = bytearray(blob)
        if damage == "truncate":
            del bad[int(rng.integers(1, len(bad))):]
        elif damage == "flip":
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        else:
            bad += rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        got = decode_full(port_decoder(kind, mode), bytes(bad), ByteVec)
        assert got == decode_full(ref_decoder(kind, mode), bytes(bad), ct.ByteVec), trial
        if damage == "truncate" and mode != "deflate":
            assert got[0] == "NeedInput"
        if damage == "trailing":
            assert got[0] == "Finished" and got[1] > 0 and got[2] == data


@pytest.mark.parametrize("kind", DECODERS)
def test_describe_error_equals_reference(kind):
    """Every error code's message, the sticky error until ``reset``, and
    an error's code on a bad header, as the reference's."""
    from compu_tpu_torch.formats.deflate.inflate import ERRORS

    dec, ref = port_decoder(kind), ref_decoder(kind)
    for code in (0, *ERRORS, 999):
        assert dec.describe_error(code) == ref.describe_error(code)
    res = dec.decode(b"\x00\x01not a stream", bytearray(64))
    assert res.is_error and res.status == DecodeError(101)
    assert dec.describe_error(res.status) == "invalid stream header"
    assert dec.decode(zlib.compress(b"abc"), bytearray(64)).status == DecodeError(101)
    assert dec.reset()
    assert dec.decode(zlib.compress(b"abc"), bytearray(64)).status is DecodeStatus.Finished


@pytest.mark.parametrize("kind", DECODERS)
@pytest.mark.parametrize("chunk", [1, 7, 65_536])
@pytest.mark.parametrize("out_size", [1, 4096])
def test_chunked_decode_equals_reference(kind, chunk, out_size):
    """Feeds of 1, 7 and 65,536 bytes into outputs of 1 and 4096 bytes:
    every call's status and counts equal the reference's, NeedInput between
    chunks, and the bytes are the input (the native decoder stages a
    partial token's tail and rebases its position)."""
    ct, _ = _ref()
    n = 6_000 if chunk == 1 or out_size == 1 else 60_000
    data = corpus(n, chunk + out_size)
    blob = zlib.compress(data, 9)
    runs = []
    for dec in (port_decoder(kind), ref_decoder(kind)):
        out, calls = bytearray(), []
        buf = bytearray(out_size)
        for at in range(0, len(blob), chunk):
            piece = memoryview(blob)[at: at + chunk]
            while True:
                res = dec.decode(piece, buf)
                out.extend(buf[: out_size - res.output_remain])
                calls.append((_status(res), res.input_remain, res.output_remain))
                piece = piece[len(piece) - res.input_remain:]
                if res.is_error or res.status.name != "NeedOutput":
                    break
            if calls[-1][0] == "Finished":
                break
        runs.append((calls, bytes(out)))
    assert runs[0] == runs[1]
    assert runs[0][1] == data and runs[0][0][-1][0] == "Finished"


@pytest.mark.parametrize("kind", DECODERS)
@pytest.mark.parametrize("mode", ["zlib", "gzip"])
def test_header_fed_a_byte_at_a_time(kind, mode):
    """A zlib header, and a gzip header with a file name and a comment, fed
    a byte a call with the framing given: both decoders give the input
    back. The reference's ``Inflate`` keeps the header bytes it has read
    when the header is cut and loses its place (a repair in the port, whose
    ``Inflate`` parses the header whole or not at all); its native decoder
    gives the input back, as the port's."""
    import gzip
    import io

    ct, _ = _ref()
    data = corpus(3_000, 21)
    if mode == "zlib":
        blob = zlib.compress(data, 6)
    else:
        raw = io.BytesIO()
        with gzip.GzipFile(filename="name.txt", mode="wb", fileobj=raw, mtime=0) as f:
            f.write(data)
        blob = bytearray(raw.getvalue())
        blob[3] |= 0x10  # FCOMMENT: a comment after the name
        name_end = blob.index(0, 10) + 1
        blob = bytes(blob[:name_end]) + b"a comment\0" + bytes(blob[name_end:])

    def by_bytes(dec):
        out, buf = bytearray(), bytearray(8192)
        for at in range(len(blob)):
            res = dec.decode(blob[at: at + 1], buf)
            out.extend(buf[: len(buf) - res.output_remain])
        return _status(res), bytes(out)

    assert by_bytes(port_decoder(kind, mode)) == ("Finished", data)
    ref = by_bytes(ref_decoder(kind, mode))
    assert (ref == ("Finished", data)) == (kind == "zlib_native")


def test_native_decoder_direct_path_streams_into_caller_buffer():
    """A one-shot decode through the direct path leaves nothing staged;
    a 1-byte-at-a-time decode of the same stream gives the same bytes."""
    data = corpus(50_000, 3)
    blob = zlib.compress(data, 6, wbits=31)
    dec = decoder.Interface.zlib_native(ZlibMode.Gzip)
    out = bytearray(len(data))
    res = dec.decode(blob, out)
    assert (res.status, res.input_remain, res.output_remain) == (DecodeStatus.Finished, 0, 0)
    assert bytes(out) == data and not dec._backend._staged


# -- the state machine, as tests/test_state_machine.py drives it ----------------------
def _enc(mode, native=False, level=6):
    make = encoder.Interface.zlib_native if native else encoder.Interface.zlib
    return lambda: make(ZlibOptions(mode=ZlibMode(mode), level=level))


def _dec(mode, native=False):
    make = decoder.Interface.zlib_native if native else decoder.Interface.zlib
    return lambda: make(ZlibMode(mode))


BACKENDS = [
    ("zlib", _enc("zlib"), _dec("zlib"), Detection.Zlib),
    ("gzip", _enc("gzip"), _dec("gzip"), Detection.Gzip),
    ("deflate-raw", _enc("deflate"), _dec("deflate"), Detection.Unknown),
    ("zlib-auto", _enc("zlib"), _dec("auto"), Detection.Zlib),
    ("gzip-auto", _enc("gzip"), _dec("auto"), Detection.Gzip),
    ("zlib-native", _enc("zlib"), _dec("zlib", True), Detection.Zlib),
    ("gzip-native", _enc("gzip"), _dec("gzip", True), Detection.Gzip),
    ("auto-native", _enc("zlib"), _dec("auto", True), Detection.Zlib),
    ("zlib-cenc", _enc("zlib", True), _dec("zlib"), Detection.Zlib),
    ("gzip-cenc", _enc("gzip", True), _dec("gzip"), Detection.Gzip),
    ("zlib-cenc-level0", _enc("zlib", True, 0), _dec("zlib", True), Detection.Zlib),
]


@pytest.mark.parametrize("name,make_enc,make_dec,detection", BACKENDS,
                         ids=[b[0] for b in BACKENDS])
def test_state_machine_roundtrip(name, make_enc, make_dec, detection):
    """The reference's state-machine cases on each host backend: one-shot
    encode (NeedOutput finalisation for tiny inputs), Buffer-chunked and
    ``encode_vec_full`` encodes equal to it, one-shot, partial-output,
    Buffer-chunked and ``decode_vec_full`` decodes, then the 3-op
    protocol with chunked decode and NeedInput between chunks."""
    for data in (TINY, ALICE[:60_000]):
        enc, dec = make_enc(), make_dec()
        buf = bytearray(len(data))
        res = enc.encode(data, buf, EncodeOp.Finish)
        assert res.input_remain == 0
        compressed = bytes(buf[: len(buf) - res.output_remain])
        if res.status is EncodeStatus.NeedOutput:
            extra = bytearray(len(data) + 4096)
            res2 = enc.encode(b"", extra, EncodeOp.Finish)
            assert res2.status is EncodeStatus.Finished
            compressed += bytes(extra[: len(extra) - res2.output_remain])
        else:
            assert res.status is EncodeStatus.Finished
        assert Detection.detect(compressed) == detection

        out = bytearray(len(data))
        res = dec.decode(compressed, out)
        assert (res.status, res.input_remain, res.output_remain) == (DecodeStatus.Finished, 0, 0)
        assert bytes(out) == data

        assert enc.reset()
        buffer, chunked, rest = Buffer(4096), bytearray(), memoryview(data)
        while True:
            consumed, st = buffer.encode(enc, rest, EncodeOp.Finish)
            rest = rest[consumed:]
            chunked.extend(buffer.data())
            buffer.consume()
            if st.status is EncodeStatus.Finished:
                break
        assert bytes(chunked) == compressed
        assert enc.reset()
        vec = ByteVec()
        assert enc.encode_vec_full(data, vec, EncodeOp.Finish).status is EncodeStatus.Finished
        assert vec.data() == compressed

        assert dec.reset()
        out = bytearray(len(data))
        half = len(data) // 2
        res = dec.decode(compressed, memoryview(out)[:half])
        assert res.status is DecodeStatus.NeedOutput and res.output_remain == 0
        res = dec.decode(compressed[len(compressed) - res.input_remain:], memoryview(out)[half:])
        assert res.status is DecodeStatus.Finished and bytes(out) == data

        assert dec.reset()
        buffer, decoded, rest = Buffer(4096), bytearray(), memoryview(compressed)
        while True:
            consumed, res = buffer.decode(dec, rest)
            assert not res.is_error
            rest = rest[consumed:]
            decoded.extend(buffer.data())
            buffer.consume()
            if res.status is DecodeStatus.Finished:
                break
        assert bytes(decoded) == data

        enc, dec = make_enc(), make_dec()
        blob = ByteVec()
        blob.reserve_exact(len(data) + 4096)
        assert enc.encode_vec(data, blob, EncodeOp.Process).status is not EncodeStatus.Error
        res = enc.encode_vec(b"", blob, EncodeOp.Flush)
        assert res.status is EncodeStatus.Continue and res.input_remain == 0
        blob.reserve_exact(4096)
        assert enc.encode_vec(b"", blob, EncodeOp.Finish).status is EncodeStatus.Finished
        blob = blob.data()
        decoded = ByteVec()
        decoded.reserve_exact(len(data) + 100)
        step = max(1, len(blob) // 4)
        for at in range(0, len(blob), step):
            res = dec.decode_vec(blob[at: at + step], decoded)
            assert res.input_remain == 0 and not res.is_error
            if res.status is DecodeStatus.Finished:
                break
            assert res.status is DecodeStatus.NeedInput
        assert res.status is DecodeStatus.Finished and decoded.data() == data


# -- the block decoder's host route and the dry run ---------------------------------------
def test_block_parallel_host_decode_equals_reference():
    """``BlockParallelDecoder(host=True)``: every block through the host
    runtime's whole-block inflate gives the reference's host decode; a
    block cut short raises and marks that block failed."""
    from compu_tpu.parallel.scheduler import BlockIndex as RefIndex
    from compu_tpu.parallel.scheduler import BlockParallelDecoder as RefDecoder

    from compu_tpu_torch import BlockParallelDecoder, BlockParallelEncoder
    from compu_tpu_torch.parallel.scheduler import BlockState
    from compu_tpu_torch.formats.deflate.deflate_encode import DeflateStream
    from compu_tpu_torch.ops import checksum

    def block_fn(blocks, lens):
        outs, out_lens, checks = [], [], []
        for row, n in zip(blocks, lens):
            s = DeflateStream(6, ZlibStrategy.Default)
            raw = bytes(row[:n])
            blob = s.compress(raw, final=False) + s.sync_flush()
            outs.append(blob)
            out_lens.append(len(blob))
            checks.append(checksum.crc32(raw))
        width = max(out_lens)
        out = np.zeros((len(outs), width), np.uint8)
        for i, b in enumerate(outs):
            out[i, : len(b)] = np.frombuffer(b, np.uint8)
        return out, np.array(out_lens), np.array(checks, np.uint32)

    data = corpus(150_000, 11)
    stream, index = BlockParallelEncoder(block_fn, block_size=1 << 15,
                                         mode=ZlibMode.Gzip).encode(data)
    assert zlib.decompress(stream, wbits=31) == data
    dec = BlockParallelDecoder(block_size=1 << 15, host=True)
    got = dec.decode(stream, index)
    fields = (index.raw_lengths, index.compressed_offsets, index.compressed_lengths)
    assert got == data == RefDecoder(device=False).decode(stream, RefIndex(*fields))
    assert all(st.state == BlockState.Ok for st in dec.block_statuses)
    bad = bytearray(stream)
    off, clen = index.compressed_offsets[2], index.compressed_lengths[2]
    bad[off + clen // 2: off + clen] = bytes(clen - clen // 2)
    with pytest.raises(ValueError):
        dec.decode(bytes(bad), index)
    assert dec.block_statuses[2].state == BlockState.Failed


def test_dryrun_decodes_with_the_host_inflate(monkeypatch):
    """The one-rank dry run on the CPU decodes the gathered stream with the
    ported ``Inflate``, as the reference's dry run does."""
    from compu_tpu_torch import entry
    from compu_tpu_torch.formats.deflate import inflate

    pumped = []
    real = inflate.Inflate.pump

    def pump(self, staged, pos):
        out = real(self, staged, pos)
        pumped.append((self.mode, out[1], len(self.sink)))
        return out

    monkeypatch.setattr(inflate.Inflate, "pump", pump)
    entry.dryrun_multichip(1, device="cpu")
    assert pumped and pumped[-1][:2] == (ZlibMode.Deflate, True)
    assert pumped[-1][2] == len(entry._dryrun_payloads(1)[0][0])
