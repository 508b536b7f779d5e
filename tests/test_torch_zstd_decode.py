"""The port's zstd decoder against the JAX reference, on the CPU: whole
frames through ``decoder.Interface.zstd`` (bytes, statuses, remainders and
error codes), kernel P2's plain version against the reference's
``_decode_lanes``, corrupt 4-stream literal sections on both routes, and
the RFC 8878 block limit (fault C1) on both sides.

Every output is bytes or integers, so every comparison is exact
(tolerance 0). Inputs are made with numpy from a seed, ``zstandard`` or
the port's own encoder. The tests marked ``gpu`` hold the CUDA kernel to
its plain version and the card's decode to the CPU's.
"""

import functools
import math
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import DecodeError, DecodeStatus, decoder  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface  # noqa: E402
from compu_tpu_torch.formats.base import CodecFailure  # noqa: E402
from compu_tpu_torch.formats.zstd import decode as port_dec  # noqa: E402
from compu_tpu_torch.formats.zstd import huff  # noqa: E402
from compu_tpu_torch.formats.zstd.options import ZstdDecodeOptions, ZstdOptions  # noqa: E402
from compu_tpu_torch.kernels import zstd_lit_decode as p2  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
DEVICE_ALL = dict(device_literals=True, device_sequences=True)


@pytest.fixture
def jax_cpu(monkeypatch):
    """The JAX reference on the CPU (tests/conftest.py pins the platform),
    with its native host helpers off."""
    pytest.importorskip("jax")
    from compu_tpu.runtime import native

    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=8)
def _port_frame(data: bytes, **opts) -> bytes:
    """The port's zstd frame of ``data`` on the CPU."""
    vec = ByteVec()
    Interface.zstd(ZstdOptions(**opts), device="cpu").encode_vec_full(data, vec, EncodeOp.Finish)
    return vec.data()


def _zstandard(data: bytes, level: int, **kw) -> bytes:
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor(level=level, **kw).compress(data)


def _port_decode_full(blob: bytes, device="cpu", **opts):
    dec = decoder.Interface.zstd(ZstdDecodeOptions(**opts), device=device)
    vec = ByteVec()
    return dec.decode_vec_full(blob, vec), vec.data()


def _ref_decode_full(blob: bytes, **opts):
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import decoder as ref_decoder
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions as RefOptions

    dec = ref_decoder.Interface.zstd(RefOptions(**opts))
    vec = RefVec()
    return dec.decode_vec_full(blob, vec), vec.data()


def _same_result(port, ref) -> None:
    """A port ``Decode`` equals a reference one: the remainders, and the
    status by name or the error by code."""
    assert (port.input_remain, port.output_remain) == (ref.input_remain, ref.output_remain)
    if ref.is_error:
        assert port.is_error and port.status.code == ref.status.code
    else:
        assert not port.is_error and port.status.name == ref.status.name


# ---------------------------------------------------------------------------
# Whole frames through decoder.Interface.zstd
# ---------------------------------------------------------------------------

def _frames():
    """(name, blob, decode options) of the frames held to the reference.
    Frames a ``device_literals`` run decodes stay at 256 KiB or less: the
    reference compiles its lane loop again for every section length."""
    skippable = struct.pack("<II", 0x184D2A50, 5) + b"hello"
    noise = np.random.default_rng(1).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    corrupt = bytearray(_port_frame(TEXT[:30000], **DEVICE_ALL))
    corrupt[-1] ^= 0xFF
    return [
        ("alice29.txt.zst", (DATA / "alice29.txt.zst").read_bytes(), {}),
        ("10x10y.zst", (DATA / "10x10y.zst").read_bytes(), {}),
        ("zstandard-1", _zstandard(TEXT, 1), {}),
        ("zstandard-3", _zstandard(TEXT, 3), {}),
        ("zstandard-19", _zstandard(TEXT, 19), {}),
        ("zstandard-3-multiblock", _zstandard((TEXT * 2)[:250_000], 3), {}),
        ("zstandard-checksum-size", _zstandard(TEXT[:60000], 5, write_checksum=True,
                                                write_content_size=True), {}),
        ("zstandard-empty", _zstandard(b"", 3), {}),
        ("port-all-device", _port_frame(TEXT, **DEVICE_ALL), {}),
        ("port-rle-block", _port_frame(b"a" * 70_000), {}),
        ("port-raw-block", _port_frame(noise), {}),
        ("skippable", skippable + _zstandard(b"payload", 3), {}),
        ("corrupt-checksum", bytes(corrupt), {}),
        ("window-log-cap", _port_frame(TEXT[:5000], window_log=20), {"window_log_max": 10}),
        ("trailing-bytes", _zstandard(TEXT[:3000], 3) + b"\x01\x02\x03", {}),
        ("truncated", _zstandard(TEXT[:40000], 3)[:-100], {}),
    ]


_NAMES = ["alice29.txt.zst", "10x10y.zst", "zstandard-1", "zstandard-3", "zstandard-19",
          "zstandard-3-multiblock", "zstandard-checksum-size", "zstandard-empty",
          "port-all-device", "port-rle-block", "port-raw-block", "skippable",
          "corrupt-checksum", "window-log-cap", "trailing-bytes", "truncated"]


@functools.lru_cache(maxsize=1)
def _frame_table():
    table = {name: (blob, opts) for name, blob, opts in _frames()}
    assert list(table) == _NAMES
    return table


@pytest.mark.parametrize("device_literals", [False, True])
@pytest.mark.parametrize("name", _NAMES)
def test_decoder_equals_reference(jax_cpu, name, device_literals):
    blob, opts = _frame_table()[name]
    port, port_bytes = _port_decode_full(blob, device_literals=device_literals, **opts)
    ref, ref_bytes = _ref_decode_full(blob, device_literals=device_literals, **opts)
    _same_result(port, ref)
    assert port_bytes == ref_bytes


def test_frames_decode_as_expected():
    """What each frame decodes to, without the reference: the golden
    plain texts, zstandard's inputs, the errors."""
    table = _frame_table()
    for name, want in (("alice29.txt.zst", TEXT), ("10x10y.zst", (DATA / "10x10y").read_bytes()),
                       ("zstandard-19", TEXT), ("port-all-device", TEXT),
                       ("port-rle-block", b"a" * 70_000), ("skippable", b"payload"),
                       ("zstandard-empty", b"")):
        res, got = _port_decode_full(table[name][0], **table[name][1])
        assert res.status is DecodeStatus.Finished and got == want, name
    res, _ = _port_decode_full(table["corrupt-checksum"][0])
    assert res.status == DecodeError(port_dec.ERR_CHECKSUM)
    blob, opts = table["window-log-cap"]
    res, _ = _port_decode_full(blob, **opts)
    assert res.status == DecodeError(port_dec.ERR_WINDOW)
    res, _ = _port_decode_full(table["trailing-bytes"][0])
    assert res.status is DecodeStatus.Finished and res.input_remain == 3
    res, got = _port_decode_full(table["truncated"][0])
    assert res.status is DecodeStatus.NeedInput and TEXT.startswith(got)


@pytest.mark.parametrize("device_literals", [False, True])
def test_chunked_input_equals_reference(jax_cpu, device_literals):
    """4,096-byte pieces through ``decode_vec``: every call's remainders
    and status equal the reference's, and the bytes equal one shot's."""
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import decoder as ref_decoder
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions as RefOptions

    blob = _zstandard(TEXT, 3)
    port = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=device_literals),
                                  device="cpu")
    ref = ref_decoder.Interface.zstd(RefOptions(device_literals=device_literals))
    pv, rv = ByteVec(), RefVec()
    for i in range(0, len(blob), 4096):
        pv.reserve_exact(16384)
        rv.reserve_exact(16384)
        piece = blob[i:i + 4096]
        while True:
            p, r = port.decode_vec(piece, pv), ref.decode_vec(piece, rv)
            _same_result(p, r)
            if p.status is not DecodeStatus.NeedOutput:
                break
            piece = piece[len(piece) - p.input_remain:]
            pv.reserve_exact(16384)
            rv.reserve_exact(16384)
    assert p.status is DecodeStatus.Finished
    assert pv.data() == rv.data() == TEXT


@pytest.mark.parametrize("device_literals", [False, True])
def test_errors_are_sticky_until_reset(jax_cpu, device_literals):
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import decoder as ref_decoder
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions as RefOptions

    good = _zstandard(TEXT[:20000], 3)
    bad = b"\x00\x01\x02\x03" + good
    port = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=device_literals),
                                  device="cpu")
    ref = ref_decoder.Interface.zstd(RefOptions(device_literals=device_literals))
    for blob in (bad, good):
        p, r = port.decode_vec_full(blob, ByteVec()), ref.decode_vec_full(blob, RefVec())
        _same_result(p, r)
        assert p.status == DecodeError(port_dec.ERR_MAGIC)
    assert port.describe_error(p.status) == ref.describe_error(r.status) == "invalid zstd magic"
    assert port.reset() and ref.reset()
    pv = ByteVec()
    p, r = port.decode_vec_full(good, pv), ref.decode_vec_full(good, RefVec())
    _same_result(p, r)
    assert pv.data() == TEXT[:20000]


def test_decode_buf_and_registry():
    blob = _zstandard(TEXT, 3)
    sink = bytearray()
    dec = decoder.Interface.zstd(device="cpu")
    assert dec.decode_buf(blob, sink).status is DecodeStatus.Finished
    assert bytes(sink) == TEXT
    from compu_tpu_torch.formats.zstd.pipeline import ZstdDecoder

    decoder.Interface.register("zstd-cpu", lambda: ZstdDecoder(device="cpu"))
    assert decoder.Interface.new("zstd-cpu").name == "zstd"
    with pytest.raises(ValueError, match="unknown decoder"):
        decoder.Interface.new("nope")


def test_device_literals_without_a_device_raise():
    """With ``device_literals``, the default, and no device named, P2 runs
    on CUDA; with no card that raises, and nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dec in (decoder.Interface.zstd(), decoder.Interface.zstd(ZstdDecodeOptions())):
        with pytest.raises((RuntimeError, AssertionError)):
            dec.decode_vec_full(_zstandard(TEXT[:20000], 3), ByteVec())


def test_default_options_decode_literals_with_p2(monkeypatch):
    """``Interface.zstd(device=...)`` with no options decodes the 4-stream
    literal sections with P2 (its plain version on the CPU) and never with
    the host's ``HufTable.decode_stream``; ``device_literals=False`` is the
    host route."""
    assert ZstdDecodeOptions().device_literals
    blob = _zstandard(TEXT[:60000], 3)
    launches = []
    lanes = p2.huf_decode_lanes

    def counted(*args):
        launches.append(args[-1])
        return lanes(*args)

    monkeypatch.setattr(p2, "huf_decode_lanes", counted)
    host = huff.HufTable.decode_stream
    monkeypatch.setattr(huff.HufTable, "decode_stream", lambda *a: pytest.fail("host route"))
    res, got = _port_decode_full(blob)
    assert res.status is DecodeStatus.Finished and got == TEXT[:60000]
    n = len(launches)
    assert n
    monkeypatch.setattr(huff.HufTable, "decode_stream", host)
    res, got = _port_decode_full(blob, device_literals=False)
    assert res.status is DecodeStatus.Finished and got == TEXT[:60000]
    assert len(launches) == n


# ---------------------------------------------------------------------------
# The decode pieces of fse.py and huff.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fse_and_huffman_decode_pieces_equal_reference(jax_cpu, seed):
    """The decode tables, the table-description reader and the backward
    bit reader the decoder uses equal the reference's."""
    from compu_tpu.formats.zstd import fse as ref_fse
    from compu_tpu.formats.zstd import huff as ref_huff
    from compu_tpu_torch.formats.zstd import fse

    rng = np.random.default_rng(seed)
    for k in range(6):
        h = (rng.pareto(1.0 + k / 3, int(rng.integers(2, 60))) * 50).astype(np.int64) + 1
        norm, log = huff.normalize_counts(h, int(h.sum()), 9)
        blob = fse.write_norm_counts(norm, log) + bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        assert fse.read_norm_counts(blob, 0, 63, 9) == ref_fse.read_norm_counts(blob, 0, 63, 9)
        port, ref = fse.FseDecodeTable(norm, log), ref_fse.FseDecodeTable(norm, log)
        for name in ("symbol", "nbits", "baseline"):
            assert np.array_equal(getattr(port, name), getattr(ref, name))
        stream = bytes(rng.integers(0, 256, 40, dtype=np.uint8)) + b"\x05"
        pr, rr = fse.BackwardBitReader(stream), ref_fse.BackwardBitReader(stream)
        for n in rng.integers(0, 12, 40):
            assert pr.read(int(n)) == rr.read(int(n))
        freqs = np.bincount(rng.choice(40, 3000, p=np.arange(1, 41) / 820), minlength=256)
        enc = huff.HufEncoder(freqs)
        desc = enc.describe() + b"\x00"
        assert huff.decode_weights(desc) == ref_huff.decode_weights(desc)
        port, ref = huff.HufTable(enc.weights), ref_huff.HufTable(enc.weights)
        assert port.max_bits == ref.max_bits
        assert np.array_equal(port.symbol, ref.symbol) and np.array_equal(port.nbits, ref.nbits)


# ---------------------------------------------------------------------------
# Kernel P2's plain version against the reference's _decode_lanes
# ---------------------------------------------------------------------------

def _encoder_for(max_bits: int, seed: int):
    """A HufEncoder whose longest code is ``max_bits`` bits: geometric
    frequencies over max_bits + 1 symbols, scattered over the byte range."""
    rng = np.random.default_rng(seed)
    syms = rng.choice(256, max_bits + 1, replace=False)
    freqs = np.zeros(256, np.int64)
    freqs[syms] = [1 << max(max_bits - i, 0) for i in range(max_bits + 1)]
    enc = huff.HufEncoder(freqs)
    assert enc.max_bits == max_bits
    return enc, syms, freqs[syms] / freqs[syms].sum()


def _lane_case(max_bits: int, kind: str, seed: int = 0):
    """Bodies, counts and the table for one lane case. ``kind``: "one"
    (counts of 1), "unequal" (4 lanes of different lengths), "section" (a
    real section's 4 lanes: ceil(n/4) symbols thrice, then the rest),
    "over32" (each stream asked for more symbols than it holds, so its
    counter ends between -33 and -64 bits), "over64" (below -64). Every
    lane ends in the shortest code, so its last reads go past bit 0."""
    enc, syms, p = _encoder_for(max_bits, seed)
    rng = np.random.default_rng(seed + 100)
    if kind == "one":
        lens = [1, 1, 1, 1]
    elif kind == "unequal":
        lens = [700, 3, 1501, 64]
    else:
        n = 4001
        per = (n + 3) // 4
        lens = [per, per, per, n - 3 * per]
    chunks = [bytes(np.append(rng.choice(syms, n - 1, p=p), syms[0]).astype(np.uint8))
              for n in lens]
    bodies = [enc.encode_stream(c) for c in chunks]
    counts = list(lens)
    if kind.startswith("over"):
        # Past the stream's start every read is zero bits: the longest
        # code's cell, max_bits bits a symbol.
        extra = math.ceil((40 if kind == "over32" else 70) / max_bits)
        counts = [c + extra for c in counts]
    return bodies, counts, huff.HufTable(enc.weights), chunks


def _ref_lanes(bodies, counts, table):
    """The reference's ``_decode_lanes`` on these lanes, as its
    ``decode_4stream_device`` builds them (one table a lane)."""
    import jax.numpy as jnp

    from compu_tpu.kernels.zstd_lit_decode_jax import _decode_lanes

    (streams, bits0, cnt, _, _, _), _, steps = p2.lane_inputs(
        bodies, counts, table.symbol, table.nbits, table.max_bits, "cpu")
    L = len(bodies)
    sym_t = np.zeros((L, 2048), np.int32)
    nb_t = np.zeros((L, 2048), np.int32)
    sym_t[:, :len(table.symbol)] = table.symbol
    nb_t[:, :len(table.nbits)] = table.nbits
    out, ok = _decode_lanes(jnp.asarray(streams.numpy()), jnp.asarray(bits0.numpy()),
                            jnp.asarray(cnt.numpy()), jnp.asarray(sym_t), jnp.asarray(nb_t),
                            jnp.full(L, table.max_bits, jnp.int32), max_steps=steps,
                            out_cap=steps)
    return np.asarray(out), np.asarray(ok)


def _host_ok(bodies, counts, table):
    """Whether HufTable.decode_stream accepts each lane."""
    res = []
    for b, c in zip(bodies, counts):
        try:
            table.decode_stream(b, c)
            res.append(True)
        except CodecFailure:
            res.append(False)
    return res


def _twin(bodies, counts, table):
    args, sentinel, steps = p2.lane_inputs(bodies, counts, table.symbol, table.nbits,
                                           table.max_bits, "cpu")
    assert all(sentinel)
    return [t.numpy() for t in p2.huf_decode_lanes(*args, steps)]


@pytest.mark.parametrize("max_bits", range(1, 12))
def test_twin_equals_reference_lanes_every_max_bits(jax_cpu, max_bits):
    bodies, counts, table, chunks = _lane_case(max_bits, "unequal", seed=max_bits)
    out, ok, host_ok = _twin(bodies, counts, table)
    ref_out, ref_ok = _ref_lanes(bodies, counts, table)
    assert np.array_equal(out, ref_out) and np.array_equal(ok, ref_ok)
    assert host_ok.tolist() == _host_ok(bodies, counts, table) == [True] * 4
    assert [out[i, :c].tobytes() for i, c in enumerate(counts)] == chunks


@pytest.mark.parametrize("kind", ["one", "section", "over32", "over64"])
@pytest.mark.parametrize("max_bits", [1, 6, 11])
def test_twin_equals_reference_lanes_edges(jax_cpu, kind, max_bits):
    bodies, counts, table, chunks = _lane_case(max_bits, kind, seed=7)
    out, ok, host_ok = _twin(bodies, counts, table)
    ref_out, ref_ok = _ref_lanes(bodies, counts, table)
    assert np.array_equal(out, ref_out) and np.array_equal(ok, ref_ok)
    assert host_ok.tolist() == _host_ok(bodies, counts, table)
    want_ok, want_host = {"over32": (True, False), "over64": (False, False)}.get(
        kind, (True, True))
    assert ok.tolist() == [want_ok] * 4 and host_ok.tolist() == [want_host] * 4
    assert [out[i, :len(c)].tobytes() for i, c in enumerate(chunks)] == chunks


def test_twin_sections_share_nothing():
    """Two sections in one call, each with its own table, give each
    section's own decode."""
    a = _lane_case(5, "unequal", seed=1)
    b = _lane_case(9, "section", seed=2)
    la, sa, ma = p2.lane_inputs(a[0], a[1], a[2].symbol, a[2].nbits, a[2].max_bits, "cpu")
    lb, sb, mb = p2.lane_inputs(b[0], b[1], b[2].symbol, b[2].nbits, b[2].max_bits, "cpu")
    scap = max(la[0].shape[1], lb[0].shape[1])
    streams = torch.zeros(8, scap, dtype=torch.uint8)
    streams[:4, :la[0].shape[1]] = la[0]
    streams[4:, :lb[0].shape[1]] = lb[0]
    steps = max(ma, mb)
    out, ok, host_ok = p2.huf_decode_lanes_torch(
        streams, torch.cat([la[1], lb[1]]), torch.cat([la[2], lb[2]]),
        torch.cat([la[3], lb[3]]), torch.cat([la[4], lb[4]]), torch.cat([la[5], lb[5]]), steps)
    assert bool(ok.all()) and bool(host_ok.all())
    for lane, chunk in enumerate(a[3] + b[3]):
        assert out[lane, :len(chunk)].numpy().tobytes() == chunk


def test_lane_shapes_are_checked():
    args, _, steps = p2.lane_inputs([b"\x01\x02"], [3], np.zeros(4, np.int32),
                                    np.ones(4, np.int32), 2, "cpu")
    with pytest.raises(ValueError, match="max_steps"):
        p2.huf_decode_lanes(*args, 0)
    with pytest.raises(ValueError, match="bits0"):
        p2.huf_decode_lanes(args[0], args[1][:0], *args[2:], steps)
    with pytest.raises(ValueError, match="no huf_decode_lanes"):
        p2.huf_decode_lanes(args[0].to("meta"), *args[1:], steps)


# ---------------------------------------------------------------------------
# Corrupt 4-stream literal sections, on both routes
# ---------------------------------------------------------------------------

def _section(streams: list[bytes], regen: int, enc) -> bytes:
    """A compressed 4-stream literals section (size format 3: 18-bit
    sizes), followed by an empty sequences section."""
    payload = (enc.describe() + struct.pack("<HHH", *(len(s) for s in streams[:3]))
               + b"".join(streams))
    comp = len(payload)
    hdr = bytes([2 | (3 << 2) | ((regen & 0xF) << 4), (regen >> 4) & 0xFF,
                 ((regen >> 12) & 0x3F) | ((comp & 3) << 6), (comp >> 2) & 0xFF,
                 (comp >> 10) & 0xFF])
    return hdr + payload + b"\x00"


def _corruptions():
    """(name, section) pairs: a good section of 8,000 literals (all four
    lanes 2,000 symbols, so the reference compiles its loop once) and its
    corrupt forms."""
    lits = np.random.default_rng(3).choice(
        np.frombuffer(b"etaoinshrdlu ,.", np.uint8), 8000,
        p=np.linspace(2, 1, 15) / np.linspace(2, 1, 15).sum()).astype(np.uint8).tobytes()
    enc = huff.HufEncoder(np.bincount(np.frombuffer(lits, np.uint8), minlength=256))
    streams = [enc.encode_stream(lits[i * 2000:(i + 1) * 2000]) for i in range(4)]
    out = [("good", _section(streams, 8000, enc))]

    def variant(name, i, fn):
        s = list(streams)
        s[i] = fn(s[i])
        out.append((name, _section(s, 8000, enc)))

    variant("zero-last-byte-0", 0, lambda b: b[:-1] + b"\x00")
    variant("zero-last-byte-2", 2, lambda b: b[:-1] + b"\x00")
    variant("empty-1", 1, lambda b: b"")
    variant("empty-3", 3, lambda b: b"")
    variant("flip-middle-0", 0, lambda b: b[:len(b) // 2] + bytes([b[len(b) // 2] ^ 0x5A])
            + b[len(b) // 2 + 1:])
    variant("flip-middle-3", 3, lambda b: b[:100] + bytes(x ^ 0xFF for x in b[100:110])
            + b[110:])
    # The stream's first bytes (read last) cut: the counter runs 40 bits
    # past its start, which the device rule takes and the host rule not.
    variant("short-by-5-bytes-1", 1, lambda b: b[5:])
    variant("short-by-9-bytes-2", 2, lambda b: b[9:])
    # A stream that fails after one that has no sentinel, and the reverse.
    s = list(streams)
    s[0], s[2] = s[0][9:], s[2][:-1] + b"\x00"
    out.append(("short-0-then-zero-2", _section(s, 8000, enc)))
    s = list(streams)
    s[0], s[2] = s[0][:-1] + b"\x00", s[2][9:]
    out.append(("zero-0-then-short-2", _section(s, 8000, enc)))
    return out


_CORRUPT = [name for name, _ in _corruptions()]


def _literals(mod, section: bytes, device_literals: bool, **kw):
    """A frame decoder's ``_decode_literals`` of ``section``: the literals,
    or the error code."""
    frame = mod.ZstdFrameDecoder(device_literals=device_literals, **kw)
    try:
        return frame._decode_literals(section)[0]
    except mod.CodecFailure as failure:
        return failure.code


@pytest.mark.parametrize("device_literals", [False, True])
@pytest.mark.parametrize("name", _CORRUPT)
def test_corrupt_sections_give_reference_codes(jax_cpu, monkeypatch, name, device_literals):
    from compu_tpu.formats.zstd import decode as ref_dec

    section = dict(_corruptions())[name]
    ref = _literals(ref_dec, section, device_literals)
    if device_literals:
        def refuse(*args):
            raise AssertionError("the device route decoded on the host")

        monkeypatch.setattr(huff.HufTable, "decode_stream", refuse)
    port = _literals(port_dec, section, device_literals, device="cpu")
    assert port == ref
    want = {"good": bytes, "short-by-5-bytes-1": bytes if device_literals else 302,
            "short-by-9-bytes-2": 302, "short-0-then-zero-2": 302,
            "zero-0-then-short-2": 301}.get(name, 301 if name.startswith(("zero", "empty"))
                                              else None)
    if want is bytes:
        assert isinstance(port, bytes) and len(port) == 8000
    elif want is not None:
        assert port == want


# ---------------------------------------------------------------------------
# Fault C1: frame blocks cut at Block_Maximum_Size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_log", [10, 12, 14, 16])
def test_frames_below_window_log_17_decode_in_zstandard(window_log):
    zstandard = pytest.importorskip("zstandard")
    data = (TEXT * 2)[:3 * (1 << window_log) + 777]
    frame = _port_frame(data, window_log=window_log)
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data)) == data
    res, got = _port_decode_full(frame, device_literals=False)
    assert res.status is DecodeStatus.Finished and got == data
    res, got = _port_decode_full(frame)
    assert res.status is DecodeStatus.Finished and got == data


def test_frames_at_window_log_17_and_above_equal_reference(jax_cpu):
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import EncodeOp as RefOp
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

    data = (TEXT * 2)[:200_000]
    for window_log in (17, 20):
        vec = RefVec()
        ref_encoder.Interface.zstd(RefOptions(level=6, device_lz=True, window_log=window_log,
                                              **DEVICE_ALL)).encode_vec_full(data, vec, RefOp.Finish)
        assert _port_frame(data, window_log=window_log, **DEVICE_ALL) == vec.data()


def test_decoder_rejects_blocks_past_the_window(jax_cpu):
    """The reference's frame of 1,100 bytes at window_log 10 holds one
    block of 1,100 bytes: the reference decodes it, the port (and stock
    zstd) refuse it."""
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import EncodeOp as RefOp
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

    vec = RefVec()
    ref_encoder.Interface.zstd(RefOptions(window_log=10)).encode_vec_full(
        TEXT[:1100], vec, RefOp.Finish)
    frame = vec.data()
    ref, ref_bytes = _ref_decode_full(frame)
    assert ref.status.name == "Finished" and ref_bytes == TEXT[:1100]
    res, _ = _port_decode_full(frame)
    assert res.status == DecodeError(port_dec.ERR_BLOCK)
    zstandard = pytest.importorskip("zstandard")
    with pytest.raises(zstandard.ZstdError):
        zstandard.ZstdDecompressor().decompress(frame, max_output_size=1100)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _gpu_lanes(lanes: int, max_bits: int, kind: str, sections: int = 1):
    """``sections`` sections of ``lanes`` lanes each (cases of
    :func:`_lane_case`, repeated), as CPU tensors."""
    parts = []
    for s in range(sections):
        bodies, counts, table, _ = _lane_case(max_bits, kind, seed=s)
        reps = -(-lanes // 4)
        bodies, counts = (bodies * reps)[:lanes], (counts * reps)[:lanes]
        parts.append(p2.lane_inputs(bodies, counts, table.symbol, table.nbits,
                                    table.max_bits, "cpu"))
    scap = max(a[0].shape[1] for a, _, _ in parts)
    streams = torch.zeros(lanes * sections, scap, dtype=torch.uint8)
    for s, (a, _, _) in enumerate(parts):
        streams[s * lanes:(s + 1) * lanes, :a[0].shape[1]] = a[0]
    cat = [torch.cat([a[k] for a, _, _ in parts]) for k in range(1, 6)]
    return (streams, *cat), max(m for _, _, m in parts)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 4, 512])
@pytest.mark.parametrize("max_bits", range(1, 12))
@pytest.mark.parametrize("kind", ["unequal", "over32", "over64", "one"])
def test_p2_kernel_equals_plain_gpu(cuda, lanes, max_bits, kind):
    args, steps = _gpu_lanes(lanes, max_bits, kind)
    want = p2.huf_decode_lanes_torch(*args, steps)
    got = p2.huf_decode_lanes_cuda(*(a.to(cuda) for a in args), steps)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_p2_kernel_many_sections_gpu(cuda):
    """128 sections of 4 lanes, each with its own table, and one section
    whose lanes outnumber a block's threads."""
    for lanes, sections in ((4, 128), (600, 1)):
        args, steps = _gpu_lanes(lanes, 11 if sections == 1 else 7, "section", sections)
        want = p2.huf_decode_lanes_torch(*args, steps)
        got = p2.huf_decode_lanes_cuda(*(a.to(cuda) for a in args), steps)
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1, 2, 3])
def test_p2_kernel_odd_max_steps_gpu(cuda, extra):
    """``max_steps`` not a multiple of 4 (1,501 and more): output rows
    that do not start on a 4-byte boundary."""
    args, steps = _gpu_lanes(4, 9, "unequal")
    assert steps == 1501
    want = p2.huf_decode_lanes_torch(*args, steps + extra)
    got = p2.huf_decode_lanes_cuda(*(a.to(cuda) for a in args), steps + extra)
    torch.cuda.synchronize()
    assert got[0].shape == (4, steps + extra)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_p2_kernel_one_symbol_lane_gpu(cuda):
    """A lane of one symbol (a one-byte stream), beside longer lanes."""
    bodies, counts, table, _ = _lane_case(11, "unequal", seed=3)
    enc, syms, _ = _encoder_for(11, 3)
    bodies[1], counts[1] = enc.encode_stream(bytes([int(syms[0])])), 1
    args, sentinel, steps = p2.lane_inputs(bodies, counts, table.symbol, table.nbits,
                                           table.max_bits, "cpu")
    assert all(sentinel) and len(bodies[1]) == 1
    want = p2.huf_decode_lanes_torch(*args, steps)
    got = p2.huf_decode_lanes_cuda(*(a.to(cuda) for a in args), steps)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert want[0][1, 0].item() == int(syms[0]) and bool(want[1].all())


@pytest.mark.gpu
def test_p2_kernel_largest_section_gpu(cuda):
    """The largest legal section: four streams of about 32 KiB each, 128
    KiB together (a compressed block's largest content), at max_bits 11."""
    rng = np.random.default_rng(3)
    freqs = (rng.pareto(0.9, 256) * 10).astype(np.int64) + 1
    enc = huff.HufEncoder(freqs)
    assert enc.max_bits == 11
    lits = rng.choice(256, 180_000, p=freqs / freqs.sum()).astype(np.uint8).tobytes()
    per = 45_000
    chunks = [lits[i * per:(i + 1) * per] for i in range(4)]
    bodies = [enc.encode_stream(c) for c in chunks]
    while sum(map(len, bodies)) > 128 << 10:
        chunks = [c[:-500] for c in chunks]
        bodies = [enc.encode_stream(c) for c in chunks]
    assert sum(map(len, bodies)) > 127 << 10
    table = huff.HufTable(enc.weights)
    args, sentinel, steps = p2.lane_inputs(bodies, [len(c) for c in chunks], table.symbol,
                                           table.nbits, table.max_bits, "cpu")
    want = p2.huf_decode_lanes_torch(*args, steps)
    got = p2.huf_decode_lanes_cuda(*(a.to(cuda) for a in args), steps)
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert [want[0][i, :len(c)].numpy().tobytes() for i, c in enumerate(chunks)] == chunks


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(6))
def test_p2_kernel_any_input_gpu(cuda, seed):
    """Inputs no Huffman section gives: random stream bytes, counters and
    tables, codes longer than max_bits in odd seeds (the kernel's path for
    such tables), rows whose length is not a multiple of 4, and the same
    rows in a misaligned tensor (both copied into padded rows)."""
    rng = np.random.default_rng(seed)
    L, S, scap = 6, 2, int(rng.integers(4, 30)) * 2 + 1
    m = rng.integers(0, 12, S).astype(np.int32)
    longest = [30 if seed % 2 else int(x) + 1 for x in m]
    args = (torch.from_numpy(rng.integers(0, 256, (L, scap)).astype(np.uint8)),
            torch.from_numpy(rng.integers(-80, 8 * scap + 40, L).astype(np.int32)),
            torch.from_numpy(rng.integers(-2, 60, L).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 256, (S, 2048)).astype(np.uint8)),
            torch.from_numpy(np.stack([rng.integers(0, h, 2048) for h in longest])
                             .astype(np.uint8)),
            torch.from_numpy(m))
    want = p2.huf_decode_lanes_torch(*args, 50)
    dev = [a.to(cuda) for a in args]
    buf = torch.zeros(L * scap + 1, dtype=torch.uint8, device=cuda)
    shifted = buf[1:].view(L, scap)
    shifted.copy_(dev[0])
    assert shifted.data_ptr() % 4 and shifted.is_contiguous()
    for streams in (dev[0], shifted):
        got = p2.huf_decode_lanes_cuda(streams, *dev[1:], 50)
        torch.cuda.synchronize()
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_corpus_frame_card_decode_equals_cpu_gpu(cuda):
    from compu_tpu_torch import _build
    from compu_tpu_torch.utils.corpus import build_corpus

    data = build_corpus()[:2 << 20]
    frame = _port_frame(data, **DEVICE_ALL)
    _build.reset_launch_counts()
    res, card = _port_decode_full(frame, device=cuda, device_literals=True)
    assert _build.LAUNCHES["huf_decode_lanes"] > 0
    assert res.status is DecodeStatus.Finished and card == data
    res, cpu = _port_decode_full(frame, device_literals=True)
    assert res.status is DecodeStatus.Finished and cpu == card
