"""The host runtime's zstd and brotli pairs, and its helpers on the device
routes, against the JAX package's (``compu_tpu``) on the CPU.

* ``encoder.Interface.zstd_native()`` / ``brotli_native()``: the
  reference's bytes at several levels, qualities, windows and checksum
  settings, decoded by the port's native and Python decoders (and by
  ``zstandard`` and the system's libbrotli); chunked encodes equal one-shot.
* ``decoder.Interface.zstd_native()`` / ``brotli_native()``: the
  reference's bytes, statuses, error codes and remaining counts on the
  golden fixtures, foreign streams, and truncated, corrupted and
  trailing-garbage streams, one-shot and fed in chunks.
* The zstd and brotli device routes on ``device="cpu"``: each helper call
  the encode makes equals its Python twin on the same arguments, and the
  streams equal the reference's with its native helpers on and off.

Inputs are made from a numpy seed; every comparison is exact.
"""

import functools
import pathlib
import sys
import types

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from compu_tpu_torch import decoder  # noqa: E402
from compu_tpu_torch.buffer import Buffer  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, EncodeStatus, Interface  # noqa: E402
from compu_tpu_torch.formats.brotli import encode as benc  # noqa: E402
from compu_tpu_torch.formats.brotli import native_enc as bnative  # noqa: E402
from compu_tpu_torch.formats.brotli.options import BrotliOptions  # noqa: E402
from compu_tpu_torch.formats.zstd import encode as zenc  # noqa: E402
from compu_tpu_torch.formats.zstd import huff as zhuff  # noqa: E402
from compu_tpu_torch.formats.zstd import native_enc as znative  # noqa: E402
from compu_tpu_torch.formats.zstd import tables as T  # noqa: E402
from compu_tpu_torch.formats.zstd.options import ZstdDecodeOptions, ZstdOptions  # noqa: E402
from compu_tpu_torch.status import DecodeStatus  # noqa: E402

DATA = ROOT / "tests" / "data"
ALICE = (DATA / "alice29.txt").read_bytes()


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
            d = int(rng.integers(1, min(len(out), 100_000) + 1))
            for _ in range(k):
                out.append(out[-d])
        else:
            out += rng.integers(0, 256, k // 4, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def _status(res):
    return ("error", res.status.code) if res.is_error else res.status.name


def port_encode(enc, data: bytes) -> bytes:
    vec = ByteVec()
    assert enc.encode_vec_full(data, vec, EncodeOp.Finish).status is EncodeStatus.Finished
    return vec.data()


def ref_encode(enc, data: bytes) -> bytes:
    import compu_tpu

    vec = compu_tpu.ByteVec()
    enc.encode_vec_full(data, vec, compu_tpu.EncodeOp.Finish)
    return vec.data()


def decode_full(dec, blob: bytes, vec):
    res = dec.decode_vec_full(blob, vec)
    return _status(res), res.input_remain, vec.data()


def port_decode(dec, blob: bytes):
    return decode_full(dec, blob, ByteVec())


def ref_decode(dec, blob: bytes):
    import compu_tpu

    return decode_full(dec, blob, compu_tpu.ByteVec())


def fed(dec, blob: bytes, chunk: int, out_size: int):
    """``blob`` fed ``chunk`` bytes a call into ``out_size``-byte outputs:
    every call's (status, input_remain, output_remain) and the bytes."""
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
        if calls[-1][0] == "Finished" or res.is_error:
            break
    return calls, bytes(out)


def damaged(blob: bytes, seed: int, trials: int = 8):
    """Truncations, byte flips and spliced garbage of ``blob``, and the
    stream with trailing garbage, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        bad = bytearray(blob)
        kind = trial % 4
        if kind == 0:
            del bad[int(rng.integers(1, len(bad))):]
        elif kind == 1:
            bad[int(rng.integers(0, len(bad)))] ^= int(rng.integers(1, 256))
        elif kind == 2:
            at = int(rng.integers(0, len(bad)))
            bad[at: at + 8] = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        else:
            bad += rng.integers(0, 256, int(rng.integers(1, 30)), dtype=np.uint8).tobytes()
        yield bytes(bad)


# -- zstd_native ----------------------------------------------------------------------
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
@pytest.mark.parametrize("checksum", [False, True])
def test_zstd_native_encode_equals_reference(level, checksum):
    import zstandard

    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

    data = corpus(150_000, level + 30)
    window_log = 17 if checksum else 20
    got = port_encode(Interface.zstd_native(ZstdOptions(level=level, checksum=checksum,
                                                        window_log=window_log)), data)
    ref = ref_encode(ref_encoder.Interface.zstd_native(
        RefOptions(level=level, checksum=checksum, window_log=window_log)), data)
    assert got == ref
    assert zstandard.ZstdDecompressor().decompress(got, max_output_size=len(data)) == data
    assert port_decode(decoder.Interface.zstd_native(), got) == ("Finished", 0, data)
    host = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=False), device="cpu")
    assert port_decode(host, got) == ("Finished", 0, data)


def test_zstd_native_chunks_and_window_carry():
    """Buffer-chunked encode equals one-shot; input past one 1 MiB chunk
    matches across chunks (window 21) and equals the reference's."""
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

    data = ALICE * 8
    opts = ZstdOptions(level=3, window_log=21)
    one = port_encode(Interface.zstd_native(opts), data)
    assert one == ref_encode(ref_encoder.Interface.zstd_native(RefOptions(level=3, window_log=21)),
                             data)
    assert len(one) < len(ALICE)
    enc, buf, chunked, rest = Interface.zstd_native(opts), Buffer(4096), bytearray(), memoryview(data)
    while True:
        consumed, st = buf.encode(enc, rest, EncodeOp.Finish)
        rest = rest[consumed:]
        chunked.extend(buf.data())
        buf.consume()
        if st.status is EncodeStatus.Finished and not buf.data():
            break
    assert bytes(chunked) == one
    assert enc.reset() and port_encode(enc, data) == one


@pytest.fixture(scope="module")
def zstd_streams():
    import zstandard

    data = corpus(120_000, 3)
    return data, {
        "alice29.txt.zst": (DATA / "alice29.txt.zst").read_bytes(),
        "10x10y.zst": (DATA / "10x10y.zst").read_bytes(),
        "foreign-19-checksum": zstandard.ZstdCompressor(level=19, write_checksum=True).compress(data),
        "foreign-3": zstandard.ZstdCompressor(level=3).compress(data),
        "skippable+foreign": b"\x50\x2a\x4d\x18\x05\x00\x00\x00hello"
                             + zstandard.ZstdCompressor(level=1).compress(data),
    }


@pytest.mark.parametrize("name", ["alice29.txt.zst", "10x10y.zst", "foreign-19-checksum",
                                  "foreign-3", "skippable+foreign"])
def test_zstd_native_decode_equals_reference(zstd_streams, name):
    """One-shot, damaged and chunk-fed decodes equal the reference's
    native decoder's; the window cap refuses as the reference's."""
    from compu_tpu import decoder as ref_decoder
    from compu_tpu.formats.zstd.options import ZstdDecodeOptions as RefDecodeOptions

    blob = zstd_streams[1][name]
    got = port_decode(decoder.Interface.zstd_native(), blob)
    assert got[0] == "Finished" and got == ref_decode(ref_decoder.Interface.zstd_native(), blob)
    for bad in damaged(blob, len(name)):
        assert port_decode(decoder.Interface.zstd_native(), bad) == ref_decode(
            ref_decoder.Interface.zstd_native(), bad)
    for chunk, out_size in ((1, 1 << 16), (7, 61), (4096, 61), (65_536, 4096)):
        if chunk < 64 and len(blob) > 8_000:
            continue  # each call copies the staged input: quadratic in small feeds
        assert fed(decoder.Interface.zstd_native(), blob, chunk, out_size) == fed(
            ref_decoder.Interface.zstd_native(), blob, chunk, out_size)
    capped = decoder.Interface.zstd_native(ZstdDecodeOptions(window_log_max=10))
    ref_capped = ref_decoder.Interface.zstd_native(RefDecodeOptions(window_log_max=10))
    assert port_decode(capped, blob) == ref_decode(ref_capped, blob)
    dec = decoder.Interface.zstd_native()
    res = dec.decode(b"\x00\x01\x02\x03\x04\x05\x06\x07", bytearray(64))
    assert res.is_error and dec.describe_error(res.status) == "invalid zstd magic"
    assert dec.describe_error(res.status) == ref_decoder.Interface.zstd_native().describe_error(
        res.status.code)


# -- brotli_native ----------------------------------------------------------------------
@pytest.mark.parametrize("quality", [1, 5, 9, 11])
@pytest.mark.parametrize("window_bits", [16, 22])
def test_brotli_native_encode_equals_reference(quality, window_bits):
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.brotli.options import BrotliOptions as RefOptions

    data = corpus(120_000 if quality < 11 else 40_000, quality)
    got = port_encode(Interface.brotli_native(BrotliOptions(quality=quality,
                                                            window_bits=window_bits)), data)
    ref = ref_encode(ref_encoder.Interface.brotli_native(
        RefOptions(quality=quality, window_bits=window_bits)), data)
    assert got == ref
    assert port_decode(decoder.Interface.brotli_native(), got) == ("Finished", 0, data)
    assert port_decode(decoder.Interface.brotli(), got) == ("Finished", 0, data)
    try:
        import brotli_oracle
    except OSError:  # no system libbrotli: the port's two decoders stand
        return
    assert brotli_oracle.decompress(got, len(data) + 64) == data


def test_brotli_native_chunks_equal_one_shot():
    data = corpus(300_000, 77)
    one = port_encode(Interface.brotli_native(BrotliOptions(quality=9)), data)
    enc, buf, chunked, rest = (Interface.brotli_native(BrotliOptions(quality=9)), Buffer(4096),
                               bytearray(), memoryview(data))
    while True:
        consumed, st = buf.encode(enc, rest, EncodeOp.Finish)
        rest = rest[consumed:]
        chunked.extend(buf.data())
        buf.consume()
        if st.status is EncodeStatus.Finished and not buf.data():
            break
    assert bytes(chunked) == one
    assert enc.reset() and port_encode(enc, data) == one


@pytest.mark.parametrize("name", ["alice29.txt.br", "10x10y.br", "own-q9", "own-q5-w16"])
def test_brotli_native_decode_equals_reference(name):
    from compu_tpu import decoder as ref_decoder

    data = corpus(80_000 if name == "own-q9" else 12_000, 9)
    if name.startswith("own"):
        q, w = (9, 22) if name == "own-q9" else (5, 16)
        blob = port_encode(Interface.brotli_native(BrotliOptions(quality=q, window_bits=w)), data)
    else:
        blob = (DATA / name).read_bytes()
    got = port_decode(decoder.Interface.brotli_native(), blob)
    assert got[0] == "Finished" and got == ref_decode(ref_decoder.Interface.brotli_native(), blob)
    assert got == port_decode(decoder.Interface.brotli(), blob)
    for bad in damaged(blob, len(name)):
        assert port_decode(decoder.Interface.brotli_native(), bad) == ref_decode(
            ref_decoder.Interface.brotli_native(), bad)
    for chunk, out_size in ((1, 1 << 16), (7, 61), (4096, 61), (65_536, 4096)):
        if chunk < 64 and len(blob) > 8_000:
            continue  # each call copies the staged input: quadratic in small feeds
        assert fed(decoder.Interface.brotli_native(), blob, chunk, out_size) == fed(
            ref_decoder.Interface.brotli_native(), blob, chunk, out_size)


# -- the device routes' helpers ------------------------------------------------------------
def _spy(monkeypatch, module, names):
    """Record every call of ``module``'s ``names``: (name, args, result)."""
    calls = []
    for name in names:
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name):
            out = _real(*args)
            calls.append((_name, args, out))
            return out

        monkeypatch.setattr(module, name, spy)
    return calls


@functools.lru_cache(maxsize=None)
def _ref_stream(fmt: str, data: bytes, native_on: bool) -> bytes:
    """The reference's device-LZ stream of ``data`` (JAX on the CPU), with
    its native helpers on or off."""
    pytest.importorskip("jax")
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.runtime import native as ref_native

    saved = ref_native._load
    if not native_on:
        ref_native._load = lambda: None
    try:
        if fmt == "zstd":
            from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

            enc = ref_encoder.Interface.zstd(RefOptions(level=6, device_lz=True))
        else:
            from compu_tpu.formats.brotli.options import BrotliOptions as RefOptions

            enc = ref_encoder.Interface.brotli(RefOptions(device_lz=True))
        return ref_encode(enc, data)
    finally:
        ref_native._load = saved


def test_zstd_device_route_helpers_equal_twins(monkeypatch):
    """The zstd device route on the CPU with the host writers: every call
    of a helper equals its twin on the same arguments; the frame equals
    the route's frame with every device stage, and the reference's with
    its native helpers on and off; zstandard decodes it."""
    import zstandard

    data = corpus(300_000, 5)
    calls = _spy(monkeypatch, znative, ["seq_from_tokens", "resolve_offsets", "seq_bitstream",
                                        "huf_stream", "fse_pair_stream"])
    frame = port_encode(Interface.zstd(ZstdOptions(), device="cpu"), data)
    assert {c[0] for c in calls} == {"seq_from_tokens", "resolve_offsets", "seq_bitstream",
                                     "huf_stream", "fse_pair_stream"}
    for name, args, out in calls:
        if name == "seq_from_tokens":
            lits, seqs = zenc._sequences_from_tokens_py(np.frombuffer(args[0], np.uint8), *args[1:])
            assert out[0] == lits and np.array_equal(np.stack(out[1], axis=1), seqs)
        elif name == "resolve_offsets":
            ll, off, rep = args
            twin = zenc._resolve_offset_values(list(zip(ll, off, np.zeros_like(ll))), rep)
            assert out[0].tolist() == list(twin[0]) and out[1] == list(twin[1])
        elif name == "seq_bitstream":
            llc, mlc, ofc, llx, _, mlx, _, ofx, _, lle, mle, ofe = args
            seqs = np.stack([llx + T.LL_BASE[llc], np.zeros_like(llc), mlx + T.ML_BASE[mlc]], 1)
            of_values = ofx + (np.int64(1) << ofc)
            tabs = [types.SimpleNamespace(enc=e) for e in (lle, mle, ofe)]
            assert out == zenc._sequences_bitstream_py(seqs, llc, mlc, ofc, of_values, *tabs)
        elif name == "huf_stream":
            coder = types.SimpleNamespace(code=args[1], nbits=args[2])
            assert out == zhuff.HufEncoder.encode_stream_py(coder, args[0])
        else:
            assert out == zhuff.fse_pair_stream_py(*args)
    monkeypatch.undo()
    assert port_encode(Interface.zstd(ZstdOptions(device_literals=True, device_sequences=True),
                                      device="cpu"), data) == frame
    assert zstandard.ZstdDecompressor().decompress(frame, max_output_size=len(data)) == data
    assert frame == _ref_stream("zstd", data, True) == _ref_stream("zstd", data, False)


def test_brotli_device_route_helpers_equal_twins(monkeypatch):
    """The brotli device route on the CPU: every meta-block's commands and
    distance plan from the host runtime equal the twins'; the stream equals
    the reference's with its native helpers on and off, and the port's
    native and Python decoders give the input back."""
    data = corpus(300_000, 6)
    calls = _spy(monkeypatch, bnative, ["commands_from_tokens", "plan_distances",
                                        "emit_commands"])
    stream = port_encode(Interface.brotli(device="cpu"), data)
    assert [c[0] for c in calls] == ["commands_from_tokens", "plan_distances",
                                     "emit_commands"]
    for name, args, out in calls:
        if name == "commands_from_tokens":
            twin = benc._commands_from_tokens_py(*args[:3])
            assert all(np.array_equal(a, b) for a, b in zip(out, twin))
        elif name == "plan_distances":
            ic, cc, dist, ring = args
            zero = np.zeros_like(dist)
            twin = benc._distance_plan_py(zero, zero, zero, dist, ic, cc, ring)
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(out, twin))
    monkeypatch.undo()
    assert port_decode(decoder.Interface.brotli_native(), stream) == ("Finished", 0, data)
    assert port_decode(decoder.Interface.brotli(), stream) == ("Finished", 0, data)
    assert stream == _ref_stream("brotli", data, True) == _ref_stream("brotli", data, False)
