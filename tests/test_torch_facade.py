"""The port's façade pieces against the JAX reference's, on the CPU:
``Encoder.encode_buf`` and ``Decoder.decode_buf`` into a ``ChunkedSink``
and into a ``bytearray`` (port of tests/test_state_machine.py:271-310),
the encoder's ``Interface.register``/``new``, and ``ByteVec``'s capacity
methods. Streams are compared byte for byte (tolerance 0).
"""

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch import ByteVec, ChunkedSink, decoder, encoder  # noqa: E402
from compu_tpu_torch.formats.brotli.options import BrotliOptions  # noqa: E402
from compu_tpu_torch.formats.deflate.options import ZlibOptions  # noqa: E402
from compu_tpu_torch.status import DecodeStatus, EncodeOp, EncodeStatus  # noqa: E402

DATA = (ROOT / "tests" / "data" / "alice29.txt").read_bytes()[:30_000]
BLOCK = 1 << 15  # the zlib_device pipeline block of both packages here


def _port(name):
    """(encoder, decoder) of the port for a backend, on the CPU."""
    return {
        "stored": lambda: (encoder.Interface.stored(), decoder.Interface.stored()),
        "zlib_device": lambda: (encoder.Interface.zlib_device(ZlibOptions(level=6),
                                                              block_size=BLOCK, device="cpu"),
                                decoder.Interface.zlib_device(device="cpu")),
        "zstd": lambda: (encoder.Interface.zstd(device="cpu"),
                         decoder.Interface.zstd(device="cpu")),
        "brotli": lambda: (encoder.Interface.brotli(BrotliOptions(quality=9), device="cpu"),
                           decoder.Interface.brotli()),
    }[name]()


def _ref_encoder(name):
    """The reference's encoder of the same stream: its device routes, its
    native host helpers off."""
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.brotli.options import BrotliOptions as RefBrotli
    from compu_tpu.formats.deflate.options import ZlibOptions as RefZlib
    from compu_tpu.formats.zstd.options import ZstdOptions as RefZstd

    return {
        "stored": lambda: ref_encoder.Interface.stored(),
        "zlib_device": lambda: ref_encoder.Interface.zlib_device(RefZlib(level=6),
                                                                 block_size=BLOCK),
        "zstd": lambda: ref_encoder.Interface.zstd(RefZstd(
            level=6, device_lz=True, device_literals=True, device_sequences=True)),
        "brotli": lambda: ref_encoder.Interface.brotli(RefBrotli(quality=9, device_lz=True)),
    }[name]()


@pytest.fixture
def jax_cpu(monkeypatch):
    """The JAX reference on the CPU, with its native host helpers off."""
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


@pytest.mark.parametrize("name", ["stored", "zlib_device", "zstd", "brotli"])
def test_chunked_sink_bufmut_parity(jax_cpu, name):
    """encode_buf into a ChunkedSink(4096) writes in place, chunk by chunk,
    the bytes encode_buf gives into a bytearray and the reference's
    encode_buf gives into its own ChunkedSink; decode_buf gives the data
    back into either sink."""
    from compu_tpu import ChunkedSink as RefSink
    from compu_tpu import EncodeOp as RefOp

    enc, dec = _port(name)
    sink = ChunkedSink(4096)
    res = enc.encode_buf(DATA, sink, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished and res.input_remain == 0
    assert len(sink.chunks()) > 1 and len(sink) == len(sink.data())
    assert enc.reset()
    flat = bytearray()
    enc.encode_buf(DATA, flat, EncodeOp.Finish)
    assert sink.data() == bytes(flat)
    ref_sink = RefSink(4096)
    _ref_encoder(name).encode_buf(DATA, ref_sink, RefOp.Finish)
    assert sink.data() == ref_sink.data()

    out = ChunkedSink(4096)
    res = dec.decode_buf(sink.data(), out)
    assert res.status is DecodeStatus.Finished and out.data() == DATA
    assert dec.reset()
    back = bytearray()
    res = dec.decode_buf(sink.data(), back)
    assert res.status is DecodeStatus.Finished and bytes(back) == DATA


def test_chunked_sink_rules():
    with pytest.raises(ValueError, match="128"):
        ChunkedSink(64)
    sink = ChunkedSink(128)
    sink.advance_mut(0)
    with pytest.raises(ValueError, match="before chunk_mut"):
        sink.advance_mut(1)
    view = sink.chunk_mut()
    view[:3] = b"abc"
    sink.advance_mut(3)
    with pytest.raises(ValueError, match="beyond"):
        sink.advance_mut(200)
    assert sink.data() == b"abc" and len(sink) == 3 and len(sink.chunk_mut()) == 125


def test_encoder_registry(monkeypatch):
    """``Interface.register``/``new``, as the reference's: a factory of
    backends by name; an unknown name raises."""
    from compu_tpu_torch.formats import stored

    monkeypatch.setattr(encoder.Interface, "_registry", {})
    monkeypatch.setattr(decoder.Interface, "_registry", {})
    encoder.Interface.register("stored", stored.StoredEncoder)
    decoder.Interface.register("stored", stored.StoredDecoder)
    vec = ByteVec()
    res = encoder.Interface.new("stored").encode_vec_full(DATA[:5000], vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    assert vec.data() == _encode_vec_full(encoder.Interface.stored(), DATA[:5000])
    out = ByteVec()
    decoder.Interface.new("stored").decode_vec_full(vec.data(), out)
    assert out.data() == DATA[:5000]
    with pytest.raises(ValueError, match="unknown encoder backend"):
        encoder.Interface.new("zlib")


def _encode_vec_full(enc, data):
    vec = ByteVec()
    enc.encode_vec_full(data, vec, EncodeOp.Finish)
    return vec.data()


def test_bytevec_methods_match_reference():
    """capacity, spare, reserve, set_len, clear and extend step by step
    beside the reference's ByteVec."""
    from compu_tpu.vec import ByteVec as RefVec

    port, ref = ByteVec(b"xy"), RefVec(b"xy")
    steps = [("reserve", 10), ("extend", b"hello"), ("set_len", 4), ("reserve_exact", 3),
             ("add_len", 2), ("extend", b"!" * 20), ("clear",), ("extend", b"z")]
    for name, *args in steps:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
        assert (port.data(), len(port), port.capacity, port.spare) == \
            (ref.data(), len(ref), ref.capacity, ref.spare), name
    with pytest.raises(ValueError):
        port.set_len(port.capacity + 1)
