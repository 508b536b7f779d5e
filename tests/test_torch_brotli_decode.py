"""The port's brotli decoder (``decoder.Interface.brotli``), ``Detection``
and the stored format (``Interface.stored``) against the reference's, on
the CPU, and the brotli data files against the reference's copies.

Every output is bytes or integers, so every comparison is exact
(tolerance 0). Streams come from ``tests/data`` and from libbrotli
(``tests/brotli_oracle.py``). Both decoders are host code, so no test
needs the card.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import brotli_oracle  # noqa: E402
from compu_tpu_torch import Detection, decoder  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface  # noqa: E402
from compu_tpu_torch.formats.brotli import consts  # noqa: E402
from compu_tpu_torch.formats.brotli.transforms_data import TRANSFORMS  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()


def _same(port, ref) -> None:
    """Two (Decode, bytes) results are equal: the remainders, the status
    by name or the error by code, and the bytes out."""
    (p, p_out), (r, r_out) = port, ref
    assert (p.input_remain, p.output_remain) == (r.input_remain, r.output_remain)
    if r.is_error:
        assert p.is_error and p.status.code == r.status.code
    else:
        assert not p.is_error and p.status.name == r.status.name
    assert p_out == r_out


def _both(port_dec, ref_dec, blob: bytes):
    """(port, reference) results of decoding ``blob`` in one call each."""
    from compu_tpu import ByteVec as RefVec

    port_vec, ref_vec = ByteVec(), RefVec()
    return ((port_dec.decode_vec_full(blob, port_vec), port_vec.data()),
            (ref_dec.decode_vec_full(blob, ref_vec), ref_vec.data()))


def _both_brotli(blob: bytes):
    from compu_tpu import decoder as ref_decoder

    return _both(decoder.Interface.brotli(), ref_decoder.Interface.brotli(), blob)


# ---------------------------------------------------------------------------
# decoder.Interface.brotli
# ---------------------------------------------------------------------------

_STREAMS = {
    "alice29.txt.br": lambda: (DATA / "alice29.txt.br").read_bytes(),
    "10x10y.br": lambda: (DATA / "10x10y.br").read_bytes(),
    **{f"libbrotli-q{q}": (lambda q=q: brotli_oracle.compress(ALICE, q))
       for q in (0, 1, 2, 5, 9, 11)},
    **{f"libbrotli-mode{m}": (lambda m=m: brotli_oracle.compress(ALICE[:40000], 11, 22, m))
       for m in (0, 1, 2)},
    "libbrotli-window10": lambda: brotli_oracle.compress(ALICE, 9, 10),
}
_PLAIN = {"alice29.txt.br": ALICE, "10x10y.br": (DATA / "10x10y").read_bytes(),
          **{f"libbrotli-mode{m}": ALICE[:40000] for m in (0, 1, 2)}}


@pytest.mark.parametrize("name", list(_STREAMS))
def test_decode_equals_reference(name):
    blob = _STREAMS[name]()
    port, ref = _both_brotli(blob)
    _same(port, ref)
    assert port[0].status is decoder.DecodeStatus.Finished
    assert port[1] == _PLAIN.get(name, ALICE)


@pytest.mark.parametrize("where", [0.02, 0.1, 0.3, 0.6, 0.95])
def test_flipped_byte_equals_reference(where):
    """One byte of a libbrotli stream (quality 11, text mode: context maps
    and block switches) flipped: the same status, error code and bytes out
    as the reference."""
    from compu_tpu import decoder as ref_decoder

    blob = bytearray(brotli_oracle.compress(ALICE[:40000], 11, 22, 1))
    blob[int(where * len(blob))] ^= 0xA5
    port_dec, ref_dec = decoder.Interface.brotli(), ref_decoder.Interface.brotli()
    port, ref = _both(port_dec, ref_dec, bytes(blob))
    _same(port, ref)
    assert port[1] != ALICE[:40000]
    if port[0].is_error:
        assert port_dec.describe_error(port[0].status) == ref_dec.describe_error(ref[0].status)


def test_truncated_stream_needs_input():
    blob = brotli_oracle.compress(ALICE, 9)[:-100]
    port, ref = _both_brotli(blob)
    _same(port, ref)
    assert port[0].status is decoder.DecodeStatus.NeedInput


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

_SNIFFED = ["alice29.txt.gz", "alice29.txt.zz", "alice29.txt.zst", "alice29.txt.br",
            "10x10y.gz", "10x10y.zz", "10x10y.zst", "10x10y.br", "alice29.txt"]


@pytest.mark.parametrize("blob", [(DATA / n).read_bytes() for n in _SNIFFED]
                         + [b"", b"\x1f", b"\x1f\x8b", b"\x78\x9c", b"\x28\xb5\x2f",
                            b"\x28\xb5\x2f\xfd"],
                         ids=_SNIFFED + ["0B", "1B", "2B-gzip", "2B-zlib", "3B", "4B-zstd"])
def test_detection_equals_reference(blob):
    from compu_tpu import Detection as RefDetection

    port, ref = Detection.detect(blob), RefDetection.detect(blob)
    assert (port is None and ref is None) or port.value == ref.value


# ---------------------------------------------------------------------------
# Interface.stored
# ---------------------------------------------------------------------------

def _stored_encode(enc, data: bytes, op) -> bytes:
    """Process the first half, Flush, Finish the rest; ``op(name)`` is the
    encoder's package's ``EncodeOp``."""
    out = bytearray(len(data) + 64)
    view, at = memoryview(out), 0
    half = len(data) // 2
    for piece, name in ((data[:half], "Process"), (b"", "Flush"), (data[half:], "Finish")):
        res = enc.encode(piece, view[at:], op(name))
        assert res.input_remain == 0 and res.status.name != "Error", res
        at = len(out) - res.output_remain
    return bytes(out[:at])


@pytest.mark.parametrize("data", [b"", b"x", b"xy", (DATA / "10x10y").read_bytes(), ALICE],
                         ids=["0B", "1B", "2B", "10x10y", "alice29"])
def test_stored_equals_reference(data):
    from compu_tpu import EncodeOp as RefOp
    from compu_tpu import decoder as ref_decoder
    from compu_tpu import encoder as ref_encoder

    blob = _stored_encode(Interface.stored(), data, EncodeOp.__getitem__)
    assert blob == _stored_encode(ref_encoder.Interface.stored(), data, RefOp.__getitem__)
    port, ref = _both(decoder.Interface.stored(), ref_decoder.Interface.stored(), blob)
    _same(port, ref)
    assert port[0].status is decoder.DecodeStatus.Finished and port[1] == data
    bad = bytearray(blob)
    bad[-1] ^= 1  # the adler32 trailer
    port, ref = _both(decoder.Interface.stored(), ref_decoder.Interface.stored(), bytes(bad))
    _same(port, ref)
    assert port[0].is_error


# ---------------------------------------------------------------------------
# The data files
# ---------------------------------------------------------------------------

def test_brotli_data_equals_reference():
    from compu_tpu.formats.brotli import consts as ref
    from compu_tpu.formats.brotli.transforms_data import TRANSFORMS as REF_TRANSFORMS

    assert consts.DICTIONARY == ref.DICTIONARY and len(consts.DICTIONARY) == 122_784
    assert consts.CONTEXT_TABLE.tobytes() == ref.CONTEXT_TABLE.tobytes()
    assert len(consts.CONTEXT_TABLE) == 2048
    assert TRANSFORMS == REF_TRANSFORMS and len(TRANSFORMS) == 121
    for name in ("DICT_SIZE_BITS", "DICT_OFFSETS", "CLCODE_ORDER", "CLCODE_LUT_LEN",
                 "CLCODE_LUT_VAL", "BLOCK_COUNT_BASE", "BLOCK_COUNT_EXTRA", "INSERT_BASE",
                 "INSERT_EXTRA", "COPY_BASE", "COPY_EXTRA", "INSERT_RANGE_LUT",
                 "COPY_RANGE_LUT", "INITIAL_DISTANCES"):
        assert getattr(consts, name) == getattr(ref, name), name
