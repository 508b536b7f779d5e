"""The port's foreign-stream device inflate (``decoder.Interface.zlib_device``
on the CPU, kernel P4's plain version) against the JAX reference's
``Interface.zlib_device``, on every case of ``tests/test_device_inflate.py``
(the golden fixtures, zlib levels, window history across full flushes, the
partial-output restart, ``Buffer(4096)`` chunking and ``decode_vec_full``,
chunked input, corruption) and on a fixed-Huffman stream of high-byte
literals, a Huffman-only stream that overflows the lanes' record slots
(``DecodeError(-3)`` in both) and streams cut inside their first block
header. Each case drives both decoders the same way and records every
call's output bytes, status, error code and ``input_remain`` /
``output_remain``; the records must be equal (exact). Marked ``gpu``: the
card's decode equals the CPU's, with P4 launched.

The one intended difference: a stream cut inside a block header. The
port returns NeedInput and, given the rest, finishes; the reference's bit
reader raises ``NeedMoreBits`` out of ``decode``. The test shows both.
"""

import pathlib
import sys
import types
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import compu_tpu_torch  # noqa: E402
from compu_tpu_torch import _build  # noqa: E402
from compu_tpu_torch.vec import ByteVec  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
TINY = b"X" * 10 + b"Y" * 10


def port_api(device="cpu"):
    """The port's decoder surface, with ``zlib_device`` on ``device``."""
    from compu_tpu_torch import decoder

    return types.SimpleNamespace(
        zlib_device=lambda options=None: decoder.Interface.zlib_device(options, device=device),
        Buffer=compu_tpu_torch.Buffer, ByteVec=ByteVec, Mode=compu_tpu_torch.ZlibMode)


@pytest.fixture
def ref():
    """The reference's decoder surface (its ``zlib_device`` runs JAX on the CPU)."""
    pytest.importorskip("jax")
    import compu_tpu
    from compu_tpu import decoder
    from compu_tpu.formats.deflate.options import ZlibMode

    return types.SimpleNamespace(zlib_device=decoder.Interface.zlib_device,
                                 Buffer=compu_tpu.Buffer, ByteVec=compu_tpu.ByteVec,
                                 Mode=ZlibMode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def outcome(res) -> tuple:
    """A decode result as plain values: remains, and the status's name or
    ("error", code)."""
    status = res.status
    kind = ("error", status.code) if hasattr(status, "code") else status.name
    return res.input_remain, res.output_remain, kind


def one_shot(api, mode: str, blob: bytes, size: int, log: list, dec=None):
    dec = dec or api.zlib_device(api.Mode[mode])
    out = bytearray(size + 16)
    res = dec.decode(blob, out)
    log.append((outcome(res), bytes(out[:len(out) - res.output_remain])))
    return dec


def case_golden_gzip(api, log):
    for name in ("10x10y", "alice29.txt"):
        raw = (DATA / name).read_bytes()
        blob = (DATA / f"{name}.gz").read_bytes()
        dec = one_shot(api, "Gzip", blob, len(raw), log)
        log.append(dec.reset())
        one_shot(api, "Gzip", blob, len(raw), log, dec)
        one_shot(api, "Auto", blob, len(raw), log)


def case_golden_zlib(api, log):
    one_shot(api, "Zlib", (DATA / "10x10y.zz").read_bytes(), 20, log)


def case_levels(api, log):
    raw = TEXT[:65536]
    for level in (0, 1, 6, 9):
        one_shot(api, "Zlib", zlib.compress(raw, level), len(raw), log)


def case_window_history(api, log):
    raw = TEXT[:40000]
    co = zlib.compressobj(6)
    blob = b"".join([co.compress(raw[:10000]), co.flush(zlib.Z_FULL_FLUSH),
                     co.compress(raw[10000:20000]), co.flush(zlib.Z_FULL_FLUSH),
                     co.compress(raw[20000:]), co.flush(zlib.Z_FINISH)])
    one_shot(api, "Zlib", blob, len(raw), log)


def case_partial_output_restart(api, log):
    raw = (DATA / "10x10y").read_bytes()
    blob = (DATA / "10x10y.gz").read_bytes()
    dec = api.zlib_device(api.Mode.Gzip)
    half = bytearray(len(raw) // 2)
    res = dec.decode(blob, half)
    log.append((outcome(res), bytes(half)))
    rest = bytearray(len(raw))
    res = dec.decode(blob[len(blob) - res.input_remain:], rest)
    log.append((outcome(res), bytes(rest[:len(rest) - res.output_remain])))


def case_buffer_chunked_and_vec_full(api, log):
    raw = TEXT[:30000]
    blob = zlib.compress(raw, 6)
    dec = api.zlib_device(api.Mode.Zlib)
    buf = api.Buffer(4096)
    inp = memoryview(blob)
    for _ in range(64):
        consumed, res = buf.decode(dec, inp)
        log.append((consumed, outcome(res), buf.data()))
        buf.consume()
        inp = inp[consumed:]
        if res.is_error or outcome(res)[2] == "Finished":
            break
    vec = api.ByteVec()
    res = api.zlib_device(api.Mode.Zlib).decode_vec_full(blob, vec)
    log.append((outcome(res), vec.data()))


def case_chunked_input(api, log):
    raw = TINY * 50
    blob = zlib.compress(raw, 6)
    dec = api.zlib_device(api.Mode.Zlib)
    out = bytearray(len(raw) + 16)
    written = 0
    step = max(1, len(blob) // 4)
    for i in range(0, len(blob), step):
        res = dec.decode(blob[i:i + step], memoryview(out)[written:])
        written = len(out) - res.output_remain
        log.append((outcome(res), bytes(out[:written])))


def case_corrupt(api, log):
    raw = TEXT[:30000]
    blob = bytearray(zlib.compress(raw, 6))
    blob[len(blob) // 2] ^= 0xFF
    one_shot(api, "Zlib", bytes(blob), len(raw), log)
    assert log[-1][0][2] != "Finished"


def case_fixed_high_bytes(api, log):
    """Fixed-Huffman 9-bit literal codes (bytes >= 144) and runs."""
    rng = np.random.default_rng(11)
    raw = (TEXT[:2000] + rng.integers(144, 256, 3000, dtype=np.uint8).tobytes()
           + b"z" * 700) * 2
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_FIXED)
    one_shot(api, "Zlib", co.compress(raw) + co.flush(), len(raw), log)
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    one_shot(api, "Deflate", co.compress(raw) + co.flush(), len(raw), log)


def case_overflow(api, log):
    """A valid Huffman-only stream whose 1-bit codes put more than 192
    tokens in a 512-bit chunk: both decoders refuse it."""
    raw = b"a" * 20000 + b"b" + b"a" * 20000
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_HUFFMAN_ONLY)
    one_shot(api, "Zlib", co.compress(raw) + co.flush(), len(raw), log)
    assert log[-1][0][2] == ("error", -3)


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", list(CASES))
def test_port_equals_reference(ref, case):
    want, got = [], []
    CASES[case](ref, want)
    CASES[case](port_api(), got)
    assert got == want


@pytest.mark.parametrize("cut", [3, 10, 40])
def test_truncated_header(ref, cut):
    """Cut inside the first dynamic block's header: the port waits for
    input and then finishes with the rest; the reference raises the bit
    reader's NeedMoreBits."""
    from compu_tpu.ops.bitio import NeedMoreBits

    blob = zlib.compress(TEXT, 6)
    with pytest.raises(NeedMoreBits):
        ref.zlib_device(ref.Mode.Zlib).decode(blob[:cut], bytearray(len(TEXT) + 16))
    api = port_api()
    dec = api.zlib_device(api.Mode.Zlib)
    out = bytearray(len(TEXT) + 16)
    res = dec.decode(blob[:cut], out)
    assert outcome(res) == (0, len(out), "NeedInput")
    res = dec.decode(blob[cut:], out)
    assert outcome(res) == (0, 16, "Finished") and bytes(out[:len(TEXT)]) == TEXT


def test_truncated_body_needs_input_in_both(ref):
    blob = zlib.compress(TEXT, 6)
    for api in (ref, port_api()):
        res = api.zlib_device(api.Mode.Zlib).decode(blob[:len(blob) // 2], bytearray(100))
        assert outcome(res) == (0, 100, "NeedInput")


def test_describe_error_and_sticky_error():
    api = port_api()
    blob = bytearray(zlib.compress(TEXT[:30000], 6))
    blob[len(blob) // 2] ^= 0xFF
    dec = api.zlib_device(api.Mode.Zlib)
    res = dec.decode(bytes(blob), bytearray(40000))
    assert res.is_error
    assert dec.decode(b"", bytearray(10)).status == res.status  # sticky until reset
    assert dec.describe_error(101) == "invalid stream header"
    assert dec.reset()
    vec = ByteVec()
    assert outcome(dec.decode_vec_full(zlib.compress(TINY), vec))[2] == "Finished"
    assert vec.data() == TINY


def test_options_and_auto():
    from compu_tpu_torch.formats.deflate.options import ZlibDecodeOptions, ZlibOptions

    Mode = compu_tpu_torch.ZlibMode
    with pytest.raises(ValueError, match="decode-only"):
        ZlibOptions(mode=Mode.Auto)
    assert ZlibDecodeOptions().mode is Mode.Auto
    api = port_api()
    raw = TEXT[:5000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    for blob in (zlib.compress(raw), zlib.compress(raw, wbits=31), co.compress(raw) + co.flush()):
        vec = ByteVec()
        res = api.zlib_device(ZlibDecodeOptions()).decode_vec_full(blob, vec)
        assert outcome(res)[::2] == (0, "Finished") and vec.data() == raw


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from compu_tpu_torch import decoder

    dec = decoder.Interface.zlib_device()
    assert dec._backend.device == torch.device("cuda")
    with pytest.raises((AssertionError, RuntimeError)):
        dec.decode(zlib.compress(TEXT[:1000]), bytearray(2000))


@pytest.mark.gpu
def test_card_decode_equals_cpu_gpu(cuda):
    from compu_tpu_torch.utils.corpus import build_corpus

    raw = build_corpus(1 << 20)
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    blob = co.compress(raw) + co.flush()
    api = port_api(None)
    before = _build.LAUNCHES["inflate_spec"]
    got, cpu = [], []
    one_shot(api, "Auto", blob, len(raw), got)
    assert _build.LAUNCHES["inflate_spec"] > before
    one_shot(port_api("cpu"), "Auto", blob, len(raw), cpu)
    assert got == cpu and got[0][1] == raw


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["golden_gzip", "window_history", "fixed_high_bytes",
                                  "overflow", "corrupt"])
def test_card_cases_equal_cpu_gpu(cuda, case):
    got, cpu = [], []
    CASES[case](port_api(None), got)
    CASES[case](port_api("cpu"), cpu)
    assert got == cpu
