"""The port's brotli host route (``BrotliOptions(device_lz=False)``) against
the JAX package's (``compu_tpu``) on the CPU.

Every stream is bytes, so every comparison is exact (tolerance 0), and
libbrotli (``tests/brotli_oracle.py``) decodes each of the port's streams:

* qualities 1, 2, 5, 9, 10 and 11 (10 and 11 with the deeper chain walks
  and the hash-6 tier), every ``BrotliMode``, windows 16, 18 and 22;
* a one-shot input of at most 64 KiB, written with WBITS=16;
* an input past 1 MiB at quality 9 (two meta-blocks, the distance ring
  and the context tail carried between them), and chunked feeds;
* ``tests/test_options_knobs.py``'s brotli case, on the host route.

Inputs are made from a numpy seed (corpus slices and random bytes). The
reference is imported inside the tests, so the file imports neither JAX
nor ``compu_tpu`` at collection.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from compu_tpu_torch import decoder  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, EncodeStatus, Interface  # noqa: E402
from compu_tpu_torch.formats.brotli.options import BrotliMode, BrotliOptions  # noqa: E402
from compu_tpu_torch.utils.corpus import build_corpus  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()


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


def port_stream(data: bytes, chunk=None, **opts) -> bytes:
    """The port's stream of ``data``, one-shot or fed ``chunk`` bytes a
    Process call."""
    enc = Interface.brotli(BrotliOptions(device_lz=False, **opts))
    vec = ByteVec()
    for at in range(0, len(data), chunk) if chunk else ():
        enc.encode_vec_full(data[at:at + chunk], vec, EncodeOp.Process)
    res = enc.encode_vec_full(b"" if chunk else data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished, res
    return vec.data()


def ref_stream(data: bytes, mode=BrotliMode.Generic, **opts) -> bytes:
    import compu_tpu
    from compu_tpu.formats.brotli.options import BrotliMode as RefMode
    from compu_tpu.formats.brotli.options import BrotliOptions as RefOptions

    enc = compu_tpu.encoder.Interface.brotli(RefOptions(device_lz=False,
                                                        mode=RefMode(mode.value), **opts))
    vec = compu_tpu.ByteVec()
    enc.encode_vec_full(data, vec, compu_tpu.EncodeOp.Finish)
    return vec.data()


def libbrotli_decompress(blob: bytes, n: int) -> bytes:
    from brotli_oracle import decompress

    return decompress(blob, n)


def port_decode(blob: bytes) -> bytes:
    out = ByteVec()
    res = decoder.Interface.brotli().decode_vec_full(blob, out)
    assert res.status is decoder.DecodeStatus.Finished, res
    return out.data()


@pytest.mark.parametrize("window_bits", [16, 18, 22])
@pytest.mark.parametrize("mode", list(BrotliMode))
@pytest.mark.parametrize("quality", [1, 2, 5, 9, 10, 11])
def test_qualities_modes_windows_equal_reference(quality, mode, window_bits):
    """Past 64 KiB, so the configured window is the one written."""
    data = sample(80 << 10, quality)
    got = port_stream(data, quality=quality, mode=mode, window_bits=window_bits)
    assert got == ref_stream(data, quality=quality, mode=mode, window_bits=window_bits)
    assert libbrotli_decompress(got, len(data)) == data


@pytest.mark.parametrize("quality", [5, 11])
def test_small_one_shot_takes_wbits_16(quality):
    data = sample(40 << 10, 40 + quality)
    got = port_stream(data, quality=quality)
    assert got == ref_stream(data, quality=quality)
    assert got[0] & 1 == 0  # WBITS=16 is the single bit 0
    assert libbrotli_decompress(got, len(data)) == data
    assert port_decode(got) == data


def test_two_meta_blocks_equal_reference():
    """1 MiB + 50,000 bytes at quality 9: two meta-blocks; chunked feeds
    give the one-shot stream."""
    c = _corpus()
    data = c[200_000:] + sample(250_000, 5)
    got = port_stream(data, quality=9)
    assert got == ref_stream(data, quality=9)
    assert libbrotli_decompress(got, len(data)) == data
    assert port_decode(got) == data
    assert port_stream(data, chunk=300_001, quality=9) == got


# -- tests/test_options_knobs.py's brotli case, on the host route -----------------------
def test_brotli_mode_changes_output_and_roundtrips():
    text = ALICE[: 96 << 10]
    blobs = {}
    for mode in (BrotliMode.Generic, BrotliMode.Text, BrotliMode.Font):
        blob = port_stream(text, quality=4, mode=mode)
        assert port_decode(blob) == text
        blobs[mode] = blob
    # Text enables context modeling below the Generic threshold; Font
    # disables it at qualities where Generic would enable it.
    assert blobs[BrotliMode.Text] != blobs[BrotliMode.Generic]
    assert (port_stream(text, quality=9, mode=BrotliMode.Font)
            != port_stream(text, quality=9, mode=BrotliMode.Generic))
