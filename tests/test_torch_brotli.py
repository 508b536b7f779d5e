"""The port's brotli encoder (``encoder.Interface.brotli`` over the device LZ
stage) against the JAX reference's device-LZ route, on the CPU.

Every stream is bytes, so every comparison is exact (tolerance 0), and
libbrotli (``tests/brotli_oracle.py``) decodes each of the port's streams.
The reference's tokenizer runs its XLA forms on the CPU, about 3 s a 1 MiB
call, so the reference's calls are kept by their input and shared across
this module's encodes (its tokens depend on the bytes alone: quality and
mode act after it). The tests marked ``gpu`` hold the card's streams to
the CPU's, and B1 and B2 to their plain versions at the brotli shape.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import Buffer, decoder  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, EncodeStatus, Interface  # noqa: E402
from compu_tpu_torch.formats.brotli import encode as port_enc  # noqa: E402
from compu_tpu_torch.formats.brotli.options import BrotliMode, BrotliOptions  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
#: The reference's tokenizer outputs, by the bytes of the call.
_REF_TOKENS: dict = {}


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


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


def _port(data: bytes, quality=9, mode=BrotliMode.Generic, device="cpu", **opts) -> bytes:
    vec = ByteVec()
    enc = Interface.brotli(BrotliOptions(quality=quality, mode=mode, **opts), device=device)
    res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished, res
    return vec.data()


def _ref_encoder(quality=9, mode=BrotliMode.Generic, **opts):
    """The reference's ``Interface.brotli`` with ``device_lz``, its
    tokenizer's calls kept by their bytes."""
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.brotli.options import BrotliMode as RefMode
    from compu_tpu.formats.brotli.options import BrotliOptions as RefOptions

    enc = ref_encoder.Interface.brotli(RefOptions(quality=quality, mode=RefMode(mode.value),
                                                  device_lz=True, **opts))
    stream = enc._backend._stream
    tokenize = stream.tokenizer

    def kept(data):
        if data not in _REF_TOKENS:
            _REF_TOKENS[data] = tokenize(data)
        return _REF_TOKENS[data]

    stream.tokenizer = kept
    return enc


def _ref_op(name: str):
    """The reference's ``EncodeOp`` of that name: the port's enums are
    copies, unequal to the reference's."""
    from compu_tpu import EncodeOp as RefOp

    return RefOp[name]


def _ref(data: bytes, quality=9, mode=BrotliMode.Generic, **opts) -> bytes:
    from compu_tpu import ByteVec as RefVec

    vec = RefVec()
    _ref_encoder(quality, mode, **opts).encode_vec_full(data, vec, _ref_op("Finish"))
    return vec.data()


def _libbrotli_decodes(blob: bytes, data: bytes) -> None:
    import brotli_oracle

    assert brotli_oracle.decompress(blob, len(data) + 64) == data


def _decodes(blob: bytes, data: bytes) -> None:
    """libbrotli and the port's decoder give ``data`` back."""
    _libbrotli_decodes(blob, data)
    vec = ByteVec()
    res = decoder.Interface.brotli().decode_vec_full(blob, vec)
    assert res.status is decoder.DecodeStatus.Finished and vec.data() == data, res


def _noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# Streams equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality,mode", [
    (1, BrotliMode.Generic), (5, BrotliMode.Generic), (9, BrotliMode.Generic),
    (11, BrotliMode.Generic), (9, BrotliMode.Text), (9, BrotliMode.Font)])
def test_alice_equals_reference(jax_cpu, quality, mode):
    blob = _port(ALICE, quality, mode)
    assert blob == _ref(ALICE, quality, mode)
    _libbrotli_decodes(blob, ALICE)


def test_multi_meta_block_equals_reference(jax_cpu):
    """tests/test_brotli.py's two meta-block input: 1 MiB + 123,456 bytes."""
    data = (ALICE * 10)[: (1 << 20) + 123_456]
    blob = _port(data, 5)
    assert blob == _ref(data, 5)
    _libbrotli_decodes(blob, data)


@pytest.mark.parametrize("quality", [1, 5, 9])
def test_distance_ring_carry_equals_reference(jax_cpu, quality):
    """tests/test_brotli.py's ring-carry input: a text meta-block, then one
    whose first copy is ring-relative; the ring crosses meta-blocks."""
    data = (ALICE * 40)[: 1 << 20] + b"A" * 1024
    blob = _port(data, quality)
    assert blob == _ref(data, quality)
    _libbrotli_decodes(blob, data)


@pytest.mark.parametrize("kind", ["noise", "run"])
def test_incompressible_and_runs_equal_reference(jax_cpu, kind):
    data = _noise(10_000, 7) if kind == "noise" else b"z" * 50_000
    blob = _port(data)
    assert blob == _ref(data)
    _libbrotli_decodes(blob, data)


def _chunked(enc, buf, data: bytes, op) -> bytes:
    """``data`` through ``buf``, a ``Buffer(4096)``: its first half in
    4,096-byte pieces under Process, then a Flush, then the rest under
    Finish, the buffer drained after every call. ``op(name)`` is the
    encoder's package's ``EncodeOp``."""
    out = bytearray()
    half = len(data) // 2
    steps = [(data[i:min(i + 4096, half)], "Process") for i in range(0, half, 4096)]
    steps += [(b"", "Flush"), (data[half:], "Finish")]
    for piece, name in steps:
        rem = memoryview(piece)
        while True:
            consumed, res = buf.encode(enc, rem, op(name))
            rem = rem[consumed:]
            out += buf.data()
            buf.consume()
            assert res.status.name != "Error", res
            if res.status.name != "NeedOutput" and not len(rem):
                break
    return bytes(out)


def test_chunked_encode_equals_reference(jax_cpu):
    """Process pieces, a Flush and Finish through ``Buffer(4096)``: the
    port's stream equals the reference's driven the same way."""
    from compu_tpu import Buffer as RefBuffer

    data = ALICE + (ALICE * 8)[: 1 << 20]
    port = _chunked(Interface.brotli(BrotliOptions(quality=5), device="cpu"), Buffer(4096),
                    data, EncodeOp.__getitem__)
    assert port == _chunked(_ref_encoder(5), RefBuffer(4096), data, _ref_op)
    _libbrotli_decodes(port, data)


# ---------------------------------------------------------------------------
# The window of a one-shot input of 64 KiB or less
# ---------------------------------------------------------------------------

def _window_case() -> bytes:
    """65,536 bytes of noise with b"QWERTY" at 0 and at 65,530: a match
    at distance 65,530, past the 65,520 that WBITS=16 allows."""
    data = bytearray(_noise(65_536, 5))
    data[0:6] = data[65_530:65_536] = b"QWERTY"
    return bytes(data)


def test_small_window_stream_decodes(jax_cpu, monkeypatch):
    """The one-shot input is written with WBITS=16 and the port's tokenizer
    is made for that window: no distance passes 65,520 and the stream
    decodes. The reference's tokenizer keeps the configured window's
    reach, so its stream of the same input does not give it back."""
    calls = []

    class Recording(port_enc.DeviceTokenizer):
        def __call__(self, chunk):
            out = super().__call__(chunk)
            calls.append((self.max_dist, out))
            return out

    monkeypatch.setattr(port_enc, "DeviceTokenizer", Recording)
    data = _window_case()
    blob = _port(data)
    assert blob[0] & 1 == 0  # WBITS=16 is one 0 bit
    (max_dist, (_, ln, dist)), = calls
    assert max_dist == 65_520 and int(dist[ln > 0].max()) <= 65_520
    _decodes(blob, data)
    import brotli_oracle

    ref = _ref(data)
    try:
        back = brotli_oracle.decompress(ref, len(data) + 64)
    except RuntimeError:
        back = None
    assert back != data


def test_reset_restores_the_window():
    """After a one-shot small input (WBITS=16), ``reset`` gives the
    configured window back: the reused encoder writes WBITS=22 for an
    input with matches 70,000 back, and the stream decodes."""
    enc = Interface.brotli(BrotliOptions(quality=1), device="cpu")
    vec = ByteVec()
    enc.encode_vec_full(ALICE[:1000], vec, EncodeOp.Finish)
    assert vec.data()[0] & 1 == 0
    enc.reset()
    half = _noise(70_000, 9)
    data = half + half
    vec = ByteVec()
    enc.encode_vec_full(data, vec, EncodeOp.Finish)
    assert vec.data()[0] & 0xF == 1 | (22 - 17) << 1  # WBITS=22: 1, then 5 in 3 bits
    _decodes(vec.data(), data)


def test_default_device_is_cuda():
    """With no ``device`` the LZ stage runs on CUDA: without a card the
    encode raises, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    enc = Interface.brotli()
    vec = ByteVec()
    with pytest.raises((AssertionError, RuntimeError)):
        enc.encode_vec_full(ALICE[:1000], vec, EncodeOp.Finish)
    assert enc._backend._stream.tokenizer.device == torch.device("cuda")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_card_stream_equals_cpu_gpu(cuda):
    for data in (ALICE, (ALICE * 10)[: (1 << 20) + 123_456]):
        assert _port(data, device=cuda) == _port(data)


@pytest.mark.gpu
def test_b1_b2_at_brotli_shape_gpu(cuda):
    """B1 and B2 on one 1 MiB tokenizer call of the corpus at the brotli
    encoder's settings: wcap 32, 2 sort keys, stride 1, depth 8, max_dist
    2^20 (window 22)."""
    from compu_tpu_torch.kernels import u32
    from compu_tpu_torch.kernels.deflate_v2 import _post_match
    from compu_tpu_torch.kernels.lcp_match import (
        lcp_candidates_cuda,
        lcp_candidates_torch,
        sort_stage_lex,
    )
    from compu_tpu_torch.kernels.parse_cover import parse_cover_cuda, parse_cover_steps_torch
    from compu_tpu_torch.utils.corpus import build_corpus

    N = 1 << 20
    blocks = torch.from_numpy(np.frombuffer(build_corpus(N), np.uint8).copy()[None]).to(cuda)
    *wbe, ps = sort_stage_lex(blocks, wcap=32, keys=2, stride=1)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    ps32 = ps.reshape(-1).to(torch.int32)
    kw = dict(depth=8, max_dist=N, block_elems=N)
    want = lcp_candidates_torch(words, ps32, **kw)
    got = lcp_candidates_cuda(words, ps32, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[1].max()) > 131071  # distances past the zstd path's window occur
    step, *_ = _post_match(blocks, torch.tensor([N], device=cuda), ps,
                           want[0].reshape(1, -1).to(torch.int64),
                           want[1].reshape(1, -1).to(torch.int64), wcap=32)
    step = step.reshape(-1)
    assert torch.equal(parse_cover_cuda(step), parse_cover_steps_torch(step))
