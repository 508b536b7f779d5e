"""The port's zstd device encode against the JAX reference, on the CPU: the
copied host entropy pieces, the device literal streams, the FSE sequence
scan and pack, and whole frames through ``Interface.zstd``.

Every output is bytes or integers, so every comparison is exact
(tolerance 0). The reference runs with its native host helpers switched
off, so both sides take the same pure-Python host code (the reference's
helpers are byte-identical twins of it). The tests marked ``gpu`` hold
the CUDA scan to its plain version and the card's frame to the CPU's.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface  # noqa: E402
from compu_tpu_torch.formats.device_lz import DeviceTokenizer  # noqa: E402
from compu_tpu_torch.formats.zstd import encode as port_enc  # noqa: E402
from compu_tpu_torch.formats.zstd import fse, huff  # noqa: E402
from compu_tpu_torch.formats.zstd import tables as T  # noqa: E402
from compu_tpu_torch.formats.zstd.options import ZstdOptions  # noqa: E402
from compu_tpu_torch.kernels import zstd_seq  # noqa: E402
from compu_tpu_torch.kernels.zstd_literals import encode_streams_device  # noqa: E402
from compu_tpu_torch.ops.xxhash import xxh64  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
DEVICE_ALL = dict(device_literals=True, device_sequences=True)
#: The reference's settings for the same frame: its device LZ stage, at a
#: level whose host parse the device-LZ route does not use.
REF_ALL = dict(level=6, device_lz=True, **DEVICE_ALL)


@pytest.fixture
def jax_cpu(monkeypatch):
    """The JAX reference on the CPU (tests/conftest.py pins the platform),
    with its native host helpers off."""
    pytest.importorskip("jax")
    from compu_tpu.runtime import native

    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' large CPU ops: the suite runs
    several workers on a few cores, where spinning thread pools cost more
    than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _encode(data: bytes, device, **opts) -> bytes:
    vec = ByteVec()
    Interface.zstd(ZstdOptions(**{**DEVICE_ALL, **opts}), device=device).encode_vec_full(
        data, vec, EncodeOp.Finish)
    return vec.data()


@functools.lru_cache(maxsize=4)
def _port_frame(data: bytes, **opts) -> bytes:
    """The port's frame on the CPU, kept for the tests that share it."""
    return _encode(data, "cpu", **opts)


def _ref_frame(data: bytes) -> bytes:
    from compu_tpu import ByteVec as RefVec
    from compu_tpu import EncodeOp as RefOp
    from compu_tpu import encoder as ref_encoder
    from compu_tpu.formats.zstd.options import ZstdOptions as RefOptions

    vec = RefVec()
    ref_encoder.Interface.zstd(RefOptions(**REF_ALL)).encode_vec_full(data, vec, RefOp.Finish)
    return vec.data()


def _histograms(seed: int, count: int = 6):
    """Seeded histograms: skewed, flat, two symbols, one dominant."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        size = int(rng.integers(2, 64))
        h = (rng.pareto(1.0 + k / 3, size) * 50).astype(np.int64)
        h[rng.integers(0, size, 2)] += 1
        out.append(h)
    out.append(np.array([900, 1], np.int64))
    out.append(np.array([5, 0, 0, 7, 1000, 0, 3], np.int64))
    return out


# ---------------------------------------------------------------------------
# The copied host pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_fse_tables_and_descriptions_equal_reference(jax_cpu, seed):
    from compu_tpu.formats.zstd import fse as ref_fse
    from compu_tpu.formats.zstd import huff as ref_huff

    for h in _histograms(seed):
        for max_log in (6, 8, 9):
            norm, log = huff.normalize_counts(h, int(h.sum()), max_log)
            assert (norm, log) == ref_huff.normalize_counts(h, int(h.sum()), max_log)
            if norm is None:
                continue
            assert fse.write_norm_counts(norm, log) == ref_fse.write_norm_counts(norm, log)
            port, ref = fse.FseEncodeTable(norm, log), ref_fse.FseEncodeTable(norm, log)
            for name in ("state_table", "delta_nbits", "delta_find"):
                assert np.array_equal(getattr(port, name), getattr(ref, name))
            assert ([port.init_state(s) for s in np.nonzero(h)[0]]
                    == [ref.init_state(s) for s in np.nonzero(h)[0]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huffman_description_and_streams_equal_reference(jax_cpu, seed):
    from compu_tpu.formats.zstd import huff as ref_huff

    rng = np.random.default_rng(seed)
    lits = bytes(rng.choice(256, 5000, p=np.bincount(np.frombuffer(TEXT, np.uint8),
                                                     minlength=256) / len(TEXT)).astype(np.uint8))
    for data in (lits, TEXT[:3000], bytes(rng.integers(0, 256, 2000, dtype=np.uint8))):
        freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
        port, ref = huff.HufEncoder(freqs), ref_huff.HufEncoder(freqs)
        assert port.describe() == ref.describe()
        assert np.array_equal(port.code, ref.code) and np.array_equal(port.nbits, ref.nbits)
        assert port.encode_stream(data) == ref.encode_stream(data)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, 65537])
def test_xxh64_equals_reference(jax_cpu, n):
    from compu_tpu.ops.xxhash import xxh64_py

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for seed in (0, 12345):
        assert xxh64(data, seed) == xxh64_py(data, seed)


# ---------------------------------------------------------------------------
# The device stages, on the CPU
# ---------------------------------------------------------------------------

def test_literal_streams_equal_reference_and_host_writer(jax_cpu):
    from compu_tpu.kernels.zstd_literals_jax import encode_streams_device as ref_streams

    lits = TEXT[:40000]
    freqs = np.bincount(np.frombuffer(lits, np.uint8), minlength=256)
    enc = huff.HufEncoder(freqs)
    per = (len(lits) + 3) // 4
    chunks = [lits[i * per:(i + 1) * per] for i in range(3)] + [lits[3 * per:]]
    port = encode_streams_device(chunks, enc.code, enc.nbits, "cpu")
    assert port == [enc.encode_stream(c) for c in chunks]
    assert port == ref_streams(chunks, enc.code, enc.nbits)


@functools.lru_cache(maxsize=1)
def _text_tokens():
    """The token cover of alice29.txt from one tokenizer call, as the
    device-LZ encoder makes it."""
    return DeviceTokenizer(1 << 20, 131071, device="cpu")(TEXT)


def _block_sequences(off: int = 0, end: int = 1 << 17):
    """The sequences of alice29.txt[off:end] as the device-LZ encoder makes
    them."""
    sub = port_enc._slice_token_cover(*_text_tokens(), off, end)
    return port_enc._sequences_from_tokens(np.frombuffer(TEXT[off:end], np.uint8), *sub)[1]


def _channels(seqs, mod=None):
    """What _sequences_section gives the bitstream writer: codes, offset
    values and the three chosen tables, from the port's modules (or the
    reference's encode module ``mod``)."""
    mod = mod or port_enc
    ll_codes = [T.ll_code(ll) for ll, _, _ in seqs]
    of_values, _ = mod._resolve_offset_values(seqs)
    of_codes = [mod._offset_code(v) for v in of_values]
    ml_codes = [T.ml_code(ml) for _, _, ml in seqs]
    tabs = [mod._SeqTable(c, dist, log, ms, ml) for c, dist, log, ms, ml in (
        (ll_codes, T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG, T.MAX_LL_SYMBOL, T.MAX_LL_LOG),
        (ml_codes, T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG, T.MAX_ML_SYMBOL, T.MAX_ML_LOG),
        (of_codes, T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG, T.MAX_OF_SYMBOL, T.MAX_OF_LOG))]
    return ll_codes, ml_codes, of_codes, of_values, tabs


@pytest.mark.parametrize("span", [(0, 1 << 17), (1 << 17, 152089), (5000, 5400)])
def test_sequence_bitstream_equals_reference(jax_cpu, span):
    """The scan's plain version plus the pack give the reference's device
    bitstream and the host push loop's, on alice29.txt's sequences."""
    from compu_tpu.formats.zstd import encode as ref_enc

    seqs = _block_sequences(*span)
    ll_codes, ml_codes, of_codes, of_values, (ll_t, ml_t, of_t) = _channels(seqs)
    port = port_enc._sequences_bitstream_device(
        seqs, ll_codes, ml_codes, of_codes, of_values, ll_t, ml_t, of_t, "cpu")
    r = _channels(seqs, ref_enc)
    ref = ref_enc._sequences_bitstream_device(seqs, r[0], r[1], r[2], r[3], *r[4])
    assert port == ref
    host = port_enc._sequences_section(seqs)
    assert port_enc._sequences_section(seqs, device="cpu") == host
    assert host.endswith(port)


def test_sequence_bitstream_rle_channel_equals_host(jax_cpu):
    """A channel in RLE mode (no table: no state pushes): every match
    length the same."""
    seqs = [(int(ll), int(off), 20) for ll, off in zip(
        np.random.default_rng(4).integers(0, 40, 300),
        np.random.default_rng(5).integers(1, 5000, 300))]
    _, _, _, _, (ll_t, ml_t, of_t) = _channels(seqs)
    assert ml_t.enc is None and ll_t.enc is not None
    assert port_enc._sequences_section(seqs, device="cpu") == port_enc._sequences_section(seqs)


def test_offset_codes_past_the_pack_raise():
    seqs = [(0, (1 << 25) + 5, 10), (3, 7, 4)]
    ll_codes, ml_codes, of_codes, of_values, tabs = _channels(seqs)
    with pytest.raises(ValueError, match="24 bits"):
        port_enc._sequences_bitstream_device(
            seqs, ll_codes, ml_codes, of_codes, of_values, *tabs, "cpu")


# ---------------------------------------------------------------------------
# Whole frames
# ---------------------------------------------------------------------------

def test_frame_alice_equals_reference_and_decodes(jax_cpu):
    zstandard = pytest.importorskip("zstandard")
    port = _port_frame(TEXT)
    assert port == _ref_frame(TEXT)
    assert _port_frame(TEXT, device_literals=False, device_sequences=False) == port
    assert zstandard.ZstdDecompressor().decompress(port, max_output_size=len(TEXT)) == TEXT


def test_frame_corpus_head_equals_reference_and_decodes(jax_cpu):
    """The first 2 MiB of the benchmark corpus: two tokenizer calls, 16
    frame blocks of text, matches past DEFLATE's window."""
    zstandard = pytest.importorskip("zstandard")
    from compu_tpu_torch.utils.corpus import build_corpus

    data = build_corpus()[:2 << 20]
    port = _port_frame(data)
    assert port == _ref_frame(data)
    assert zstandard.ZstdDecompressor().decompress(port, max_output_size=len(data)) == data


def test_blocks_of_every_kind_equal_reference(jax_cpu):
    """Frame blocks of each part of the benchmark corpus, one after another
    with the stream state carried: text and JSON records, low-entropy bytes,
    noise (a raw block) and a run of one byte (an RLE block). Both encoders
    take the port's token cover (the tokenizers agree,
    ``tests/test_torch_zstd_lz.py``), so the reference's device stages and
    host entropy code are held to the port's without a second LZ stage."""
    from compu_tpu.formats.zstd import encode as ref_enc
    from compu_tpu_torch.utils.corpus import build_corpus

    c = build_corpus()
    data = (c[:1 << 16] + c[6_000_000:6_000_000 + (1 << 16)]
            + c[13_000_000:13_000_000 + (1 << 17)] + c[-(1 << 17):] + b"z" * 5000)
    tok = DeviceTokenizer(1 << 20, 131071, device="cpu")(data)
    port_state, ref_state, kinds = {}, {}, []
    for off in range(0, len(data), port_enc.MAX_BLOCK):
        end = min(off + port_enc.MAX_BLOCK, len(data))
        sub = port_enc._slice_token_cover(*tok, off, end)
        port = port_enc.compress_block(data[off:end], tokenizer=lambda d: sub,
                                       reuse=port_state, device_literals=True,
                                       device_sequences=True, device="cpu")
        ref = ref_enc.compress_block(data[off:end], 6, tokenizer=lambda d: sub,
                                     reuse=ref_state, device_literals=True,
                                     device_sequences=True)
        assert port == ref
        kinds.append((port[0] >> 1) & 3)
    assert kinds == [2, 2, 0, 1]


def test_chunked_encode_equals_one_shot():
    """Input fed in pieces gives the one-shot frame (block boundaries sit at
    absolute offsets)."""
    enc = Interface.zstd(ZstdOptions(**DEVICE_ALL), device="cpu")
    vec = ByteVec()
    for i in range(0, len(TEXT), 40000):
        enc.encode_vec_full(TEXT[i:i + 40000], vec, EncodeOp.Process)
    enc.encode_vec_full(b"", vec, EncodeOp.Finish)
    assert vec.data() == _port_frame(TEXT)


def test_default_options_take_the_device_lz_route(jax_cpu):
    """``Interface.zstd()``'s defaults run the device LZ stage with the host
    entropy writers: the frame of the device stages. A block without a
    token cover takes the host match finder (tests/test_torch_zstd_host.py),
    as the reference's does."""
    from compu_tpu.formats.zstd import encode as ref_enc

    vec = ByteVec()
    Interface.zstd(device="cpu").encode_vec_full(TEXT, vec, EncodeOp.Finish)
    assert vec.data() == _port_frame(TEXT)
    assert port_enc.compress_block(TEXT[:1000]) == ref_enc.compress_block(TEXT[:1000], 3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _scan_case(n: int, rle: bool):
    """Seeded sequences: n of them, skewed codes; with ``rle`` every match
    length code the same (the ML channel has no table)."""
    rng = np.random.default_rng(n)
    seqs = [(int(rng.geometric(0.3)) - 1, int(rng.integers(1, 100000)),
             20 if rle else int(rng.geometric(0.1)) + 2) for _ in range(n)]
    ll_codes, ml_codes, of_codes, _, tabs = _channels(seqs)
    P = 1 << max(4, (n - 1).bit_length())
    return zstd_seq.scan_inputs(ll_codes, ml_codes, of_codes, *(t.enc for t in tabs), P,
                                "cuda"), seqs


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 17, 7000, 14884])
@pytest.mark.parametrize("rle", [False, True])
def test_fse_seq_scan_kernel_matches_plain_gpu(cuda, n, rle):
    (codes, inits, st, dnb, df, logs, ens), seqs = _scan_case(n, rle)
    got = zstd_seq.fse_seq_scan_cuda(codes, inits, st, dnb, df, ens, logs, n)
    want = zstd_seq.fse_seq_scan_torch(codes, inits, st, dnb, df, ens, logs, n)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if n > 1:
        assert port_enc._sequences_section(seqs, device=cuda) == port_enc._sequences_section(seqs)


@pytest.mark.gpu
def test_frame_card_equals_cpu_gpu(cuda):
    from compu_tpu_torch import _build

    _build.reset_launch_counts()
    card = _encode(TEXT, cuda)
    assert all(_build.LAUNCHES[k] > 0
               for k in ("lcp_candidates", "parse_cover", "fse_seq_scan"))
    assert card == _port_frame(TEXT)
