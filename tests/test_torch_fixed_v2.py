"""The port's fixed-Huffman v2 block encode (``kernels/deflate_v2.py::
encode_block(s)_fixed_v2``, ``make_block_encode_fn(kernel="v2")``) against
the JAX reference's ``encode_block_fixed_v2`` on the CPU.

Every comparison is exact (tolerance 0: integer and byte functions): the
closed-form fixed fields on every length, distance and literal, the
block's bytes ``out[:len]`` (and the whole buffer), the metas ``[len,
check]`` and ``seg_bits``, and the ``BlockParallelEncoder`` streams with
their segment index. Inputs are numpy arrays from fixed seeds handed to
both packages; the reference runs under ``JAX_PLATFORMS=cpu``.
"""

import pathlib
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch import (  # noqa: E402
    BlockParallelDecoder,
    BlockParallelEncoder,
    ZlibMode,
    make_block_encode_fn,
)
from compu_tpu_torch.kernels.deflate_v2 import (  # noqa: E402
    _fixed_fields,
    encode_block_fixed_v2,
    encode_blocks_fixed_v2,
)
from compu_tpu_torch.kernels.deflate_v3 import encode_blocks_dyn  # noqa: E402

DATA = ROOT / "tests" / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
BS = 1 << 14  # tests/test_parallel.py's block
TERM = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])


def _payloads():
    """tests/test_parallel.py:34's payloads, noise, and an empty block."""
    rng = np.random.default_rng(11)
    return [ALICE[:100], ALICE[:BS], b"ab" * 4000, b"\x00" * BS,
            rng.integers(0, 256, BS, dtype=np.uint8).tobytes(), b""]


def _matrix(payloads, n=BS):
    blocks = np.zeros((len(payloads), n), np.uint8)
    lens = np.zeros(len(payloads), np.int32)
    for i, raw in enumerate(payloads):
        blocks[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lens[i] = len(raw)
    return blocks, lens


@pytest.fixture
def jax_cpu():
    return pytest.importorskip("jax")


@pytest.mark.parametrize("kind", ["match", "literal", "none"])
def test_fixed_fields_match_reference(jax_cpu, kind):
    """Every length 3-258 (cycled) beside every distance 1-32768, and every
    literal byte, as matches, literals or neither."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import _fixed_fields as ref_fields

    n = 32768
    mlen = 3 + np.arange(n) % 256
    dclip = 1 + np.arange(n)
    data = (np.arange(n) % 256).astype(np.uint8)
    is_match = np.full(n, kind == "match")
    is_lit = np.full(n, kind == "literal")
    ref = ref_fields(jnp.asarray(data), jnp.asarray(mlen, jnp.int32),
                     jnp.asarray(dclip, jnp.int32), jnp.asarray(is_match), jnp.asarray(is_lit))
    port = _fixed_fields(torch.from_numpy(data), torch.from_numpy(mlen), torch.from_numpy(dclip),
                         torch.from_numpy(is_match), torch.from_numpy(is_lit))
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r).astype(np.int64), p.numpy())


@pytest.mark.parametrize("check", ["adler", "crc"])
@pytest.mark.parametrize("with_index", [False, True])
def test_encode_blocks_fixed_v2_matches_reference(jax_cpu, check, with_index):
    """One port batch of the six payloads against the reference's
    single-block encode of each; stdlib zlib decodes every block."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import encode_block_fixed_v2 as ref_encode

    payloads = _payloads()
    blocks, lens = _matrix(payloads)
    port = [x.numpy() for x in encode_blocks_fixed_v2(
        torch.from_numpy(blocks), torch.from_numpy(lens), depth=8, with_index=with_index,
        check=check)]
    assert port[0].shape == (len(payloads), BS + BS // 4 + 64) and port[0].dtype == np.uint8
    assert port[1].dtype == np.int32
    for i, raw in enumerate(payloads):
        ref = [np.asarray(x) for x in ref_encode(jnp.asarray(blocks[i]), jnp.int32(lens[i]),
                                                 depth=8, with_index=with_index, check=check)]
        assert np.array_equal(port[1][i], ref[1]), i
        assert np.array_equal(port[0][i], ref[0]), i  # the whole buffer, not only out[:len]
        if with_index:
            assert port[2].dtype == np.int32 and np.array_equal(port[2][i], ref[2]), i
        blob = port[0][i, : port[1][i, 0]].tobytes() + TERM
        assert zlib.decompress(blob, wbits=-15) == raw
        if check == "adler":
            assert port[1][i, 1].view(np.uint32) == zlib.adler32(raw)


def test_encode_block_fixed_v2_single_block():
    blocks, lens = _matrix([ALICE[:5000]], 1 << 13)
    out, meta, seg_bits = encode_block_fixed_v2(torch.from_numpy(blocks[0]), int(lens[0]),
                                                with_index=True)
    outs, metas, segs = encode_blocks_fixed_v2(torch.from_numpy(blocks),
                                               torch.from_numpy(lens), with_index=True)
    assert torch.equal(out, outs[0]) and torch.equal(meta, metas[0])
    assert torch.equal(seg_bits, segs[0])


@pytest.mark.parametrize("mode,wbits", [(ZlibMode.Gzip, 31), (ZlibMode.Zlib, 15)])
def test_v2_block_stream_matches_reference(jax_cpu, mode, wbits):
    """``make_block_encode_fn(kernel="v2", segment_index=True)`` through
    both packages' ``BlockParallelEncoder`` (each with its own ZlibMode);
    stdlib zlib decodes the stream and the port's decoder reads it back
    with its index."""
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn as ref_make
    from compu_tpu.parallel.scheduler import BlockParallelEncoder as RefEncoder

    data = (ALICE * 2)[: 3 * BS + 777]
    ref_mode = RefMode.Gzip if mode is ZlibMode.Gzip else RefMode.Zlib
    ref_enc = RefEncoder(ref_make(ref_mode, level=6, kernel="v2", segment_index=True),
                         block_size=BS, mode=ref_mode, host_fallback=False)
    fn = make_block_encode_fn(mode, level=6, kernel="v2", segment_index=True, device="cpu")
    enc = BlockParallelEncoder(fn, block_size=BS, mode=mode)
    ref_stream, ref_index = ref_enc.encode(data)
    stream, index = enc.encode(data)
    assert [s.state for s in enc.block_statuses] == ["ok"] * 4
    assert stream == ref_stream
    assert all(np.array_equal(a, b) for a, b in zip(index.segment_bits, ref_index.segment_bits))
    assert zlib.decompress(stream, wbits=wbits) == data
    assert BlockParallelDecoder(block_size=BS, device="cpu").decode(stream, index) == data


def test_v3_beats_v2_ratio_on_text():
    """Port of tests/test_v3_kernel.py::test_v3_beats_v2_ratio_on_text: the
    dynamic trees win at least 10% on text."""
    n = 1 << 15
    blocks, lens = _matrix([ALICE[:n]], n)
    _, meta2 = encode_blocks_fixed_v2(torch.from_numpy(blocks), torch.from_numpy(lens), depth=8)
    _, meta3 = encode_blocks_dyn(torch.from_numpy(blocks), torch.from_numpy(lens), depth=8)
    assert int(meta3[0, 0]) < int(meta2[0, 0]) * 0.9
