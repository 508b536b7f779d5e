"""The plain reference on streams of the port's plain (CPU) kernels, on
streams it never made, and on broken ones."""

import copy
import json
import zlib

import numpy as np
import pytest

from portbench import generate, harness, reference

BS = 1 << 15


def matcher(level: int) -> dict:
    return json.loads((harness.PKG / "configs" / f"gzip-l{level}.json").read_text())["matcher"]


def port_encode(data: bytes, level: int = 6, framing: str = "gzip", segment_index=True):
    from compu_tpu_torch import BlockParallelEncoder, ZlibMode, make_block_encode_fn

    mode = ZlibMode.Gzip if framing == "gzip" else ZlibMode.Zlib
    fn = make_block_encode_fn(mode, level, segment_index=segment_index, device="cpu")
    return BlockParallelEncoder(fn, block_size=BS, mode=mode).encode(data)


def traffic_input(name: str, size: int = 1 << 17, seed: int = 2**31 + 5) -> bytes:
    traffic = json.loads((harness.PKG / "traffic" / f"{name}.json").read_text())
    return generate.make_input(dict(traffic, request_bytes=size), seed, 0)


def clean(counts):
    return all(v == 0 for v in counts.values())


@pytest.fixture(scope="module")
def mixed():
    data = traffic_input("mixed-16m")
    return data, port_encode(data)


@pytest.mark.parametrize("traffic,level,framing", [
    ("mixed-16m", 6, "gzip"), ("mixed-16m", 9, "gzip"), ("logs-16m", 6, "gzip"),
    ("random-16m", 6, "gzip"), ("mixed-16m", 6, "zlib")])
def test_port_streams_judged_correct(traffic, level, framing):
    data = traffic_input(traffic, size=(1 << 17) + 1000)  # a short last block too
    stream, index = port_encode(data, level, framing)
    assert clean(reference.judge(data, stream, index, mode=framing, block_size=BS,
                                 matcher=matcher(level), sample=range(5)))


def test_stdlib_blocks_judged_without_the_program():
    """Blocks compressed by the standard library, each with a sync flush,
    framed by hand: the blocks and framing pass, and the missing segment
    index is counted, a block's worth of segments a block."""
    data = traffic_input("mixed-16m")
    stream, offs, lens = bytearray(b"\x1f\x8b\x08\0\0\0\0\0\0\xff"), [], []
    for i in range(0, len(data), BS):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        blob = c.compress(data[i:i + BS]) + c.flush(zlib.Z_SYNC_FLUSH)
        offs.append(len(stream))
        lens.append(len(blob))
        stream += blob
    stream += b"\x01\0\0\xff\xff" + zlib.crc32(data).to_bytes(4, "little") + \
        len(data).to_bytes(4, "little")

    class Index:
        raw_lengths = [BS] * (len(data) // BS)
        compressed_offsets, compressed_lengths, segment_bits = offs, lens, None

    got = reference.judge(data, bytes(stream), Index, mode="gzip", block_size=BS)
    assert got == dict(framing=0, blocks=0, segments=(len(data) // BS) * (BS // 128),
                       wrong_bytes=0, witness=0, short_matches=0)


def test_a_flipped_bit(mixed):
    data, (stream, index) = mixed
    s = bytearray(stream)
    s[index.compressed_offsets[1] + index.compressed_lengths[1] // 2] ^= 4
    got = reference.judge(data, bytes(s), index, mode="gzip", block_size=BS)
    assert got["blocks"] == 1 and got["witness"] == 1


def test_a_segment_start_off_by_one(mixed):
    data, (stream, index) = mixed
    idx = copy.deepcopy(index)
    idx.segment_bits[0] = np.array(idx.segment_bits[0])
    idx.segment_bits[0][40] += 1
    got = reference.judge(data, stream, idx, mode="gzip", block_size=BS)
    assert got["segments"] >= 1 and got["blocks"] == 1 and got["witness"] == 0


def test_an_offset_and_a_trailer(mixed):
    data, (stream, index) = mixed
    idx = copy.deepcopy(index)
    idx.compressed_offsets[2] += 1
    assert reference.judge(data, stream, idx, mode="gzip", block_size=BS)["framing"] >= 1
    bad = stream[:-8] + (zlib.crc32(data) ^ 1).to_bytes(4, "little") + stream[-4:]
    got = reference.judge(data, bad, index, mode="gzip", block_size=BS)
    assert got["framing"] == 1 and got["witness"] == 1


def test_another_input(mixed):
    data, (stream, index) = mixed
    other = traffic_input("mixed-16m", seed=17)
    got = reference.judge(other, stream, index, mode="gzip", block_size=BS)
    assert got["wrong_bytes"] > 0 and got["framing"] >= 1


def test_lookup_table_matches_the_fixed_code():
    tab = reference.lookup_table(reference.FIXED_LIT)
    # Literal 0 is 00110000 (8 bits), sent from its first bit: reversed.
    assert tab[0b00001100] == 0 | (8 << 16)
    # End of block is 0000000 (7 bits).
    assert tab[0] == 256 | (7 << 16)
    with pytest.raises(reference.Malformed):
        reference.lookup_table([1, 1, 1])


@pytest.mark.parametrize("depth,keys", [(16, 2), (48, 2), (8, 1)])
def test_lex_candidates_are_the_ports_search(depth, keys):
    """The reference's matcher finds, at every position, the length the
    port's plain twin of B1 finds (``sort_stage_lex``, ``lcp_candidates``)."""
    import torch

    from compu_tpu_torch.kernels import u32
    from compu_tpu_torch.kernels.lcp_match import lcp_candidates_torch, sort_stage_lex

    rows = np.frombuffer(traffic_input("mixed-16m"), np.uint8).reshape(-1, BS).copy()
    rows[-1, BS - 700:] = 0  # a short block's zero padding
    ref = reference.lex_candidates(rows, wcap=16, depth=depth, keys=keys)
    *wbe, ps = sort_stage_lex(torch.from_numpy(rows), wcap=16, keys=keys, stride=1)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    bl, _ = lcp_candidates_torch(words, ps.reshape(-1).to(torch.int32), depth=depth,
                                 max_dist=reference.WINDOW, block_elems=BS)
    port = np.zeros_like(ref)
    np.put_along_axis(port, ps.numpy(), bl.reshape(rows.shape).numpy().astype(np.int16), -1)
    assert np.array_equal(ref, port)


def test_a_shallower_search_leaves_short_matches():
    """Level 9's stream holds level 9's matcher; level 6's stream, found
    at depth 16, does not."""
    data = traffic_input("mixed-16m")
    l9, l6 = port_encode(data, 9), port_encode(data, 6)
    assert reference.judge(data, *l9, mode="gzip", block_size=BS, matcher=matcher(9),
                           sample=range(4))["short_matches"] == 0
    got = reference.judge(data, *l6, mode="gzip", block_size=BS, matcher=matcher(9),
                          sample=range(4))
    assert got["short_matches"] > 0
    assert got == dict(got, framing=0, blocks=0, segments=0, wrong_bytes=0, witness=0)
