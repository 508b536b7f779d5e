"""The foreign-stream inflate's device pieces against the JAX reference, on
the CPU: the plain version of kernel P4 (``spec_scan_wave_torch``) lane by
lane against the reference's ``spec_scan_wave``, the block's code tables
(their lookup against the reference's 15-bit tables on every window), the
stream-global ``resolve_foreign`` and the host ``parse_block_header_at``.
Marked ``gpu``: P4 against its plain version on the card.

The waves: the first wave of alice29's gzip fixture, of a fixed-Huffman
block and of a Huffman-only stream whose 1-bit codes overflow the lanes'
record slots; the last wave of alice29's fixture, where lanes retire on
``total_bits``; and seeded numpy random bytes under the fixed tables
(invalid literal/length codes 286/287 and distance codes 30/31), under
complete codes with 13-, 14- and 15-bit codes (the tables' walk), and
under incomplete, oversubscribed and one-symbol codes (the walk where no
length fits, and the primary's invalid entry stands). Every
output is integers, so every comparison is exact (tolerance 0). The port
writes a lane's k-th record to slot k, and only slots below its ``nrec``
are defined (the plain version writes 0 past them); the reference puts the
token of step t at slot t*KF + j and ``payload << 10`` in slots that emit
nothing, and reads only slots with outlen > 0: those, in slot order, must
equal the port's first ``nrec`` slots.
"""

import functools
import pathlib
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import _build  # noqa: E402
from compu_tpu_torch.formats.base import CodecFailure  # noqa: E402
from compu_tpu_torch.formats.deflate import consts  # noqa: E402
from compu_tpu_torch.formats.deflate import device_inflate  # noqa: E402
from compu_tpu_torch.kernels import inflate_spec  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
# Seeded random bytes under the code lengths of ``table_case``'s incomplete,
# oversubscribed and one-symbol codes: lanes where no length fits a window.
RANDOM_TABLE_WAVES = ("random_incomplete", "random_oversubscribed", "random_one_symbol")
WAVES = ("alice_first", "alice_last", "fixed", "random_fixed_tables", "overflow",
         "random_long_codes") + RANDOM_TABLE_WAVES


def long_code_lengths() -> tuple[np.ndarray, np.ndarray]:
    """Complete lit/len and distance codes with 13-, 14- and 15-bit codes
    (two, three and two of each), the other symbols shuffled from a seed:
    lit/len 20 of 7 bits, 213 of 8 and 46 of 12 (286 and 287 unused);
    distance 3 of 2 bits, one each of 3..8 and 14 of 12."""
    rng = np.random.default_rng(11)
    lit = np.zeros(288, np.int32)
    lit[[65, 284]], lit[[200, 270, 285]], lit[[10, 280]] = 13, 14, 15
    rest = rng.permutation(np.setdiff1d(np.arange(286), [65, 284, 200, 270, 285, 10, 280]))
    lit[rest] = np.repeat([7, 8, 12], [20, 213, 46])
    dist = np.zeros(30, np.int32)
    order = rng.permutation(30)
    dist[order] = np.repeat([2, 3, 4, 5, 6, 7, 8, 12, 13, 14, 15],
                            [3, 1, 1, 1, 1, 1, 1, 14, 2, 3, 2])
    return lit, dist


def _fixed_stream() -> bytes:
    """A raw deflate stream of one fixed-Huffman block, with 9-bit
    literals (bytes >= 144) among text."""
    rng = np.random.default_rng(7)
    raw = (TEXT[:3000] + rng.integers(144, 256, 2000, dtype=np.uint8).tobytes()) * 3
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 8, zlib.Z_FIXED)
    return co.compress(raw) + co.flush()


def overflow_stream() -> bytes:
    """A valid zlib stream the device inflate refuses: Huffman-only codes of
    1 and 2 bits put more than 192 tokens in one 512-bit chunk."""
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_HUFFMAN_ONLY)
    return co.compress(b"a" * 20000 + b"b" + b"a" * 20000) + co.flush()


def _first_wave(data: bytes, start_bit: int):
    kind, lit, dist, body_bit, _ = device_inflate.parse_block_header_at(data, start_bit)
    assert kind in (1, 2)
    return data, lit, dist, body_bit


def _last_wave(data: bytes, start_bit: int):
    """The stream's last wave and its block's code lengths, recorded from a
    decode on the CPU."""
    blocks, waves = [], []
    build, scan = device_inflate.build_foreign_tables, device_inflate.spec_scan_wave

    def building(lit, dist, device):
        blocks.append((lit, dist))
        return build(lit, dist, device)

    def recording(comp, tables, wave_bit0, total_bits):
        waves.append((*blocks[-1], wave_bit0))
        return scan(comp, tables, wave_bit0, total_bits)

    device_inflate.build_foreign_tables = building
    device_inflate.spec_scan_wave = recording
    try:
        device_inflate.device_inflate_raw(data, start_bit, "cpu")
    finally:
        device_inflate.build_foreign_tables = build
        device_inflate.spec_scan_wave = scan
    return data, *waves[-1]


@functools.lru_cache(maxsize=None)
def wave(name: str):
    """(stream bytes, lit/len code lengths, distance code lengths, wave_bit0),
    the lengths numpy."""
    gz = (DATA / "alice29.txt.gz").read_bytes()
    start = 8 * device_inflate._parse_gzip_header(gz)
    if name == "alice_first":
        return _first_wave(gz, start)
    if name == "alice_last":
        return _last_wave(gz, start)
    if name == "fixed":
        return _first_wave(_fixed_stream(), 0)
    if name.startswith("random"):
        rng = np.random.default_rng(3)
        if name in RANDOM_TABLE_WAVES:
            lit, dist = table_case(name[len("random_"):])
        elif name == "random_fixed_tables":
            lit, dist = consts.FIXED_LITLEN_LENGTHS.astype(np.int32), np.full(30, 5, np.int32)
        else:
            lit, dist = long_code_lengths()
        return rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(), lit, dist, 0
    if name == "overflow":
        return _first_wave(overflow_stream(), 16)
    raise KeyError(name)


def port_args(name: str, device="cpu"):
    data, lit, dist, wave_bit0 = wave(name)
    return (inflate_spec.pad_stream(data, device),
            inflate_spec.build_foreign_tables(lit, dist, device), wave_bit0, len(data) * 8)


@pytest.fixture
def ref():
    """The JAX reference's foreign inflate modules, on the CPU."""
    pytest.importorskip("jax")
    from compu_tpu.formats.deflate import device_inflate as ref_driver
    from compu_tpu.kernels import inflate_spec as ref_spec

    return ref_spec, ref_driver


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ref_wave(ref_spec, name: str):
    import jax.numpy as jnp

    data, lit, dist, wave_bit0 = wave(name)
    lit_lut, dist_lut = ref_spec.build_foreign_luts(jnp.asarray(lit), jnp.asarray(dist))
    outs = ref_spec.spec_scan_wave(ref_spec.make_comp12(np.frombuffer(data, np.uint8)),
                                   lit_lut, dist_lut, jnp.int32(wave_bit0),
                                   jnp.int32(len(data) * 8))
    return [np.asarray(o) for o in outs]


def defined_records(rec: np.ndarray, nrec: np.ndarray) -> list[np.ndarray]:
    """Each lane's first nrec slots of (RF, L) records."""
    return [rec[:n, lane] for lane, n in enumerate(nrec)]


def assert_same_scan(got, want) -> None:
    """Two scans of the port's contract: lanes equal, records below nrec equal."""
    (g_lanes, g_rec), (w_lanes, w_rec) = [[t.cpu() for t in x] for x in (got, want)]
    assert torch.equal(g_lanes, w_lanes)
    defined = torch.arange(inflate_spec.RF)[:, None] < w_lanes[3][None, :]
    assert torch.equal(g_rec[defined], w_rec[defined])


@pytest.mark.parametrize("name", WAVES)
def test_plain_scan_equals_reference(ref, name):
    ref_spec, _ = ref
    *ref_lanes, ref_rec = _ref_wave(ref_spec, name)
    lanes, rec = inflate_spec.spec_scan_wave(*port_args(name))
    for row, want in zip(lanes.numpy(), ref_lanes):
        np.testing.assert_array_equal(row, want.astype(np.int64))
    got = rec.numpy().astype(np.int64)
    nrec = lanes[3].numpy()
    want = ref_rec.astype(np.int64)                         # (L, RF), step slots
    emits = (want & 0x1FF) > 0
    np.testing.assert_array_equal(emits.sum(1), nrec)
    for g, w, e in zip(defined_records(got, nrec), want, emits):
        np.testing.assert_array_equal(g, w[e])
    assert not got[np.arange(inflate_spec.RF)[:, None] >= nrec[None, :]].any()
    flags = lanes[2].numpy()
    if name == "overflow":    # the block's first lane fills its 192 slots, then is bad
        assert flags[0] == 2 and lanes[3, 0] == 192
    if name == "random_fixed_tables":
        assert (flags & 2).any() and ((flags & 2) == 0).any()
    if name == "alice_last":  # lanes past the stream start retired
        assert (lanes[3].numpy() == 0).any() and (flags & 1).any()
    if name == "random_long_codes":  # complete codes: no lane is bad
        _, lit, dist, _ = wave(name)
        assert (lit >= 13).sum() == 7 and (dist >= 13).sum() == 7
        assert not (flags & 2).any() and int(lanes[3].sum()) > 100000


def _corpus_headers() -> list:
    """The first block header of stdlib zlib's level-6 raw stream of each
    quarter of the first MiB of the bench corpus (text, records, low-entropy
    bytes, noise): (lit/len, distance) code lengths."""
    from compu_tpu_torch.utils.corpus import build_corpus

    corpus = build_corpus(1 << 20)
    heads = []
    for i in range(4):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        raw = co.compress(corpus[i << 18:(i + 1) << 18]) + co.flush()
        kind, lit, dist, _, _ = device_inflate.parse_block_header_at(raw, 0)
        assert kind == 2
        heads.append((lit, dist))
    return heads


def table_case(case: str) -> tuple[np.ndarray, np.ndarray]:
    """Code lengths of each kind ``parse_block_header_at`` can return."""
    rng = np.random.default_rng(5)
    if case == "fixed_phantoms":
        return consts.FIXED_LITLEN_LENGTHS.astype(np.int32), np.full(30, 5, np.int32)
    if case == "long_codes":
        return long_code_lengths()
    if case == "incomplete":       # every length, fewer codes than the space holds
        lit = np.where(rng.random(288) < 0.3, rng.integers(9, 16, 288), 0)
        return lit.astype(np.int32), np.where(rng.random(30) < 0.5, 15, 0).astype(np.int32)
    if case == "oversubscribed":   # more codes than the space holds, at every length
        return (rng.integers(1, 16, 288).astype(np.int32),
                rng.integers(1, 16, 30).astype(np.int32))
    if case == "one_symbol":       # one code each, of 1 and of 15 bits
        lit, dist = np.zeros(288, np.int32), np.zeros(30, np.int32)
        lit[256], dist[29] = 15, 1
        return lit, dist
    if case == "no_distance_codes":
        lit, _ = long_code_lengths()
        return lit, np.zeros(30, np.int32)
    if case == "alice":
        return wave("alice_first")[1:3]
    if case.startswith("corpus_"):
        return _corpus_headers()[int(case[-1])]
    raise KeyError(case)


TABLE_CASES = ("fixed_phantoms", "long_codes", "incomplete", "oversubscribed", "one_symbol",
               "no_distance_codes", "alice", "corpus_0", "corpus_1", "corpus_2", "corpus_3")


@pytest.mark.parametrize("case", TABLE_CASES)
def test_tables_equal_reference(ref, case):
    """The tables' lookup (12-bit primary, then the walk over 13..15) equals
    the reference's 15-bit direct tables on all 2^15 windows, both codes."""
    import jax.numpy as jnp

    ref_spec, _ = ref
    lit, dist = table_case(case)
    want = ref_spec.build_foreign_luts(jnp.asarray(lit), jnp.asarray(dist))
    tables = inflate_spec.build_foreign_tables(lit, dist)
    assert tables.dtype == torch.int32 and tuple(tables.shape) == (inflate_spec.TABLE_WORDS,)
    windows = torch.arange(1 << inflate_spec.MAXB)
    for is_dist, w in zip((False, True), want):
        got = inflate_spec.lookup_foreign(tables, windows, dist=is_dist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w).astype(np.int64))


def test_tables_primaries_are_the_12_bit_tables():
    """The primaries are the indexed inflate's 12-bit tables, built in
    numpy here and in PyTorch there."""
    from compu_tpu_torch.kernels import inflate_lut

    for case in ("long_codes", "oversubscribed", "fixed_phantoms"):
        lit, dist = table_case(case)
        tables = inflate_spec.build_foreign_tables(lit, dist)
        n = 1 << inflate_spec.PRIM_BITS
        assert torch.equal(tables[inflate_spec.LIT_PRIM:inflate_spec.LIT_PRIM + n],
                           inflate_lut._lit_lut_block(torch.from_numpy(lit)[None], 12)[0])
        assert torch.equal(tables[inflate_spec.DIST_PRIM:inflate_spec.DIST_PRIM + n],
                           inflate_lut._dist_lut_block(torch.from_numpy(dist)[None], 12)[0])


def test_kernel_table_layout_matches():
    """``csrc/inflate_spec.cu`` reads the tables at the module's offsets."""
    src = (pathlib.Path(inflate_spec.__file__).parent.parent / "csrc" /
           "inflate_spec.cu").read_text()
    consts_cu = dict(re.findall(r"constexpr \w+ (k\w+) = (\d+);", src))
    assert int(consts_cu["kPrimBits"]) == inflate_spec.PRIM_BITS
    assert int(consts_cu["kTableWords"]) == inflate_spec.TABLE_WORDS
    assert int(consts_cu["kRF"]) == inflate_spec.RF and int(consts_cu["kKF"]) == inflate_spec.KF
    assert inflate_spec.CANON == 2 << inflate_spec.PRIM_BITS
    assert inflate_spec.LIT_SYMS == inflate_spec.CANON + 2 * inflate_spec.MAXB * 3
    assert inflate_spec.LANES % int(consts_cu["kBlockLanes"]) == 0


def _mixed_stream() -> tuple[bytes, bytes]:
    """A raw deflate stream of a stored block, then dynamic blocks with
    full flushes (back-references across deflate blocks); and its bytes."""
    head = TEXT[:3000]
    tail = TEXT[3000:40000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = b"".join([co.compress(tail[:15000]), co.flush(zlib.Z_FULL_FLUSH),
                     co.compress(tail[15000:]), co.flush(zlib.Z_FINISH)])
    stored = bytes([0]) + struct.pack("<HH", len(head), len(head) ^ 0xFFFF) + head
    return stored + body, head + tail


def _tokens(data: bytes, start_bit: int):
    """The token lists and stored ranges the port's driver hands
    ``resolve_foreign`` for a stream, recorded from a CPU decode."""
    kept = []
    resolve = device_inflate.resolve_foreign

    def recording(*args, total_out):
        kept.append(([a.numpy() for a in args], total_out))
        return resolve(*args, total_out=total_out)

    device_inflate.resolve_foreign = recording
    try:
        out, _ = device_inflate.device_inflate_raw(data, start_bit, "cpu")
    finally:
        device_inflate.resolve_foreign = resolve
    return kept[0], out


@pytest.mark.parametrize("case", ["gzip_fixture", "stored_and_flushes"])
def test_resolve_equals_reference(ref, case):
    import jax.numpy as jnp

    ref_spec, ref_driver = ref
    if case == "gzip_fixture":
        data = (DATA / "alice29.txt.gz").read_bytes()
        start, raw = 8 * device_inflate._parse_gzip_header(data), TEXT
    else:
        (data, raw), start = _mixed_stream(), 0
    (arrays, total_out), out = _tokens(data, start)
    assert out == raw and total_out == len(raw)
    ol, il, pay, st, stored_out, stored_mask = arrays
    if case == "stored_and_flushes":
        assert stored_mask[:3000].all() and not stored_mask[3000:].any()
    got, ok = inflate_spec.resolve_foreign(
        *(torch.from_numpy(a) for a in arrays), total_out=total_out)
    # The reference's shapes: tokens and positions padded to powers of two.
    NT = ref_driver._pow2ceil(total_out)
    T = ref_driver._pow2ceil(max(len(ol), 1), lo=1 << 8)
    pad = lambda a: np.concatenate([a, np.zeros(T - len(a), a.dtype)])  # noqa: E731
    r_out = np.zeros(NT, np.uint8)
    r_out[:total_out] = stored_out
    r_mask = np.ones(NT, bool)
    r_mask[:total_out] = stored_mask
    want, want_ok = ref_spec.resolve_foreign(
        jnp.asarray(pad(ol)), jnp.asarray(pad(il)), jnp.asarray(pad(pay)),
        jnp.asarray(pad(st).astype(np.int32)), jnp.asarray(r_out), jnp.asarray(r_mask),
        total_out=NT)
    assert int(ok[0]) == int(np.asarray(want_ok)[0]) == 1
    assert got.numpy().tobytes() == np.asarray(want)[:total_out].tobytes() == raw


def test_resolve_unresolved_is_not_ok():
    """A source that reaches before the stream (the driver refuses such a
    distance first) leaves positions unresolved: ok 0."""
    out, ok = inflate_spec.resolve_foreign(
        torch.tensor([1, 4]), torch.tensor([1, 0]), torch.tensor([65, 0]), torch.tensor([0, 1]),
        torch.zeros(5, dtype=torch.uint8), torch.zeros(5, dtype=torch.bool), total_out=5)
    assert int(ok[0]) == 1 and out.tolist() == [65] * 5
    out, ok = inflate_spec.resolve_foreign(
        torch.tensor([4]), torch.tensor([0]), torch.tensor([0]), torch.tensor([1]),
        torch.zeros(5, dtype=torch.uint8), torch.zeros(5, dtype=torch.bool), total_out=5)
    assert int(ok[0]) == 0


def _headers():
    """(name, data, bit) of block headers of each kind."""
    gz = (DATA / "alice29.txt.gz").read_bytes()
    mixed, _ = _mixed_stream()
    return [("dynamic", gz, 8 * device_inflate._parse_gzip_header(gz)),
            ("fixed", _fixed_stream(), 0),
            ("stored", mixed, 0),
            ("dynamic_after_stored", mixed, 8 * (5 + 3000)),
            ("bad_type", bytes([0b111, 0, 0, 0]), 0),
            ("bad_type_at_bit", bytes([0b1110, 0, 0]), 1)]


@pytest.mark.parametrize("case", [h[0] for h in _headers()])
def test_parse_block_header_equals_reference(ref, case):
    _, ref_driver = ref
    _, data, bit = next(h for h in _headers() if h[0] == case)
    if case.startswith("bad_type"):
        with pytest.raises(CodecFailure) as got:
            device_inflate.parse_block_header_at(data, bit)
        with pytest.raises(Exception) as want:
            ref_driver.parse_block_header_at(data, bit)
        assert (got.value.code, got.value.message) == (want.value.code, want.value.message)
        return
    got = device_inflate.parse_block_header_at(data, bit)
    want = ref_driver.parse_block_header_at(data, bit)
    assert got[0] == want[0] == {"dynamic": 2, "fixed": 1, "stored": 0}.get(case, 2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3:] == want[3:]


def test_truncated_header_raises_need_more_bits():
    from compu_tpu_torch.ops.bitio import NeedMoreBits

    gz = (DATA / "alice29.txt.gz").read_bytes()
    start = device_inflate._parse_gzip_header(gz)
    with pytest.raises(NeedMoreBits):
        device_inflate.parse_block_header_at(gz[:start + 20], 8 * start)


def test_wave_argument_checks():
    comp, tables, _, total = port_args("fixed")
    with pytest.raises(ValueError, match="int32"):
        inflate_spec.spec_scan_wave(comp, tables.to(torch.int64), 0, total)
    with pytest.raises(ValueError, match="int32"):
        inflate_spec.spec_scan_wave(comp, tables[:-4], 0, total)
    with pytest.raises(ValueError, match="multiple of 4"):
        inflate_spec.spec_scan_wave(comp[:-1], tables, 0, total)
    with pytest.raises(ValueError, match="must lie"):
        inflate_spec.spec_scan_wave(comp, tables, 0, 8 * comp.numel() + 1)
    with pytest.raises(ValueError, match="CUDA"):
        inflate_spec.spec_scan_wave_cuda(comp, tables, 0, total)


@pytest.mark.gpu
@pytest.mark.parametrize("name", WAVES)
def test_p4_equals_plain_gpu(cuda, name):
    args = port_args(name, cuda)
    before = _build.LAUNCHES["inflate_spec"]
    got = inflate_spec.spec_scan_wave(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["inflate_spec"] == before + 1
    assert_same_scan(got, inflate_spec.spec_scan_wave_torch(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("random_fixed_tables", "random_long_codes")
                         + RANDOM_TABLE_WAVES)
def test_p4_at_every_wave_offset_gpu(cuda, name):
    """Waves that start at every bit offset of a word, on random bytes
    under the fixed tables, long codes, and incomplete, oversubscribed and
    one-symbol codes: the window's funnel shifts at each shift, each
    block's staged span, and the kernel's own walk where no length fits."""
    comp, tables, _, total = port_args(name, cuda)
    for wave_bit0 in range(0, 40):
        got = inflate_spec.spec_scan_wave_cuda(comp, tables, wave_bit0, total)
        assert_same_scan(got, inflate_spec.spec_scan_wave_torch(comp, tables, wave_bit0, total))
