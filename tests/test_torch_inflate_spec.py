"""The foreign-stream inflate's device pieces against the JAX reference, on
the CPU: the plain version of kernel P4 (``spec_scan_wave_torch``) lane by
lane against the reference's ``spec_scan_wave``, the 15-bit tables, the
stream-global ``resolve_foreign`` and the host ``parse_block_header_at``.
Marked ``gpu``: P4 against its plain version on the card.

The waves: the first wave of alice29's gzip fixture, of a fixed-Huffman
block and of a Huffman-only stream whose 1-bit codes overflow the lanes'
record slots; the last wave of alice29's fixture, where lanes retire on
``total_bits``; and seeded numpy random bytes under the fixed tables
(invalid literal/length codes 286/287 and distance codes 30/31). Every
output is integers, so every comparison is exact (tolerance 0). Record
slots that emit nothing hold 0 in the port and ``payload << 10`` in the
reference, which reads only slots with outlen > 0: those are compared, and
the port's other slots must be 0.
"""

import functools
import pathlib
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
WAVES = ("alice_first", "alice_last", "fixed", "random_fixed_tables", "overflow")


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
    """The stream's last wave, recorded from a decode on the CPU."""
    waves = []
    scan = device_inflate.spec_scan_wave

    def recording(comp, lit_lut, dist_lut, wave_bit0, total_bits):
        waves.append((lit_lut, dist_lut, wave_bit0))
        return scan(comp, lit_lut, dist_lut, wave_bit0, total_bits)

    device_inflate.spec_scan_wave = recording
    try:
        device_inflate.device_inflate_raw(data, start_bit, "cpu")
    finally:
        device_inflate.spec_scan_wave = scan
    return data, *waves[-1]


@functools.lru_cache(maxsize=None)
def wave(name: str):
    """(stream bytes, lit lengths or table, dist lengths or table, wave_bit0):
    lengths (numpy) where the tables are built from a header, tables
    (torch, CPU) for the recorded last wave."""
    gz = (DATA / "alice29.txt.gz").read_bytes()
    start = 8 * device_inflate._parse_gzip_header(gz)
    if name == "alice_first":
        return _first_wave(gz, start)
    if name == "alice_last":
        return _last_wave(gz, start)
    if name == "fixed":
        return _first_wave(_fixed_stream(), 0)
    if name == "random_fixed_tables":
        rng = np.random.default_rng(3)
        return (rng.integers(0, 256, 20000, dtype=np.uint8).tobytes(),
                consts.FIXED_LITLEN_LENGTHS.astype(np.int32), np.full(30, 5, np.int32), 0)
    if name == "overflow":
        return _first_wave(overflow_stream(), 16)
    raise KeyError(name)


def port_args(name: str, device="cpu"):
    data, lit, dist, wave_bit0 = wave(name)
    if isinstance(lit, np.ndarray):
        lit, dist = inflate_spec.build_foreign_luts(torch.from_numpy(lit), torch.from_numpy(dist))
    return (inflate_spec.pad_stream(data, device), lit.to(device), dist.to(device),
            wave_bit0, len(data) * 8)


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
    if isinstance(lit, np.ndarray):
        lit_lut, dist_lut = ref_spec.build_foreign_luts(jnp.asarray(lit), jnp.asarray(dist))
    else:
        lit_lut, dist_lut = jnp.asarray(lit.numpy()), jnp.asarray(dist.numpy())
    outs = ref_spec.spec_scan_wave(ref_spec.make_comp12(np.frombuffer(data, np.uint8)),
                                   lit_lut, dist_lut, jnp.int32(wave_bit0),
                                   jnp.int32(len(data) * 8))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("name", WAVES)
def test_plain_scan_equals_reference(ref, name):
    ref_spec, _ = ref
    *ref_lanes, ref_rec = _ref_wave(ref_spec, name)
    lanes, rec = inflate_spec.spec_scan_wave(*port_args(name))
    for row, want in zip(lanes.numpy(), ref_lanes):
        np.testing.assert_array_equal(row, want.astype(np.int64))
    got = rec.numpy().T.astype(np.int64)
    want = ref_rec.astype(np.int64)
    emits = (want & 0x1FF) > 0
    np.testing.assert_array_equal((got & 0x1FF) > 0, emits)
    np.testing.assert_array_equal(got[emits], want[emits])
    assert not got[~emits].any()
    flags = lanes[2].numpy()
    if name == "overflow":    # the block's first lane fills its 192 slots, then is bad
        assert flags[0] == 2 and lanes[3, 0] == 192
    if name == "random_fixed_tables":
        assert (flags & 2).any() and ((flags & 2) == 0).any()
    if name == "alice_last":  # lanes past the stream start retired
        assert (lanes[3].numpy() == 0).any() and (flags & 1).any()


def test_tables_equal_reference(ref):
    import jax.numpy as jnp

    ref_spec, _ = ref
    for name in ("alice_first", "fixed", "overflow"):
        _, lit, dist, _ = wave(name)
        want = ref_spec.build_foreign_luts(jnp.asarray(lit), jnp.asarray(dist))
        got = inflate_spec.build_foreign_luts(torch.from_numpy(lit), torch.from_numpy(dist))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


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
    comp, lit, dist, _, total = port_args("fixed")
    with pytest.raises(ValueError, match="int32"):
        inflate_spec.spec_scan_wave(comp, lit.to(torch.int64), dist, 0, total)
    with pytest.raises(ValueError, match="multiple of 4"):
        inflate_spec.spec_scan_wave(comp[:-1], lit, dist, 0, total)
    with pytest.raises(ValueError, match="must lie"):
        inflate_spec.spec_scan_wave(comp, lit, dist, 0, 8 * comp.numel() + 1)
    with pytest.raises(ValueError, match="CUDA"):
        inflate_spec.spec_scan_wave_cuda(comp, lit, dist, 0, total)


@pytest.mark.gpu
@pytest.mark.parametrize("name", WAVES)
def test_p4_equals_plain_gpu(cuda, name):
    args = port_args(name, cuda)
    before = _build.LAUNCHES["inflate_spec"]
    got = inflate_spec.spec_scan_wave(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["inflate_spec"] == before + 1
    want = inflate_spec.spec_scan_wave_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_p4_at_every_wave_offset_gpu(cuda):
    """Waves that start at every bit offset of a word, on random bytes
    under the fixed tables: the window's funnel shifts at each shift."""
    comp, lit, dist, _, total = port_args("random_fixed_tables", cuda)
    for wave_bit0 in range(0, 40):
        got = inflate_spec.spec_scan_wave_cuda(comp, lit, dist, wave_bit0, total)
        want = inflate_spec.spec_scan_wave_torch(comp, lit, dist, wave_bit0, total)
        for g, w in zip(got, want):
            assert torch.equal(g, w), wave_bit0
