"""The indexed DEFLATE inflate of the port against the JAX reference, on the
CPU: the host header parse, the lookup tables at 12 and 15 bits, and
``(out, ok)`` of the three decode routes (LUT, dyn, fixed) on batches
of the block encode's streams, with inert rows, block lengths that are not
a multiple of 128 and corrupted blocks; the plain version of kernel P3 and
its records; the wrapper's refusals. Marked ``gpu``: kernel P3 against its
plain version on the card, at both routes, on each kind of block.

Inputs are streams of the port's block encode on the CPU, from text, data
made with numpy from a seed, and runs; the port's encode gives the
reference encoder's bytes (``tests/test_torch_inflate_decoder.py`` checks
that on these cases). Every output is integers, so every comparison is
exact (tolerance 0); only each block's first ``ns[b]`` output bytes are
defined, in the reference as in the port, so those are compared, and
``ok``.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import BlockParallelEncoder, ZlibMode, _build  # noqa: E402
from compu_tpu_torch import make_block_encode_fn  # noqa: E402
from compu_tpu_torch.kernels import inflate, inflate_dyn, inflate_lut, inflate_scan  # noqa: E402
from compu_tpu_torch.ops.huffman import length_limited_lengths  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
BS = 1 << 16
CAP = BS + BS // 4 + 64 + 16
B = 8


def case_data(name: str) -> bytes:
    """One block's bytes for each kind of block the decode meets."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "text":          # dynamic codes
        return TEXT[:BS]
    if name == "tail":          # dynamic, a length that is not a multiple of 128
        return TEXT[1000:1000 + 4096 + 777]
    if name == "runs":          # fixed code, 258-byte matches, merged matches (ov > 0)
        return b"a" * 5000
    if name == "highbyte":      # fixed code with 9-bit literals (bytes >= 144)
        return (TEXT[:60] + rng.integers(144, 256, 30, dtype=np.uint8).tobytes()) * 3
    if name == "fixed_text":    # fixed code, one segment
        return TEXT[:100]
    if name == "literals":      # dynamic, segments of 128 literals
        return rng.integers(0, 200, BS, dtype=np.uint8).tobytes()
    if name == "far":           # matches at distance 32,768
        half = rng.integers(0, 200, BS // 2, dtype=np.uint8).tobytes()
        return half + half
    if name == "stored":
        return rng.integers(0, 256, BS, dtype=np.uint8).tobytes()
    if name == "debruijn":      # dynamic, all literals, 5-6-bit codes: no 3-gram repeats
        return rng.permutation(256).astype(np.uint8)[de_bruijn(32, 3)].tobytes()
    raise KeyError(name)


def de_bruijn(k: int, n: int) -> list[int]:
    """The de Bruijn sequence B(k, n): every n-gram over k symbols once."""
    a, seq = [0] * (k * n), []

    def db(t: int, p: int) -> None:
        if t > n:
            if n % p == 0:
                seq.extend(a[1:p + 1])
            return
        a[t] = a[t - p]
        db(t + 1, p)
        for j in range(a[t - p] + 1, k):
            a[t] = j
            db(t + 1, t)

    db(1, 1)
    return seq


@functools.lru_cache(maxsize=None)
def encoded(name: str):
    """(blob, seg_bits, n, header kind) of the block-encode stream of one
    case (level 6, gzip, one block of BS, on the CPU)."""
    data = case_data(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fn = make_block_encode_fn(ZlibMode.Gzip, level=6, segment_index=True, device="cpu")
        stream, index = BlockParallelEncoder(fn, block_size=BS, mode=ZlibMode.Gzip).encode(data)
    finally:
        torch.set_num_threads(threads)
    off, clen = index.compressed_offsets[0], index.compressed_lengths[0]
    blob = stream[off:off + clen]
    kind = inflate_dyn.parse_block_tables(blob[:4096])[0]
    return blob, np.asarray(index.segment_bits[0], np.int32), len(data), kind


def batch(names, rows: int = B, flip: int | None = None):
    """``BlockParallelDecoder``'s batch of the named cases as numpy arrays:
    (comps, segs, ns, lit_lens, dist_lens). "stored" rows and rows past the
    names are inert (ns 0), as the decoder leaves them; ``flip`` XORs 0xFF
    into that byte of the first row."""
    comps = np.zeros((rows, CAP), np.uint8)
    segs = np.zeros((rows, BS // 128), np.int32)
    ns = np.zeros(rows, np.int32)
    lit = np.zeros((rows, 288), np.int32)
    dist = np.zeros((rows, 30), np.int32)
    lit[:, [0, 256]] = 1
    dist[:, [0, 1]] = 1
    for j, name in enumerate(names):
        blob, seg, n, kind = encoded(name)
        if kind == 0:
            segs[j] = seg  # -1: the stored flag
            continue
        _, lit[j], dist[j], _ = inflate_dyn.parse_block_tables(blob[:4096])
        comps[j, :len(blob)] = np.frombuffer(blob, np.uint8)
        segs[j], ns[j] = seg, n
    if flip is not None:
        comps[0, flip] ^= 0xFF
    return comps, segs, ns, lit, dist


MIXED = ("text", "tail", "runs", "highbyte", "literals", "far", "stored")
FIXED = ("runs", "highbyte", "fixed_text", "stored")


def to_torch(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def assert_same(port, ref, ns):
    """ok equal, and when it is 1 each block's defined bytes equal."""
    out_p, ok_p = port
    out_r, ok_r = (np.asarray(x) for x in ref)
    assert int(ok_p[0]) == int(ok_r[0])
    out_p = out_p.numpy()
    for b, n in enumerate(ns):
        assert out_p[b * BS:b * BS + n].tobytes() == out_r[b * BS:b * BS + n].tobytes(), b


@pytest.fixture
def ref():
    """The JAX reference's inflate modules, on the CPU."""
    pytest.importorskip("jax")
    from compu_tpu.kernels import inflate_jax, inflate_jax_dyn, inflate_jax_lut

    return inflate_jax, inflate_jax_dyn, inflate_jax_lut


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cases_cover_every_kind_of_block():
    kinds = {name: encoded(name)[3] for name in (*MIXED, "fixed_text")}
    assert kinds == {"text": 2, "tail": 2, "runs": 1, "highbyte": 1, "literals": 2, "far": 2,
                     "stored": 0, "fixed_text": 1}
    ov = (encoded("runs")[1] >> 24) & 0xFF
    assert ov.max() > 0  # merged matches cross segments


@pytest.mark.parametrize("name", ["text", "tail", "runs", "highbyte", "stored", "literals"])
def test_parse_block_tables_equals_reference(ref, name):
    blob = encoded(name)[0]
    got = inflate_dyn.parse_block_tables(blob[:4096])
    want = ref[1].parse_block_tables(blob[:4096])
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_parse_block_tables_high_byte_fixed_tree():
    """The fixed tree keeps the phantom symbols 286/287 (their 8-bit codes
    shift every 9-bit literal's code), as tests/test_device_inflate.py:145
    pins for the reference."""
    kind, lit, dist, hbits = inflate_dyn.parse_block_tables(encoded("highbyte")[0])
    assert (kind, hbits) == (1, 3)
    assert lit.tolist() == [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    assert dist.tolist() == [5] * 30


def _length_sets(seed):
    """Code lengths of real headers and of random codes up to 12 and 15 bits
    (complete, incomplete, one symbol, none)."""
    rng = np.random.default_rng(seed)
    lit = [inflate_dyn.parse_block_tables(encoded(n)[0][:4096])[1] for n in ("text", "runs")]
    dist = [inflate_dyn.parse_block_tables(encoded(n)[0][:4096])[2] for n in ("text", "far")]
    for cap in (12, 15):
        freq = (rng.zipf(1.3, 288) * (rng.random(288) < 0.8)).astype(np.int64)
        lit.append(length_limited_lengths(freq, cap).astype(np.int32))
        freq = (rng.zipf(1.2, 30) * (rng.random(30) < 0.9)).astype(np.int64)
        dist.append(length_limited_lengths(freq, cap).astype(np.int32))
    one_lit = np.zeros(288, np.int32)
    one_lit[[65, 256]] = 1
    incomplete = lit[0].copy()
    incomplete[:40] = 0
    lit += [one_lit, incomplete, np.zeros(288, np.int32)]
    dist += [np.eye(30, dtype=np.int32)[3], np.zeros(30, np.int32),
             np.full(30, 15, np.int32)]
    return np.stack(lit), np.stack(dist)


@pytest.mark.parametrize("nbits", [12, 15])
def test_lut_blocks_equal_reference(ref, nbits):
    import jax
    import jax.numpy as jnp

    lit, dist = _length_sets(nbits)
    assert lit.max() == 15 and dist.max() == 15
    got_l = inflate_lut._lit_lut_block(torch.from_numpy(lit), nbits).numpy()
    got_d = inflate_lut._dist_lut_block(torch.from_numpy(dist), nbits).numpy()
    want_l = jax.vmap(lambda x: ref[2]._lit_lut_block(x, nbits))(jnp.asarray(lit))
    want_d = jax.vmap(lambda x: ref[2]._dist_lut_block(x, nbits))(jnp.asarray(dist))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    np.testing.assert_array_equal(got_d, np.asarray(want_d))


def test_canon_tables_equal_reference(ref):
    import jax
    import jax.numpy as jnp

    lit, _ = _length_sets(3)
    got = inflate_dyn._canon_tables(torch.from_numpy(lit), 288)
    want = jax.vmap(lambda x: ref[1]._canon_tables(x, 288))(jnp.asarray(lit))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("route", ["lut", "dyn"])
def test_decode_equals_reference(ref, route):
    """A batch of dynamic, fixed and stored blocks and an empty row."""
    import jax.numpy as jnp

    arrays = batch(MIXED)
    port_fn = {"lut": inflate_lut.decode_blocks_indexed_lut,
               "dyn": inflate_dyn.decode_blocks_indexed_dyn}[route]
    ref_fn = {"lut": ref[2].decode_blocks_indexed_lut,
              "dyn": ref[1].decode_blocks_indexed_dyn}[route]
    port = port_fn(*to_torch(arrays), n_out=BS)
    want = ref_fn(*map(jnp.asarray, arrays), n_out=BS)
    assert int(port[1][0]) == 1
    assert_same(port, want, arrays[2])
    for j, name in enumerate(MIXED[:-1]):
        assert port[0][j * BS:j * BS + arrays[2][j]].numpy().tobytes() == case_data(name)


def test_fixed_route_equals_reference(ref):
    import jax.numpy as jnp

    comps, segs, ns, _, _ = batch(FIXED)
    port = inflate.decode_blocks_indexed(*to_torch((comps, segs, ns)), n_out=BS)
    want = ref[0].decode_blocks_indexed(*map(jnp.asarray, (comps, segs, ns)), n_out=BS)
    assert int(port[1][0]) == 1
    assert_same(port, want, ns)


def test_single_block_wrapper_equals_reference(ref):
    import jax.numpy as jnp

    blob, seg, n, _ = encoded("highbyte")
    comp = np.zeros(CAP, np.uint8)
    comp[:len(blob)] = np.frombuffer(blob, np.uint8)
    args = (comp, seg, np.int32(n))
    port = inflate.decode_block_indexed(*(torch.from_numpy(np.asarray(a)) for a in args),
                                        n_out=BS)
    want = ref[0].decode_block_indexed(*map(jnp.asarray, args), n_out=BS)
    assert_same(port, want, [n])
    assert port[0][:n].numpy().tobytes() == case_data("highbyte")


@pytest.mark.parametrize("route", ["lut", "dyn", "fixed"])
def test_corrupt_block_fails_in_both(ref, route):
    """One byte flipped in the token data of the first block, at several
    places: the port's ok is the reference's each time (a flip can decode
    to other tokens that still end every lane at its target, in both), and
    it is 0 at least once; where both say 1, the bytes are equal too."""
    import jax.numpy as jnp

    names = FIXED if route == "fixed" else MIXED
    blob = encoded(names[0])[0]
    oks = []
    for at in np.linspace(len(blob) // 4, len(blob) - 8, 5).astype(int):
        arrays = batch(names, flip=int(at))
        if route == "fixed":
            port = inflate.decode_blocks_indexed(*to_torch(arrays[:3]), n_out=BS)
            want = ref[0].decode_blocks_indexed(*map(jnp.asarray, arrays[:3]), n_out=BS)
        else:
            port = (inflate_lut.decode_blocks_indexed_lut if route == "lut"
                    else inflate_dyn.decode_blocks_indexed_dyn)(*to_torch(arrays), n_out=BS)
            want = (ref[2].decode_blocks_indexed_lut if route == "lut"
                    else ref[1].decode_blocks_indexed_dyn)(*map(jnp.asarray, arrays), n_out=BS)
        assert_same(port, want, arrays[2])
        oks.append(int(port[1][0]))
    assert 0 in oks


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5])
def test_running_max_equals_cummax(n):
    """The expansion's row-wise running max is torch.cummax, also across
    rows and with the padded tail."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(np.where(rng.random(n) < 0.7, 0, rng.integers(1, 1 << 40, n)))
    assert torch.equal(inflate._running_max(x), torch.cummax(x, 0).values)


def scan_args(arrays, route: str, device="cpu"):
    """P3's arguments for a numpy batch at one route."""
    comps, segs, ns, lit, dist = to_torch(arrays, device)
    bits, k, rsteps = (12, inflate_lut.K, inflate_lut.RSTEPS) if route == "lut" else (15, 1, 128)
    return (comps, segs, ns, inflate_lut._lit_lut_block(lit, bits),
            inflate_lut._dist_lut_block(dist, bits), k, rsteps)


@pytest.mark.parametrize("route", ["lut", "dyn"])
def test_plain_scan_records(route):
    """Every lane ends at its target; a lane's records are its tokens in
    order, each starting where the last ended, then exactly 511; inert
    lanes hold no token."""
    args = scan_args(batch(MIXED), route)
    rec, outp, bad = inflate_scan.inflate_scan(*args)
    assert rec.dtype == outp.dtype == torch.int32 and bad.dtype == torch.bool
    _, start, target = inflate_scan.lane_setup(args[1], args[2])
    assert not bad.any() and torch.equal(outp.to(torch.int64), target)
    S = BS // 128
    tokens = 0
    for lane in range(0, rec.shape[0], 37):
        r = rec[lane].to(torch.int64)
        took = r != inflate_scan.NO_TOKEN
        if route == "dyn":  # one token a step: the tokens come first
            n = int(took.sum())
            assert took[:n].all() and not took[n:].any()
        pos = int(start[lane])
        for v in r[took].tolist():
            assert v & 0x1FF == pos
            pos += 1 if (v >> 9) & 1 else 0
            if not (v >> 9) & 1:
                break
        tokens += int(took.sum())
        if int(args[2][lane // S]) == 0:
            assert not took.any()
    assert tokens > 0


@pytest.mark.parametrize("route", ["lut", "dyn"])
def test_all_literal_short_codes_equal_reference(ref, route):
    """A block of literals only, each with a 5- or 6-bit code (a de Bruijn
    sequence over 32 bytes holds no repeated 3-gram): two fit one 12-bit
    lookup, the case P3's two-literal entries take. Every lane holds 128
    literals, and the decode equals the reference's and the data."""
    import jax.numpy as jnp

    arrays = batch(("debruijn", "text"), rows=2)
    lens = arrays[3][0][:256]
    assert set(lens[lens > 0].tolist()) <= {5, 6}
    rec, outp, bad = inflate_scan.inflate_scan(*scan_args(arrays, route))
    lits = ((rec.to(torch.int64) >> 9) & 1).sum(1)[:len(case_data("debruijn")) // 128]
    assert not bad.any() and bool((lits == 128).all())
    port_fn = {"lut": inflate_lut.decode_blocks_indexed_lut,
               "dyn": inflate_dyn.decode_blocks_indexed_dyn}[route]
    ref_fn = {"lut": ref[2].decode_blocks_indexed_lut,
              "dyn": ref[1].decode_blocks_indexed_dyn}[route]
    port = port_fn(*to_torch(arrays), n_out=BS)
    assert_same(port, ref_fn(*map(jnp.asarray, arrays), n_out=BS), arrays[2])
    assert port[0][:arrays[2][0]].numpy().tobytes() == case_data("debruijn")


def test_scan_dispatch_and_refusals():
    args = scan_args(batch(("text",), rows=1), "lut")
    with pytest.raises(ValueError, match="CUDA"):
        inflate_scan.inflate_scan_cuda(*args)
    comps = args[0]
    with pytest.raises(ValueError, match="multiple of 16"):
        inflate_scan.inflate_scan(comps[:, :CAP - 8].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="k must"):
        inflate_scan.inflate_scan(*args[:5], 9, 26)
    with pytest.raises(ValueError, match="lit_lut"):
        inflate_scan.inflate_scan(*args[:3], args[3][:, :2048], *args[4:])
    with pytest.raises(ValueError, match="no inflate_scan"):
        inflate_scan.inflate_scan(comps.to("meta"), *args[1:])


# ---- on the card ---------------------------------------------------------

GPU_CASES = {
    "one_block": ("text",),
    "sixteen_blocks": ("text", "tail", "runs", "highbyte", "literals", "far", "fixed_text",
                       "stored") * 2,
    "fixed": ("runs", "highbyte", "fixed_text"),
    "all_literal": ("literals",),
    "long_matches": ("far", "runs"),
    "merged": ("runs",),
    "inert_and_corrupt": ("text", "stored", "tail"),
    "reads_leave_the_span": ("text", "literals"),
    "partial_last_block": ("tail", "text"),
    "one_row": ("text",),
    "inert_between": ("text", "stored", "far"),
    "all_literal_short_codes": ("debruijn", "literals"),
    "random_tables": ("text", "literals"),
}


def _leave_span(arrays):
    """Lanes whose reads leave their CUDA block's staged run of the stream:
    one pointed past the run (at a lane 45 segments on), one at its block's
    last byte, one at the last bits of ``comps``."""
    comps, segs, ns, lit, dist = (a.copy() for a in arrays)
    segs[0, 255] = (segs[0, 255] & ~0xFFFFFF) | (segs[0, 300] & 0xFFFFFF)
    end = len(encoded("text")[0]) * 8 - 8
    segs[0, 100] = (segs[0, 100] & ~0xFFFFFF) | end
    segs[1, 7] = (segs[1, 7] & ~0xFFFFFF) | (CAP * 8 - 3)
    return comps, segs, ns, lit, dist


def _partial_last_block(arrays):
    """S not a multiple of 32 or 256: the segments up to one, past 300, that
    no merged match reaches into; the rows' lengths cut there."""
    comps, segs, ns, lit, dist = arrays
    S = next(s for s in range(301, BS // 128) if segs[1, s] >> 24 == 0)
    return comps, segs[:, :S].copy(), np.minimum(ns, S * 128), lit, dist


# Per case: the batch's edit, and whether the scan is ok (None: the lanes
# pointed elsewhere decide it).
GPU_EDITS = {"reads_leave_the_span": (_leave_span, None),
             "partial_last_block": (_partial_last_block, True),
             "inert_and_corrupt": (lambda a: a, False),
             "random_tables": (lambda a: a, None)}


def _random_tables(args, seed: int = 10):
    """Tables of random words in place of the block's: no prefix code, any
    field values; the kernel must still equal the plain version."""
    rng = np.random.default_rng(seed)
    for t in args[3:5]:
        t.copy_(torch.from_numpy(rng.integers(-2**31, 2**31, tuple(t.shape), dtype=np.int64)
                                 .astype(np.int32)))


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["lut", "dyn"])
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_p3_equals_plain_gpu(cuda, case, route):
    names = GPU_CASES[case]
    corrupt = case == "inert_and_corrupt"
    flip = int(len(encoded(names[0])[0]) * 0.3) if corrupt else None
    arrays = batch(names, rows=1 if case == "one_row" else max(len(names), 2), flip=flip)
    edit, expect_ok = GPU_EDITS.get(case, (lambda a: a, True))
    args = scan_args(edit(arrays), route, cuda)
    if corrupt:  # and invalid distance codes in half of the last block's table
        args[4][-1, 1::2] &= ~1
    if case == "random_tables":
        _random_tables(args)
    got = inflate_scan.inflate_scan_cuda(*args)
    torch.cuda.synchronize()
    want = inflate_scan.inflate_scan_torch(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case in ("all_literal", "all_literal_short_codes"):
        assert int(((got[0] & 0x3FF) >> 9).sum(1).max()) == 128
    if case == "long_matches":
        rec = got[0].to(torch.int64)
        took = rec != inflate_scan.NO_TOKEN
        assert int(((rec >> 10) + 1)[took & ((rec >> 9) & 1 == 0)].max()) == 32768
    if expect_ok is not None:
        ok = inflate._scan_ok(args[1], args[2], got[1], got[2])
        assert bool(ok) == expect_ok
        assert bool(got[2].any()) != expect_ok


@pytest.mark.gpu
def test_p3_one_launch_a_batch_gpu(cuda, monkeypatch):
    arrays = batch(MIXED)
    calls = []
    plain = inflate_scan.inflate_scan_torch
    monkeypatch.setattr(inflate_scan, "inflate_scan_torch",
                        lambda *a: calls.append(1) or plain(*a))
    for fn in (inflate_lut.decode_blocks_indexed_lut, inflate_dyn.decode_blocks_indexed_dyn):
        before = _build.LAUNCHES["inflate_scan"]
        out, ok = fn(*to_torch(arrays, cuda), n_out=BS)
        assert _build.LAUNCHES["inflate_scan"] == before + 1 and int(ok[0]) == 1
        cpu = fn(*to_torch(arrays), n_out=BS)
        for j, n in enumerate(arrays[2]):
            assert torch.equal(out[j * BS:j * BS + n].cpu(), cpu[0][j * BS:j * BS + n])
    before = _build.LAUNCHES["inflate_scan"]
    inflate.decode_blocks_indexed(*to_torch(batch(FIXED)[:3], cuda), n_out=BS)
    assert _build.LAUNCHES["inflate_scan"] == before + 1
    assert len(calls) == 2  # the CPU decodes only


@pytest.mark.gpu
def test_p3_refusals_gpu(cuda):
    args = scan_args(batch(("text",), rows=2), "lut", cuda)
    comps = args[0]
    flat = torch.zeros(comps.numel() + 16, dtype=torch.uint8, device=cuda)
    unaligned = flat[4:4 + comps.numel()].view(comps.shape)
    with pytest.raises(ValueError, match="aligned"):
        inflate_scan.inflate_scan_cuda(unaligned, *args[1:])
    flat = torch.zeros(args[3].numel() + 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="lit_lut must be 16-byte aligned"):
        inflate_scan.inflate_scan_cuda(*args[:3], flat[1:1 + args[3].numel()].view(
            args[3].shape), *args[4:])
    with pytest.raises(ValueError, match="shared memory"):
        inflate_scan.inflate_scan_cuda(*args[:5], 8, 256)
    with pytest.raises(ValueError, match="multiple of 16"):
        inflate_scan.inflate_scan_cuda(comps[:, :CAP - 4].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="CUDA"):
        inflate_scan.inflate_scan_cuda(comps, args[1].cpu(), *args[2:])
    with pytest.raises(TypeError):
        inflate_scan.inflate_scan_cuda(comps, args[1].to(torch.int64), *args[2:])
