"""The inflates' back-reference resolution (``kernels/inflate_resolve.py``:
the expansion P7 and the pointer doubling P6) against the JAX reference on
the CPU: ``compu_tpu/kernels/inflate_jax.py::_expand_and_resolve`` on the
records of a CPU scan of ``test_torch_inflate``'s MIXED and FIXED batches
at (K, RSTEPS) = (6, 26) and (1, 128), and on corrupt records (a lane 0
whose first token starts late, a cycle; a match reaching before its block
into the previous block's undefined tail; two records with one start;
starts of 128-510, past the lane's own segment), runs of 3, 10 and 40
lanes with no record (a token crossing lanes, the carry over them);
``compu_tpu/kernels/inflate_spec.py::resolve_foreign`` on the token lists
the port's ``device_inflate`` records for two streams and on seeded token lists with
stored ranges (one token's gap running over 300,000 stored bytes among
them), an all-stored list, one that cannot resolve, tokens at every
1,024- and 4,096-position tile edge, stored runs over tile edges (tiles
with no token start), lengths not a multiple of 4 and a tile that
resolves rounds after its neighbours. ``ok`` and
the defined bytes (each block's first ``ns[b]``, the whole stream) must be
equal exactly (tolerance 0: integers). The int32 plain versions also equal
the int64 ones the port had before (copied below), their round counts
follow the reference's schedule, and so do their unresolved counts round
by round (``counts=True``).

Marked ``gpu`` (skipped without a card): each kernel equal to its plain
version on the same cases, round counts and unresolved counts included,
on random maps and on the foreign lists as misaligned views; the
resolution from P3's launch to the result with no host synchronisation
(``torch.cuda.set_sync_debug_mode("error")``); one launch of P7 and of P6
a batch.
"""

import functools
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

from compu_tpu_torch import _build  # noqa: E402
from compu_tpu_torch.kernels import inflate, inflate_resolve, inflate_scan  # noqa: E402
from compu_tpu_torch.kernels import inflate_lut, inflate_spec  # noqa: E402
from test_torch_inflate import BS, FIXED, MIXED, batch, scan_args, to_torch  # noqa: E402
from test_torch_inflate_spec import DATA, _mixed_stream, _tokens  # noqa: E402

S = BS // 128


@pytest.fixture
def ref():
    """The JAX reference's two resolutions and its foreign decoder module, on the CPU."""
    pytest.importorskip("jax")
    from compu_tpu.formats.deflate import device_inflate as ref_decoder
    from compu_tpu.kernels import inflate_jax, inflate_spec as ref_spec

    return inflate_jax, ref_spec, ref_decoder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---- the indexed cases ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scanned(names: tuple, route: str):
    """A CPU scan of the batch: (rec, ns, scan ok, R), numpy and a bool."""
    args = scan_args(batch(names), route)
    rec, outp, bad = inflate_scan.inflate_scan(*args)
    ok = inflate._scan_ok(args[1], args[2], outp, bad)
    return rec.numpy(), args[2].numpy(), bool(ok), args[5] * args[6]


def _late_first(rec, ns):
    """Lane 0's first token a match starting at 5 with distance 2, and its
    tokens before 5 gone: positions 0..4 take it too (the slot clamps to
    the first record), 0 goes forward to 4, and 3 and 4 point at
    themselves."""
    rec[0, (rec[0] & 0x1FF) < 5] = inflate_scan.NO_TOKEN
    rec[0, 0] = 5 | (1 << 10)


def _before_block(rec, ns):
    """Row 2's first lane starts with a match of distance 3,000, reaching
    back into row 1's bytes past its length (``tail``: 4,873 bytes)."""
    assert ns[1] < BS - 3000
    rec[2 * S, 0] = 0 | (2999 << 10)


def _same_start(rec, ns):
    """Two records of lane 3 with one start (and a match record of lane
    5 moved onto the start of its lane's first)."""
    rec[3, 1] = (rec[3, 1] & ~0x1FF) | (rec[3, 0] & 0x1FF)
    rec[5, 2] = (rec[5, 0] & 0x1FF) | (7 << 10)


def _empty_lanes(rec, ns):
    """Ten lanes of row 0 (10-19) and 40 of row 1 with no record: their
    positions take the last token before them, carried over the empty
    lanes (past the 32-lane window, and past a chunk of lanes)."""
    rec[10:20] = inflate_scan.NO_TOKEN
    rec[S + 30:S + 70] = inflate_scan.NO_TOKEN


def _reaching_starts(rec, ns):
    """Starts of 128-510, past the lane's own segment: a match of lane 40
    at 300 (two lanes on), one of lane 41 at 510 (three on), a literal of
    lane 45 at 200, each the last record of its lane."""
    for lane, start, word in ((40, 300, 4 << 10), (41, 510, 9 << 10), (45, 200, 1 << 9 | 65 << 10)):
        k = int(np.flatnonzero((rec[lane] & 0x1FF) < inflate_scan.NO_TOKEN)[-1])
        rec[lane, k] = start | word


def _crossing_token(rec, ns):
    """A match of lane 60 whose positions run over lanes 61-63: those lanes
    hold no record, so the token crosses three lane boundaries."""
    rec[61:64] = inflate_scan.NO_TOKEN
    k = int(np.flatnonzero((rec[60] & 0x1FF) < inflate_scan.NO_TOKEN)[-1])
    rec[60, k] = (rec[60, k] & 0x1FF) | (2 << 10)


# Per case: the batch, the scan's route and an edit of the records.
CASES = {
    "mixed_6x26": (MIXED, "lut", None),
    "mixed_1x128": (MIXED, "dyn", None),
    "fixed_6x26": (FIXED, "lut", None),
    "fixed_1x128": (FIXED, "dyn", None),
    "late_first": (MIXED, "lut", _late_first),
    "before_block": (MIXED, "lut", _before_block),
    "same_start": (MIXED, "dyn", _same_start),
    "empty_lanes": (MIXED, "lut", _empty_lanes),
    "reaching_starts": (MIXED, "lut", _reaching_starts),
    "crossing_token": (MIXED, "dyn", _crossing_token),
}


def indexed_case(case: str):
    """(rec int32 (B*S, R), ns int32 (B,), scan ok, B, R) of a case, CPU
    tensors (fresh copies)."""
    names, route, edit = CASES[case]
    rec, ns, ok, R = _scanned(names, route)
    rec, ns = rec.copy(), ns.copy()
    if edit is not None:
        edit(rec, ns)
    return torch.from_numpy(rec), torch.from_numpy(ns), torch.tensor(ok), len(ns), R


def _assert_same(port, ref_out, ref_ok, ns):
    """ok equal, and each block's defined bytes equal."""
    out, ok = port[0].cpu().numpy(), int(port[1][0])
    ref_out = np.asarray(ref_out)
    assert ok == int(np.asarray(ref_ok)[0])
    for b, n in enumerate(ns):
        assert out[b * BS:b * BS + n].tobytes() == ref_out[b * BS:b * BS + n].tobytes(), b


@pytest.mark.parametrize("case", list(CASES))
def test_indexed_equals_reference(ref, case):
    import jax.numpy as jnp

    rec, ns, ok, B, R = indexed_case(case)
    port = inflate._expand_and_resolve(rec, ns, ok, B=B, N=BS, S=S, R=R)
    want = ref[0]._expand_and_resolve(
        jnp.asarray(rec.numpy().view(np.uint32)), jnp.arange(B * S, dtype=jnp.int32),
        jnp.asarray(ns.numpy()), jnp.asarray(bool(ok)), B=B, N=BS, S=S, R=R)
    _assert_same(port, *want, ns.tolist())
    assert int(port[1][0]) == (case != "late_first" and bool(ok))


def test_corrupt_cases_do_what_they_are_for():
    """late_first leaves a cycle for the compacted rounds, which run out
    their limit; before_block's match lands past the previous block's
    length; same_start's records collide."""
    rec, ns, ok, B, R = indexed_case("late_first")
    root = inflate_resolve.expand_indexed_torch(rec, B=B, N=BS, S=S, R=R)
    assert root[:5].tolist() == [4, 3, 4, 3, 4]
    _, got_ok, rounds = inflate_resolve.resolve_indexed_torch(root, ns, ok, N=BS)
    max_iters, _ = inflate_resolve.indexed_schedule(B * BS)
    assert int(got_ok[0]) == 0 and int(rounds[1]) == max_iters
    rec, ns, ok, B, R = indexed_case("before_block")
    root = inflate_resolve.expand_indexed_torch(rec, B=B, N=BS, S=S, R=R)
    assert BS + int(ns[1]) <= int(root[2 * BS]) < 2 * BS
    rec, *_ = indexed_case("same_start")
    assert int(rec[3, 1]) & 0x1FF == int(rec[3, 0]) & 0x1FF < inflate_scan.NO_TOKEN


# Today's int64 expansion and resolution, as the port had them before the
# kernels: the int32 plain versions must give the same results.

def _expand_int64(rec, *, B, N, S, R):
    L, NT = B * S, B * N
    rec = rec.to(torch.int64).reshape(L, R)
    t_start = rec & 0x1FF
    flat_start = (torch.arange(L)[:, None] * 128 + t_start).reshape(-1)
    slot = torch.arange(1, L * R + 1)
    dump = NT + 128 + 512
    addr = torch.where(t_start.reshape(-1) < 511, flat_start, dump + (slot & ((1 << 16) - 1)))
    slot_at = torch.zeros(dump + (1 << 16), dtype=torch.int64).scatter_reduce(
        0, addr, slot, "amax")[:NT]
    tokid = torch.clamp(inflate._running_max(slot_at) - 1, 0, L * R - 1)
    rec_of = rec.reshape(-1)[tokid]
    is_lit = ((rec_of >> 9) & 1) > 0
    payload = (rec_of >> 10) & 0x7FFF
    dist = payload + 1
    start = (tokid // R) * 128 + (rec_of & 0x1FF)
    src = start - dist + torch.remainder(torch.arange(NT) - start, dist)
    return torch.where(is_lit, -(payload + 1), torch.clamp(src, 0, NT - 1))


def _resolve_int64(root, ns, ok, *, N):
    NT = root.shape[0]
    gp = torch.arange(NT)
    valid = (gp % N) < ns.to(torch.int64)[gp // N]
    max_iters = max(1, math.ceil(math.log2(max(NT, 2))))
    ksub = max(128, NT // 8)

    def unresolved() -> int:
        return int(((root >= 0) & valid).sum())

    it, left = 0, unresolved()
    while left > ksub and it < max_iters:
        root = inflate._double(root)
        it, left = it + 1, unresolved()
    cand = torch.nonzero((root >= 0) & valid).reshape(-1)[:ksub]
    sub = root[cand]
    it = 0
    while it < max_iters and bool((sub >= 0).any()):
        sub = inflate._double_sub(root, cand, sub)
        it += 1
    out = (torch.where(root < 0, -root, 1) - 1).to(torch.uint8)
    ok = ok & torch.where(valid, root < 0, True).all()
    return out, ok.to(torch.int32).reshape(1)


@pytest.mark.parametrize("case", list(CASES))
def test_int32_plain_versions_equal_int64(case):
    rec, ns, ok, B, R = indexed_case(case)
    old = _expand_int64(rec, B=B, N=BS, S=S, R=R)
    root = inflate_resolve.expand_indexed_torch(rec, B=B, N=BS, S=S, R=R)
    assert root.dtype == torch.int32 and torch.equal(root.to(torch.int64), old)
    kept = root.clone()
    out, got_ok, rounds = inflate_resolve.resolve_indexed_torch(root, ns, ok, N=BS)
    assert torch.equal(root, kept)  # the input is left as it was
    want_out, want_ok = _resolve_int64(old, ns, ok, N=BS)
    assert torch.equal(out, want_out) and torch.equal(got_ok, want_ok)
    assert rounds.dtype == torch.int32 and rounds.shape == (2,)


def _random_map(seed: int, nt: int, depth: int, cycles: int):
    """Roots of chains up to ``depth`` hops long over a random order of the
    positions, and ``cycles`` positions pointing at themselves."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(nt)
    root = np.empty(nt, np.int64)
    heads = rng.random(nt) < 1.0 / depth
    heads[0] = True
    prev = order[0]
    for p in order:
        root[p] = -int(rng.integers(1, 257)) if heads[p] else prev
        prev = p
    loops = rng.integers(0, nt, cycles)
    root[loops] = loops
    return torch.from_numpy(root.astype(np.int32))


def test_truncated_compaction_equals_int64():
    """More unresolved positions than the compacted set holds after every
    whole-map round (many self-loops): the first ksub of them go on, the
    rest stay unresolved, as before."""
    root = _random_map(9, 1 << 16, 50, 30_000)
    ns = torch.tensor([1 << 15, 1 << 15], dtype=torch.int32)
    out, ok, rounds = inflate_resolve.resolve_indexed_torch(root, ns, torch.tensor(True),
                                                            N=1 << 15)
    want_out, want_ok = _resolve_int64(root.to(torch.int64), ns, torch.tensor(True), N=1 << 15)
    max_iters, _ = inflate_resolve.indexed_schedule(1 << 16)
    assert torch.equal(out, want_out) and torch.equal(ok, want_ok) and int(ok[0]) == 0
    assert rounds.tolist() == [max_iters, max_iters]


@pytest.mark.parametrize("case", ["mixed_6x26", "late_first", "before_block", "empty_lanes"])
def test_plain_counts_follow_the_schedule(case):
    """``counts=True``: row 0 the unresolved valid positions before the
    first whole-map round and after each, row 1 the compacted set's size
    and its unresolved count after each of its rounds, 0 past the rounds;
    the other outputs as without it."""
    rec, ns, ok, B, R = indexed_case(case)
    root = inflate_resolve.expand_indexed_torch(rec, B=B, N=BS, S=S, R=R)
    out, got_ok, rounds, seen = inflate_resolve.resolve_indexed_torch(root, ns, ok, N=BS,
                                                                      counts=True)
    plain = inflate_resolve.resolve_indexed_torch(root, ns, ok, N=BS)
    assert all(torch.equal(a, b) for a, b in zip((out, got_ok, rounds), plain))
    max_iters, ksub = inflate_resolve.indexed_schedule(root.shape[0])
    assert seen.dtype == torch.int32 and seen.shape == (2, max_iters + 1)
    gp = torch.arange(root.shape[0])
    valid = (gp % BS) < ns.to(torch.int64)[gp // BS]
    r = root.to(torch.int64)
    want = [int(((r >= 0) & valid).sum())]
    for _ in range(int(rounds[0])):
        r = inflate._double(r)
        want.append(int(((r >= 0) & valid).sum()))
    assert seen[0, :len(want)].tolist() == want and not seen[0, len(want):].any()
    cand = torch.nonzero((r >= 0) & valid).reshape(-1)[:ksub]
    sub = r[cand]
    want = [cand.numel()]
    for _ in range(int(rounds[1])):
        sub = inflate._double_sub(r, cand, sub)
        want.append(int((sub >= 0).sum()))
    assert seen[1, :len(want)].tolist() == want and not seen[1, len(want):].any()


@pytest.mark.parametrize("nt, ns", [(1, [1]), (5, [5]), (640, [100, 0, 128, 128, 77])])
def test_resolve_indexed_small_maps(nt, ns):
    """Maps of one position, one partial block and blocks of 128 (ksub
    exceeds the map): a chain, a self-loop past a block's length, rounds
    that stop at once."""
    N = nt // len(ns)
    root = torch.full((nt,), -66, dtype=torch.int32)
    if nt > 1:
        root[1:] = torch.arange(nt - 1, dtype=torch.int32)  # a chain back to position 0
        root[nt - 1] = nt - 1                                # the last one points at itself
    ns_t = torch.tensor(ns, dtype=torch.int32)
    out, ok, rounds = inflate_resolve.resolve_indexed_torch(root, ns_t, torch.tensor(True), N=N)
    old_out, old_ok = _resolve_int64(root.to(torch.int64), ns_t, torch.tensor(True), N=N)
    assert torch.equal(out, old_out) and torch.equal(ok, old_ok)
    last_valid = (nt - 1) % N < ns[(nt - 1) // N]
    assert int(ok[0]) == (0 if nt > 1 and last_valid else 1)


# ---- the foreign cases ----------------------------------------------------

def _lz_tokens(seed: int, n: int, stored_at=(), lead_stored: int = 0, stretch=(-1, 0)):
    """A seeded token list: literals and matches (distances within what is
    written), stored ranges of 40-300 bytes at the given token counts,
    ``lead_stored`` stored bytes first and a stored stretch of
    ``stretch[1]`` bytes at token count ``stretch[0]``. Returns the six
    arrays ``device_inflate`` hands ``resolve_foreign``, total_out and the bytes."""
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, lead_stored, dtype=np.uint8).tobytes())
    stored = [(0, lead_stored)] if lead_stored else []
    toks = []
    while len(out) < n:
        if len(toks) in stored_at and (not stored or stored[-1][1] != len(out)) or \
                len(toks) == stretch[0] and (not stored or stored[-1][0] != len(out)):
            k = int(rng.integers(40, 300)) if len(toks) != stretch[0] else stretch[1]
            stored.append((len(out), len(out) + k))
            out += rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        if len(out) and rng.random() < 0.6:
            dist = int(rng.integers(1, min(len(out), 32768) + 1))
            length = int(rng.integers(3, 259))
            toks.append((length, 0, dist - 1, len(out)))
            for _ in range(length):
                out.append(out[-dist])
        else:
            b = int(rng.integers(0, 256))
            toks.append((1, 1, b, len(out)))
            out.append(b)
    return _as_arrays(toks, stored, out)


def _edge_tokens(seed: int, n: int, edge: int = 4096):
    """A seeded token list whose tokens never straddle a multiple of
    ``edge``, so a token starts exactly at every tile edge; a stored range
    of 5,000 bytes starts at the second edge and spans the next one, and
    the length is a multiple of neither 4 nor ``edge``."""
    rng = np.random.default_rng(seed)
    out, toks, stored = bytearray(), [], []
    while len(out) < n:
        if len(out) == 2 * edge:
            stored.append((len(out), len(out) + 5000))
            out += rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
            continue
        room = edge - len(out) % edge
        if len(out) and rng.random() < 0.6 and room >= 3:
            dist = int(rng.integers(1, min(len(out), 32768) + 1))
            length = min(int(rng.integers(3, 259)), room)
            toks.append((length, 0, dist - 1, len(out)))
            for _ in range(length):
                out.append(out[-dist])
        else:
            b = int(rng.integers(0, 256))
            toks.append((1, 1, b, len(out)))
            out.append(b)
    while len(out) % 4 == 0 or len(out) % edge == 0:
        b = int(rng.integers(0, 256))
        toks.append((1, 1, b, len(out)))
        out.append(b)
    return _as_arrays(toks, stored, out)


def _late_tile():
    """A map in which one 512-position tile resolves rounds after its
    neighbours: [0, 512) literals, [512, 1024) 128 matches of 4 at distance
    4 (chains of up to 128 hops back into the literals), [1024, 1536)
    literals, [1536, 2048) a copy of [512, 1024) at distance 1,024, then
    literals."""
    rng = np.random.default_rng(8)
    out, toks = bytearray(), []

    def literals(k):
        for b in rng.integers(0, 256, k).tolist():
            toks.append((1, 1, b, len(out)))
            out.append(b)

    def match(dist, total, longest=258):
        while total:
            length = min(longest, total)
            toks.append((length, 0, dist - 1, len(out)))
            for _ in range(length):
                out.append(out[-dist])
            total -= length

    literals(512)
    match(4, 512, longest=4)
    literals(512)
    match(1024, 512)
    literals(2101)
    return _as_arrays(toks, [], out)


def _as_arrays(toks, stored, out):
    """The six arrays ``device_inflate`` hands ``resolve_foreign`` of a
    token list (length, is_lit, payload, start) and stored ranges, the
    length and the bytes."""
    t = np.asarray(toks, np.int64).reshape(-1, 4)
    stored_out = np.zeros(len(out), np.uint8)
    stored_mask = np.zeros(len(out), bool)
    for a, b in stored:
        stored_out[a:b] = np.frombuffer(bytes(out[a:b]), np.uint8)
        stored_mask[a:b] = True
    arrays = [t[:, 0].astype(np.int32), t[:, 1].astype(np.int32), t[:, 2].astype(np.int32),
              t[:, 3], stored_out, stored_mask]
    return arrays, len(out), bytes(out)


def _all_stored():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 1000, dtype=np.uint8)
    empty = np.zeros(0, np.int32)
    return [empty, empty, empty, np.zeros(0, np.int64), raw, np.ones(1000, bool)], 1000, \
        raw.tobytes()


def _unresolvable():
    """A first match reaching before the stream (``device_inflate`` refuses such a
    distance first): positions 0..19 copy 0..19 back, a cycle."""
    arrays, n, raw = _lz_tokens(7, 3000)
    arrays[1][0], arrays[2][0], arrays[0][0] = 0, 19, 20
    arrays[3][1:] += 19
    arrays[4] = np.zeros(n + 19, np.uint8)
    arrays[5] = np.zeros(n + 19, bool)
    return arrays, n + 19, None


@functools.lru_cache(maxsize=None)
def foreign_case(case: str):
    """(the six arrays, total_out, the bytes or None) of a foreign case."""
    if case == "gzip_fixture":
        data = (DATA / "alice29.txt.gz").read_bytes()
        from compu_tpu_torch.formats.deflate import device_inflate

        (arrays, total_out), out = _tokens(data, 8 * device_inflate._parse_gzip_header(data))
        return arrays, total_out, out
    if case == "stored_and_flushes":
        data, raw = _mixed_stream()
        (arrays, total_out), out = _tokens(data, 0)
        assert out == raw
        return arrays, total_out, raw
    if case == "gaps_and_stored":
        return _lz_tokens(3, 60_000, stored_at=(0, 17, 18, 400, 401), lead_stored=0)
    if case == "leading_stored":
        return _lz_tokens(4, 20_000, stored_at=(250,), lead_stored=500)
    if case == "long_stored_stretch":   # one token's gap runs over 300,000 stored bytes
        return _lz_tokens(6, 400_000, stretch=(50, 300_000))
    if case == "all_stored":
        return _all_stored()
    if case == "unresolvable":
        return _unresolvable()
    if case == "tile_edges":
        return _edge_tokens(10, 5 * 4096)
    if case == "stored_over_tiles":   # 9,000 stored bytes from mid-tile: two empty tiles' edges
        return _lz_tokens(11, 30_000, stretch=(150, 9000))
    if case == "late_tile":
        return _late_tile()
    raise KeyError(case)


FOREIGN = ("gzip_fixture", "stored_and_flushes", "gaps_and_stored", "leading_stored",
           "long_stored_stretch", "all_stored", "unresolvable", "tile_edges",
           "stored_over_tiles", "late_tile")


def foreign_tensors(case: str, device="cpu"):
    arrays, total_out, raw = foreign_case(case)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays], total_out, raw


@pytest.mark.parametrize("case", FOREIGN)
def test_foreign_equals_reference(ref, case):
    import jax.numpy as jnp

    _, ref_spec, ref_decoder = ref
    tensors, total_out, raw = foreign_tensors(case)
    got, ok = inflate_spec.resolve_foreign(*tensors, total_out=total_out)
    ol, il, pay, st, stored_out, stored_mask = foreign_case(case)[0]
    # The reference's shapes: tokens and positions padded to powers of two.
    NT = ref_decoder._pow2ceil(total_out)
    T = ref_decoder._pow2ceil(max(len(ol), 1), lo=1 << 8)
    pad = lambda a: np.concatenate([a, np.zeros(T - len(a), a.dtype)])  # noqa: E731
    r_out = np.zeros(NT, np.uint8)
    r_out[:total_out] = stored_out
    r_mask = np.ones(NT, bool)
    r_mask[:total_out] = stored_mask
    want, want_ok = ref_spec.resolve_foreign(
        jnp.asarray(pad(ol)), jnp.asarray(pad(il)), jnp.asarray(pad(pay)),
        jnp.asarray(pad(st).astype(np.int32)), jnp.asarray(r_out), jnp.asarray(r_mask),
        total_out=NT)
    assert int(ok[0]) == int(np.asarray(want_ok)[0]) == (raw is not None)
    if raw is not None:
        assert got.numpy().tobytes() == np.asarray(want)[:total_out].tobytes() == raw


def _resolve_foreign_int64(outlens, is_lit, payload, starts, stored_out, stored_mask, *,
                           total_out):
    NT = total_out
    T = outlens.shape[0]
    starts = starts.to(torch.int64)
    pay = payload.to(torch.int64)
    slot_at = torch.zeros(NT, dtype=torch.int64)
    slot_at[starts] = torch.arange(1, T + 1)
    tokid = torch.clamp(inflate._running_max(slot_at) - 1, 0, max(T - 1, 0))
    if T:
        start_of, pay_of, lit_of = starts[tokid], pay[tokid], is_lit[tokid] != 0
        dist_of = pay_of + 1
        src = start_of - dist_of + torch.remainder(torch.arange(NT) - start_of, dist_of)
        root = torch.where(lit_of, -(pay_of + 1), torch.clamp(src, 0, NT - 1))
    else:
        root = torch.zeros(NT, dtype=torch.int64)
    root = torch.where(stored_mask, -(stored_out.to(torch.int64) + 1), root)
    max_iters = max(12, math.ceil(math.log2(max(NT, 2))))
    it = 0
    while it < max_iters and bool((root >= 0).any()):
        for _ in range(min(4, max_iters - it)):
            root = inflate._double(root)
            it += 1
    out = (torch.where(root < 0, -root, 1) - 1).to(torch.uint8)
    return out, (root < 0).all().to(torch.int32).reshape(1), root


@pytest.mark.parametrize("case", FOREIGN)
def test_foreign_int32_plain_versions_equal_int64(case):
    tensors, total_out, _ = foreign_tensors(case)
    want_out, want_ok, _ = _resolve_foreign_int64(*tensors, total_out=total_out)
    root = inflate_resolve.expand_foreign_torch(*tensors, total_out=total_out)
    assert root.dtype == torch.int32
    out, ok, rounds = inflate_resolve.resolve_foreign_roots_torch(root)
    assert torch.equal(out, want_out) and torch.equal(ok, want_ok)
    # The rounds that began with a root unresolved: one more and the last
    # would have begun with none (or the limit).
    limit = inflate_resolve.foreign_max_iters(total_out)
    n = int(rounds[0])
    assert int(rounds[1]) == 0 and 0 <= n <= limit
    r = root.to(torch.int64)
    for _ in range(n):
        assert bool((r >= 0).any())
        r = inflate._double(r)
    assert n == limit or not bool((r >= 0).any())


@pytest.mark.parametrize("case", FOREIGN)
def test_plain_foreign_counts_follow_the_rounds(case):
    """The foreign resolution's counts: every position's unresolved count
    before the first round and after each (0 once all are resolved); row 1
    zero."""
    tensors, total_out, _ = foreign_tensors(case)
    root = inflate_resolve.expand_foreign_torch(*tensors, total_out=total_out)
    out, ok, rounds, seen = inflate_resolve.resolve_foreign_roots_torch(root, counts=True)
    plain = inflate_resolve.resolve_foreign_roots_torch(root)
    assert all(torch.equal(a, b) for a, b in zip((out, ok, rounds), plain))
    assert seen.shape == (2, inflate_resolve.foreign_max_iters(total_out) + 1)
    r = root.to(torch.int64)
    want = [int((r >= 0).sum())]
    for _ in range(seen.shape[1] - 1):
        r = inflate._double(r)
        want.append(int((r >= 0).sum()))
    assert seen[0].tolist() == want and not seen[1].any()
    assert int(rounds[0]) == sum(1 for c in want[:-1] if c)


def test_dispatch_and_refusals():
    rec, ns, ok, B, R = indexed_case("fixed_6x26")
    with pytest.raises(ValueError, match="CUDA"):
        inflate_resolve.expand_indexed_cuda(rec, B=B, N=BS, S=S, R=R)
    root = inflate_resolve.expand_indexed(rec, B=B, N=BS, S=S, R=R)
    with pytest.raises(ValueError, match="CUDA"):
        inflate_resolve.resolve_indexed_cuda(root, ns, ok, N=BS)
    with pytest.raises(ValueError, match="CUDA"):
        inflate_resolve.resolve_foreign_roots_cuda(root)
    tensors, total_out, _ = foreign_tensors("gaps_and_stored")
    with pytest.raises(ValueError, match="CUDA"):
        inflate_resolve.expand_foreign_cuda(*tensors, total_out=total_out)
    with pytest.raises(ValueError, match="no expand_indexed"):
        inflate_resolve.expand_indexed(rec.to("meta"), B=B, N=BS, S=S, R=R)
    with pytest.raises(ValueError, match="no resolve_indexed"):
        inflate_resolve.resolve_indexed(root.to("meta"), ns, ok, N=BS)
    with pytest.raises(ValueError, match="no resolve_foreign_roots"):
        inflate_resolve.resolve_foreign_roots(root.to("meta"))
    with pytest.raises(ValueError, match="no expand_foreign"):
        inflate_resolve.expand_foreign(*tensors[:4], tensors[4].to("meta"), tensors[5],
                                       total_out=total_out)


def test_kernel_names_and_entries():
    """The launch counters and the C entries the wrappers call."""
    assert {"inflate_expand", "inflate_resolve"} <= set(_build.LAUNCHES)
    for entry in ("compu_inflate_expand_indexed", "compu_inflate_expand_foreign",
                  "compu_inflate_resolve", "compu_inflate_resolve_max_grid",
                  "compu_inflate_resolve_ctr_words"):
        assert entry in _build._SIGNATURES
    src = (pathlib.Path(_build.CSRC) / "inflate_resolve.cu").read_text()
    for entry in _build._SIGNATURES:
        if entry.startswith(("compu_inflate_expand", "compu_inflate_resolve")):
            assert f'extern "C" int {entry}(' in src


# ---- on the card ----------------------------------------------------------

def _equal(got, want):
    return all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_p7_p6_indexed_equal_plain_gpu(cuda, case):
    """Roots, bytes, ok, rounds and the unresolved counts round by round."""
    rec, ns, ok, B, R = indexed_case(case)
    want_root = inflate_resolve.expand_indexed_torch(rec, B=B, N=BS, S=S, R=R)
    root = inflate_resolve.expand_indexed_cuda(rec.to(cuda), B=B, N=BS, S=S, R=R)
    torch.cuda.synchronize()
    assert torch.equal(root.cpu(), want_root)
    want = inflate_resolve.resolve_indexed_torch(want_root, ns, ok, N=BS, counts=True)
    kept = root.clone()
    got = inflate_resolve.resolve_indexed_cuda(root, ns.to(cuda), ok.to(cuda), N=BS, counts=True)
    torch.cuda.synchronize()
    assert len(got) == 4 and _equal(got, want) and torch.equal(root, kept)


@pytest.mark.gpu
@pytest.mark.parametrize("case", FOREIGN)
def test_p7_p6_foreign_equal_plain_gpu(cuda, case):
    """Roots, bytes, ok, rounds and the unresolved counts round by round."""
    tensors, total_out, raw = foreign_tensors(case)
    want_root = inflate_resolve.expand_foreign_torch(*tensors, total_out=total_out)
    root = inflate_resolve.expand_foreign_cuda(*(t.to(cuda) for t in tensors),
                                               total_out=total_out)
    torch.cuda.synchronize()
    assert torch.equal(root.cpu(), want_root)
    got = inflate_resolve.resolve_foreign_roots_cuda(root, counts=True)
    torch.cuda.synchronize()
    assert _equal(got, inflate_resolve.resolve_foreign_roots_torch(want_root, counts=True))
    if raw is not None:
        assert got[0].cpu().numpy().tobytes() == raw


@pytest.mark.gpu
@pytest.mark.parametrize("lead", [0, 1, 3, 4095, 4096, 4097])
def test_p7_foreign_misaligned_inputs_gpu(cuda, lead):
    """The token list and the stored bytes and mask as views that start
    ``lead`` elements into their storage (16-byte loads only where they are
    aligned), and a map of a tile and a few positions."""
    tensors, total_out, _ = foreign_tensors("tile_edges")
    views = []
    for t in tensors:
        pad = torch.zeros(lead + t.shape[0], dtype=t.dtype)
        pad[lead:] = t
        views.append(pad.to(cuda)[lead:])
    want = inflate_resolve.expand_foreign_torch(*tensors, total_out=total_out)
    got = inflate_resolve.expand_foreign_cuda(*views, total_out=total_out)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["indexed", "foreign"])
def test_p6_late_tile_equals_plain_gpu(cuda, kind):
    """A tile that resolves rounds after its neighbours, with a tile that
    copies from it: its second map still holds stale pointers the round it
    resolves, which the next round's first hop must replace."""
    tensors, total_out, raw = foreign_tensors("late_tile")
    root = inflate_resolve.expand_foreign_torch(*tensors, total_out=total_out)
    if kind == "foreign":
        want = inflate_resolve.resolve_foreign_roots_torch(root, counts=True)
        got = inflate_resolve.resolve_foreign_roots_cuda(root.to(cuda), counts=True)
    else:
        ns, ok = torch.tensor([total_out], dtype=torch.int32), torch.tensor(True)
        want = inflate_resolve.resolve_indexed_torch(root, ns, ok, N=total_out, counts=True)
        got = inflate_resolve.resolve_indexed_cuda(root.to(cuda), ns.to(cuda), ok.to(cuda),
                                                   N=total_out, counts=True)
    torch.cuda.synchronize()
    assert _equal(got, want) and got[0].cpu().numpy().tobytes() == raw
    assert int(want[2][0]) >= 4   # the chain of 512 hops takes rounds


@pytest.mark.gpu
@pytest.mark.parametrize("nt, depth, cycles", [(1, 1, 0), (5, 4, 1), (1 << 16, 40, 0),
                                               (1 << 20, 1000, 0), (1 << 20, 30, 3),
                                               (3 << 20, 200, 1), (1 << 20, 50, 200_000)])
def test_p6_random_maps_equal_plain_gpu(cuda, nt, depth, cycles):
    root = _random_map(nt + depth, nt, depth, cycles)
    blocks = max(1, nt // (1 << 16))
    N = nt // blocks
    ns = torch.from_numpy(np.random.default_rng(nt).integers(0, N + 1, blocks).astype(np.int32))
    ns[0] = N
    want = inflate_resolve.resolve_indexed_torch(root, ns, torch.tensor(True), N=N, counts=True)
    got = inflate_resolve.resolve_indexed_cuda(root.to(cuda), ns.to(cuda),
                                               torch.tensor(True, device=cuda), N=N, counts=True)
    torch.cuda.synchronize()
    assert _equal(got, want)
    want = inflate_resolve.resolve_foreign_roots_torch(root, counts=True)
    got = inflate_resolve.resolve_foreign_roots_cuda(root.to(cuda), counts=True)
    torch.cuda.synchronize()
    assert _equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["lut", "dyn"])
def test_no_host_read_from_the_scan_to_the_result_gpu(cuda, route):
    """From P3's launch to the batch's (out, ok), and through the foreign
    resolution, nothing synchronises with the host."""
    args = scan_args(batch(MIXED), route, cuda)
    torch.cuda.synchronize()
    tensors, total_out, raw = foreign_tensors("gaps_and_stored", cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, ok = inflate._decode_with_luts(*args, n_out=BS)
        f_out, f_ok = inflate_spec.resolve_foreign(*tensors, total_out=total_out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = inflate._decode_with_luts(*scan_args(batch(MIXED), route), n_out=BS)
    assert int(ok[0]) == int(cpu[1][0]) == 1
    for b, n in enumerate(args[2].tolist()):
        assert torch.equal(out[b * BS:b * BS + n].cpu(), cpu[0][b * BS:b * BS + n])
    assert int(f_ok[0]) == 1 and f_out.cpu().numpy().tobytes() == raw


@pytest.mark.gpu
def test_one_launch_of_p7_and_p6_a_batch_gpu(cuda):
    arrays = batch(MIXED)
    for fn in (inflate_lut.decode_blocks_indexed_lut, inflate.decode_blocks_indexed):
        before = dict(_build.LAUNCHES)
        a = arrays if fn is inflate_lut.decode_blocks_indexed_lut else batch(FIXED)[:3]
        fn(*to_torch(a, cuda), n_out=BS)
        assert _build.LAUNCHES["inflate_expand"] == before["inflate_expand"] + 1
        assert _build.LAUNCHES["inflate_resolve"] == before["inflate_resolve"] + 1
    tensors, total_out, _ = foreign_tensors("stored_and_flushes", cuda)
    before = dict(_build.LAUNCHES)
    inflate_spec.resolve_foreign(*tensors, total_out=total_out)
    assert _build.LAUNCHES["inflate_expand"] == before["inflate_expand"] + 1
    assert _build.LAUNCHES["inflate_resolve"] == before["inflate_resolve"] + 1
