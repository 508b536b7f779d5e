"""The v3 encode's table stage (kernel P5, ``kernels/build_tables.py``).

On the CPU the port's ``_build_tables`` (its plain version) is held to the
reference's ``jax.vmap(_build_tables)`` on every output key, exactly
(tolerance 0: integer outputs from integer inputs; the float steps are the
reference's own roundings). The tests marked ``gpu`` hold the CUDA kernel
to the plain version on the card, on the same rows and on random ones.
Every row is made from a numpy seed.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import _build  # noqa: E402
from compu_tpu_torch.kernels import build_tables as bt  # noqa: E402
from compu_tpu_torch.kernels.deflate_v3 import _build_tables, encode_blocks_dyn  # noqa: E402

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
NLIT, NDIST = bt.NLIT, bt.NDIST
KEYS = ("lit_len", "lit_code", "dist_len", "dist_code", "hdr_vals", "hdr_bits",
        "header_total", "use_stored")
ROWS = 8  # every set is padded to this many rows: one compile of the reference
# The flat tree's float32 key -freq * 286 + index is inexact past this
# frequency (286 * 58,661 > 2^24).
INEXACT_FREQ = 58_661


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _row(lit, dist, xl=0, xd=0, ns=None):
    lit = np.asarray(lit, np.int64)
    dist = np.asarray(dist, np.int64)
    return lit, dist, xl, xd, int(lit.sum() if ns is None else ns)


def _stack(rows):
    """(lit (B, 286), dist (B, 30), xl, xd, ns (B,)) int64 arrays, padded to
    ROWS rows by repeating the first."""
    rows = list(rows) + [rows[0]] * (ROWS - len(rows))
    return tuple(np.array([r[k] for r in rows], np.int64) for k in range(5))


@functools.lru_cache(maxsize=1)
def _real_rows():
    """Token histograms of five 32 KiB blocks (text, a repeated half, random
    bytes, low-entropy bytes, a short block) from the port's matcher and
    ``_tok_hist_from_match``, as the level-6 encode takes them."""
    from compu_tpu_torch.kernels.deflate_v2 import match_and_parse_batch
    from compu_tpu_torch.kernels.deflate_v3 import _tok_hist_from_match

    N = 1 << 15
    rng = np.random.default_rng(17)
    blocks = np.zeros((5, N), np.uint8)
    blocks[0] = np.frombuffer(TEXT[:N], np.uint8)
    blocks[1] = np.frombuffer((TEXT[4000:4000 + N // 2] * 2)[:N], np.uint8)
    blocks[2] = rng.integers(0, 256, N, dtype=np.uint8)
    blocks[3] = rng.integers(0, 5, N, dtype=np.uint8)
    blocks[4, :3000] = np.frombuffer(TEXT[9000:12000], np.uint8)
    lens = np.array([N, N, N, N, 3000], np.int64)
    b, n = torch.from_numpy(blocks), torch.from_numpy(lens)
    _, lf, df, xl, xd = _tok_hist_from_match(
        b, n, *match_and_parse_batch(b, n, depth=16, wcap=16, lex_keys=2, stride=1))
    return [_row(lf[i].numpy(), df[i].numpy(), int(xl[i]), int(xd[i]), int(lens[i]))
            for i in range(5)]


def _edge_rows():
    """An empty and a one-symbol distance tree (the seeding), a lit/len
    tree with only EOB, and a lit/len tree of one literal."""
    rng = np.random.default_rng(3)
    lits = np.zeros(NLIT, np.int64)
    lits[:256] = rng.integers(0, 40, 256)
    lits[256] = 1
    eob = np.zeros(NLIT, np.int64)
    eob[256] = 1
    one = eob.copy()
    one[65] = 500
    dist1 = np.zeros(NDIST, np.int64)
    dist1[7] = 5
    dist0 = np.zeros(NDIST, np.int64)
    dist0[0] = 9
    return [_row(lits, np.zeros(NDIST), ns=lits.sum()),
            _row(lits, dist1, 0, 5 * 2, ns=lits.sum() + 40),
            _row(lits, dist0, ns=lits.sum() + 30),
            _row(eob, np.zeros(NDIST), ns=0),
            _row(eob, np.zeros(NDIST), ns=7),
            _row(one, dist1, ns=600)]


def _fixed_rows():
    """Few tokens: a dynamic header costs more than the fixed code, and the
    fixed code less than a stored block."""
    rng = np.random.default_rng(5)
    out = []
    for t in range(ROWS):
        lit = np.zeros(NLIT, np.int64)
        lit[rng.integers(32, 127, 12 + t)] += 1
        lit[256] = 1
        dist = np.zeros(NDIST, np.int64)
        if t % 2:
            lit[257 + t] += 2
            dist[4 + t] += 2
        out.append(_row(lit, dist, 2 * (t % 2), 3 * (t % 2), ns=lit[:256].sum() + 8 * (t % 2)))
    return out


def _stored_rows():
    """Random bytes: near-uniform literals, so a stored block is cheapest
    (and the fill loop does not converge)."""
    rng = np.random.default_rng(7)
    out = []
    for t in range(ROWS):
        n = 4000 * (t + 1)
        lit = np.zeros(NLIT, np.int64)
        lit[:256] = np.bincount(rng.integers(0, 256, n), minlength=256)
        lit[256] = 1
        out.append(_row(lit, np.zeros(NDIST), ns=n))
    return out


def _fallback_rows():
    """Histograms the fill loop cannot complete in its 64 steps, so the
    flat tree is taken: near-uniform over many symbols."""
    rng = np.random.default_rng(11)
    out = []
    for t in range(ROWS):
        nsym = [286, 270, 160, 140, 286, 180, 257, 150][t]
        lit = np.zeros(NLIT, np.int64)
        lit[rng.permutation(NLIT)[:nsym]] = rng.integers(900, 1000, nsym)
        lit[256] = max(lit[256], 1)
        dist = rng.integers(400, 420, NDIST) if t % 2 else np.zeros(NDIST, np.int64)
        out.append(_row(lit, dist, 100, 300, ns=lit.sum() * (t + 1)))
    return out


def _inexact_rows():
    """Flat-tree rows whose float32 keys are inexact (frequencies past
    58,660) with ties among them, so the ranks rest on the key's rounding
    and the stable order."""
    rng = np.random.default_rng(13)
    out = []
    for t in range(ROWS):
        lit = rng.integers(INEXACT_FREQ, INEXACT_FREQ + 6 + 10 * t, NLIT)
        lit[rng.permutation(NLIT)[:10 + t]] = 0
        lit[256] = 1 + t
        out.append(_row(lit, rng.integers(0, 50, NDIST), 7, 9, ns=lit.sum() // 3))
    return out


SETS = {"real": _real_rows, "edge": _edge_rows, "fixed": _fixed_rows,
        "stored": _stored_rows, "fallback": _fallback_rows, "inexact": _inexact_rows}


def _torch_inputs(arrays, device="cpu"):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


@functools.lru_cache(maxsize=1)
def _reference():
    import jax

    from compu_tpu.kernels import deflate_jax_v3

    return jax.jit(jax.vmap(deflate_jax_v3._build_tables))


def _kraft_complete(lengths, cap):
    units = np.where(lengths > 0, (1 << cap) >> np.minimum(lengths, cap), 0)
    return units.sum(-1) == 1 << cap


@pytest.mark.parametrize("name", list(SETS))
def test_build_tables_equals_reference(jax_cpu, name):
    import jax.numpy as jnp

    arrays = _stack(SETS[name]())
    ref = _reference()(*(jnp.asarray(a.astype(np.int32)) for a in arrays))
    port = _build_tables(*_torch_inputs(arrays))
    assert set(port) == set(KEYS)
    for key in KEYS:
        want = np.asarray(ref[key]).astype(np.int64)
        got = port[key].numpy().astype(np.int64)
        assert got.shape == want.shape, key
        bad = np.flatnonzero((got != want).reshape(len(got), -1).any(-1))
        assert bad.size == 0, f"{name}: {key} differs in rows {bad.tolist()}"


def test_sets_exercise_their_branches():
    """Each set takes the branch it is named for: the fixed rows choose the
    fixed code, the stored rows a stored block, and the fallback, stored
    and inexact rows the flat tree (the loops alone, with the fallback
    turned off, leave an incomplete code; the result is complete)."""
    for name, want_dyn, want_stored in (("fixed", False, False), ("stored", None, True)):
        arrays = _stack(SETS[name]())
        out = bt.build_tables_torch(*_torch_inputs(arrays))
        assert bool(out["use_stored"].all()) is want_stored, name
        if want_dyn is not None:
            assert not bool((out["hdr_bits"][:, 0] == 17).any()), name
    real = bt.build_tables_torch(*_torch_inputs(_stack(_real_rows())))
    assert bool((real["hdr_bits"][:, 0] == 17).any())  # some real block is dynamic
    for name in ("fallback", "stored", "inexact"):
        lit, dist, *_ = _torch_inputs(_stack(SETS[name]()))
        lit, _ = bt.seed_histograms(lit, dist)
        loops = bt.length_loops(lit, bt.CAPBITS)[0].numpy()
        final = bt.build_lengths(lit, bt.CAPBITS).numpy()
        assert not _kraft_complete(loops, bt.CAPBITS).any(), name
        assert _kraft_complete(final, bt.CAPBITS).all(), name


def test_inexact_rows_have_inexact_tied_keys():
    lit = _stack(_inexact_rows())[0]
    used = lit > 0
    key = (np.where(used, -lit, 1).astype(np.float32) * np.float32(NLIT)
           + np.arange(NLIT, dtype=np.float32))
    exact = np.where(used, -lit, 1) * NLIT + np.arange(NLIT)
    assert (key.astype(np.int64) != exact)[used].any()
    for row in key:
        assert len(np.unique(row)) < NLIT  # ties among the rounded keys


def test_start_tables_equal_the_formula(jax_cpu):
    """The code-length tree's start-length table and the flat-tree depth
    table equal the direct formula at every entry: the port's float32
    log(x) / log(2), one entry at a time, and the reference's jnp.log2."""
    import jax.numpy as jnp

    cl = bt.tables.on_device("cl_start_len", torch.device("cpu"))
    assert cl.shape == (2, bt.NLENS + 2) and cl.dtype == torch.int32
    for t in range(2):
        for f in range(bt.NLENS + 2):
            one = bt._start_exponents(torch.tensor([f]), torch.tensor(bt.NLENS + t))
            assert int(cl[t, f]) == int(one), (t, f)
        p = jnp.arange(bt.NLENS + 2, dtype=jnp.float32) / jnp.float32(bt.NLENS + t)
        ref = jnp.ceil(-jnp.log2(jnp.maximum(p, 2.0 ** -30))).astype(jnp.int32)
        assert np.array_equal(np.asarray(ref), cl[t].numpy())
    k = bt.tables.on_device("flat_k", torch.device("cpu"))
    assert k.shape == (NLIT + 1,) and k.dtype == torch.int32
    for n in range(NLIT + 1):
        assert int(k[n]) == int(bt._flat_depth(torch.tensor([n]))), n
    ref = jnp.ceil(jnp.log2(jnp.maximum(jnp.arange(NLIT + 1).astype(jnp.float32), 2.0)))
    assert np.array_equal(np.asarray(ref).astype(np.int32), k.numpy())


def _start_lengths_by_thresholds(freq: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Kernel P5's rule in torch: float32 p = freq / max(total, 1), and a
    used symbol starts at 1 + the count of thresholds above p."""
    total = freq.sum(-1, keepdim=True)
    p = freq.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32)
    count = (p[..., None] < thresholds).sum(-1)
    return torch.where(freq > 0, 1 + count, 0)


def _seeded_trees(device="cpu"):
    """Every seeded lit/len and distance histogram of the sets and of the
    2,000 random rows, one (B, A) tensor a tree and set."""
    arrays = [_stack(fn()) for fn in SETS.values()] + [_random_rows(2000, seed=16)]
    out = []
    for lit, dist, *_ in arrays:
        lf, df = bt.seed_histograms(torch.from_numpy(lit).to(device),
                                    torch.from_numpy(dist).to(device))
        out += [lf, df]
    return out


def test_start_thresholds_reproduce_start_lengths():
    """The thresholds, computed on the CPU over every float32 of [2^-12, 1]
    with the plain version's ops, give every used symbol of the sets and of
    the random rows the plain version's start length: the kernel's rule
    (float32 division and a count of thresholds) equals ``start_lengths``
    exactly, the clamps included."""
    t = bt._start_threshold_table(torch.device("cpu"))
    assert t.shape == (bt.CAPBITS - 1,) and t.dtype == torch.float32
    assert bool((t[1:] < t[:-1]).all()) and float(t[-1]) >= 2.0 ** -12 and float(t[0]) <= 1.0
    assert torch.equal(t, bt.tables.on_device("start_thresholds", torch.device("cpu")))
    lengths = set()
    for freq in _seeded_trees():
        want = bt.start_lengths(freq, bt.CAPBITS)
        assert torch.equal(_start_lengths_by_thresholds(freq, t), want)
        lengths |= set(want[freq > 0].tolist())
    assert lengths == set(range(1, bt.CAPBITS + 1))  # every length, both clamps among them


def test_midpoint_rule_equals_the_division():
    """Kernel P5 takes no division: float32 fl(f / T) < t_k exactly when
    f - m_k * T < 0, or = 0 with the float below t_k even, where m_k is
    the midpoint of t_k and the float below it (m_k * T is exact in
    float64). That rule gives every used symbol of the sets and the random
    rows the same count as float32 division does."""
    t = bt.tables.on_device("start_thresholds", torch.device("cpu")).numpy()
    below = t.view(np.uint32) - np.uint32(1)
    mid = (below.view(np.float32).astype(np.float64) + t.astype(np.float64)) * 0.5
    even = (below & 1) == 0
    for freq in _seeded_trees():
        f = freq.numpy()
        total = np.maximum(f.sum(-1, keepdims=True), 1).astype(np.float32).astype(np.float64)
        d = f.astype(np.float32).astype(np.float64)[..., None] - mid * total[..., None]
        count = ((d < 0) | ((d == 0) & even)).sum(-1)
        p = f.astype(np.float32) / total.astype(np.float32)
        assert np.array_equal(np.where(f > 0, 1 + count, 0),
                              np.where(f > 0, 1 + (p[..., None] < t).sum(-1), 0))


def test_start_threshold_check_raises_on_a_rising_formula():
    """A formula whose exponent rises with p somewhere in [2^-12, 1] has
    no threshold table: the build raises and keeps no fallback."""
    def rising(p):
        return torch.ceil(-bt._log2_f32(p)) + (torch.sin(p * 5000.0) > 0).to(torch.float32)

    with pytest.raises(ValueError, match="rise with p"):
        bt._start_threshold_table(torch.device("cpu"), exponents=rising)


def test_exponent_shift_key_equals_the_division():
    """The fill key: float32 freq with its exponent lowered by 12 - l is,
    bit for bit, float32 freq / 2^(12 - l), for every l in 1..12, each
    frequency 1..2^20, and samples up to 2^31 (whose floats round)."""
    rng = np.random.default_rng(31)
    freq = np.concatenate([np.arange(1, (1 << 20) + 1),
                           rng.integers(1 << 20, 1 << 31, 1 << 18),
                           [(1 << 24) + 1, 286 * INEXACT_FREQ, (1 << 31) - 1]])
    freq_f = freq.astype(np.float32)
    bits = freq_f.view(np.uint32)
    for length in range(1, bt.CAPBITS + 1):
        shift = bt.CAPBITS - length
        want = (freq_f / np.float32(1 << shift)).view(np.uint32)
        assert np.array_equal(bits - np.uint32(shift << 23), want), length


@pytest.mark.parametrize("cap, nsym", [(bt.CAPBITS, NLIT), (bt.CAPBITS, NDIST), (bt.CLCAP, bt.NCL)])
def test_lengthening_key_orders_as_the_argmax(cap, nsym):
    """The lengthening key (cand ? (cap - l + 1) << 9 : 0) | (511 - index):
    its largest names the plain version's argmax of the units (lowest index
    first, symbol 0 when no candidate qualifies), and the Kraft sum's
    change follows from it alone (a used symbol is never of length 0)."""
    rng = np.random.default_rng(cap * 1000 + nsym)
    rows = 4000
    used = rng.random((rows, nsym)) < rng.random((rows, 1))
    used[:200] = False  # no candidate: all unused ...
    length = rng.integers(0, cap + 2, (rows, nsym))
    length[200:400] = np.where(rng.random((200, nsym)) < 0.5, cap, cap + 1)  # ... or all at cap+
    used[200:400] = True
    length[400:800] = rng.integers(1, 3, (400, nsym))  # ties among few lengths
    length = np.where(used, np.maximum(length, 1), length)  # a used symbol starts at 1 or more
    cand = used & (length > 0) & (length < cap)
    units = np.where(used & (length > 0), (1 << cap) >> np.minimum(length, cap), 0)
    want = np.argmax(np.where(cand, units, -1), axis=-1)
    key = np.where(cand, (cap - length + 1) << 9, 0) | (511 - np.arange(nsym))
    top = key.max(-1)
    assert np.array_equal(511 - (top & 511), want)
    assert not cand[:400].any() and (want[:400] == 0).all()
    rows_ = np.arange(rows)
    after = length.copy()
    after[rows_, want] += 1
    units_after = np.where(used & (after > 0), (1 << cap) >> np.minimum(after, cap), 0)
    lw = cap + 1 - (top >> 9)
    delta = np.where(top >= 512, -(((1 << cap) >> np.clip(lw, 0, cap)) >> 1), 0)
    assert np.array_equal(units_after.sum(-1) - units.sum(-1), delta)


def test_build_tables_dispatch():
    arrays = _torch_inputs(_stack(_edge_rows()))
    out = bt.build_tables(*arrays)
    want = bt.build_tables_torch(*arrays)
    assert all(torch.equal(out[k], want[k]) for k in KEYS)
    with pytest.raises(ValueError, match="no build_tables"):
        bt.build_tables(*(a.to("meta") for a in arrays))


# ---------------------------------------------------------------------------
# On the card: P5 against its plain version
# ---------------------------------------------------------------------------

def _random_rows(count: int, seed: int):
    """``count`` rows of every kind the encode meets and some it does not:
    sparse and dense, skewed and flat lit/len histograms (some past the
    flat key's exact range), empty to full distance trees, and block
    lengths from 0 to 2^18."""
    rng = np.random.default_rng(seed)
    lit = np.zeros((count, NLIT), np.int64)
    dist = np.zeros((count, NDIST), np.int64)
    for r in range(count):
        kind = r % 5
        nsym = int(rng.integers(1, NLIT + 1))
        syms = rng.permutation(NLIT)[:nsym]
        if kind == 0:
            lit[r, syms] = rng.integers(1, 4, nsym)
        elif kind == 1:
            lit[r, syms] = rng.integers(500, 520, nsym)
        elif kind == 2:
            lit[r, syms] = rng.multinomial(int(rng.integers(1, 1 << 18)),
                                           rng.dirichlet(np.full(nsym, 0.3)))
        elif kind == 3:
            lit[r, syms] = rng.integers(INEXACT_FREQ, INEXACT_FREQ + 20, nsym)
        else:
            lit[r, syms] = (rng.pareto(1.2, nsym) * 50).astype(np.int64)
        lit[r, 256] += 1
        ndist = int(rng.integers(0, NDIST + 1))
        dist[r, rng.permutation(NDIST)[:ndist]] = rng.integers(0, 3000, ndist)
    xl = rng.integers(0, 1 << 16, count)
    xd = rng.integers(0, 1 << 18, count)
    ns = rng.integers(0, (1 << 18) + 1, count)
    return lit, dist, xl, xd, ns


def _assert_kernel_equals_plain(arrays, device):
    inputs = _torch_inputs(arrays, device)
    got = bt.build_tables_cuda(*inputs)
    want = bt.build_tables_torch(*inputs)
    torch.cuda.synchronize()
    for key in KEYS:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        bad = (got[key] != want[key]).reshape(len(got[key]), -1).any(-1).nonzero().flatten()
        assert bad.numel() == 0, f"{key} differs in rows {bad.tolist()[:10]}"


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SETS))
def test_p5_equals_plain_gpu(cuda, name):
    _assert_kernel_equals_plain(_stack(SETS[name]()), cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [16, 64])
def test_p5_equals_plain_random_gpu(cuda, B):
    lit, dist, xl, xd, ns = _random_rows(2000, seed=B)
    for at in range(0, 2000, B):
        cut = slice(at, at + B)
        _assert_kernel_equals_plain((lit[cut], dist[cut], xl[cut], xd[cut], ns[cut]), cuda)


@pytest.mark.gpu
def test_p5_one_launch_a_batch_gpu(cuda):
    """One P5 launch an encode_blocks_dyn batch, and the whole
    build_tables_cuda call is that one CUDA kernel under torch.profiler:
    no torch op runs on the card before it (the tables are built once a
    device, by the warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    N = 1 << 15
    blocks = torch.from_numpy(rng.integers(0, 8, (4, N), dtype=np.uint8)).to(cuda)
    lens = torch.full((4,), N, dtype=torch.int32, device=cuda)
    encode_blocks_dyn(blocks, lens)  # the build, outside the count
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    encode_blocks_dyn(blocks, lens)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["build_tables"] == 1
    inputs = _torch_inputs(_stack(_real_rows()), cuda)
    bt.build_tables_cuda(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        bt.build_tables_cuda(*inputs)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not (getattr(e, "is_user_annotation", False)
                        or getattr(e, "activity_type", None) == "gpu_user_annotation")]
    assert len(on_card) == 1 and "build_tables_kernel" in on_card[0], on_card


@pytest.mark.gpu
def test_start_thresholds_on_the_card_gpu(cuda):
    """The card's thresholds pass the build's check there, and with the
    kernel's rule they give every used symbol of the sets and the random
    rows the plain version's start length on the card."""
    t = bt._start_threshold_table(cuda)
    assert torch.equal(t, bt.tables.on_device("start_thresholds", cuda))
    for freq in _seeded_trees(cuda):
        assert torch.equal(_start_lengths_by_thresholds(freq, t),
                           bt.start_lengths(freq, bt.CAPBITS))
