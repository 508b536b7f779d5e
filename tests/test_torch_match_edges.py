"""The hash matcher's plain twin against the reference on the cases a
redesigned kernel could get wrong, and the CUDA kernel against the twin on
the same cases.

On the CPU, ``match_candidates_torch`` is held exactly (tolerance 0: all
integer work) to the reference's ``_candidates_xla``, run per block as the
reference vmaps it. Inputs are made from numpy seeds. The ``gpu`` tests
hold the CUDA kernel to the twin on each case, on every template instance,
on the generic instance, on blocks smaller than the kernel's tile and on
inputs the kernel cannot read with 16-byte loads.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.kernels import u32  # noqa: E402
from compu_tpu_torch.kernels.deflate_v2 import _sort_stage  # noqa: E402
from compu_tpu_torch.kernels.match_candidates import (  # noqa: E402
    SMEM_LIMIT,
    TEMPLATE_DEPTHS,
    TEMPLATE_WORDS,
    TILE,
    kernel_instance,
    match_candidates_cuda,
    match_candidates_torch,
    smem_bytes,
)

MAX_DIST = 32768


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _words_near(rng, base, nwords, n, p_change):
    """(nwords, n) u32 windows equal to ``base`` but for bytes changed with
    probability ``p_change`` each: long shared prefixes, ragged ends."""
    w = np.tile(np.asarray(base, np.uint64)[:nwords, None], (1, n))
    for byte in range(4):
        flip = rng.random((nwords, n)) < p_change
        val = rng.integers(0, 4, (nwords, n)).astype(np.uint64) << np.uint64(8 * byte)
        w = np.where(flip, (w & ~np.uint64(0xFF << (8 * byte))) | val, w)
    return (w & 0xFFFFFFFF).astype(np.uint32)


BASE = [0x64636261 + 0x04040404 * k for k in range(8)]


def _random_order(seed=1):
    """Hashes in random order (buckets interleaved, not sorted), positions
    unordered, so distances of both signs and out of range occur."""
    rng = np.random.default_rng(seed)
    n, be = 4 * 256, 256
    hs = rng.integers(0, 4, n).astype(np.int32)
    ps = rng.integers(0, 40000, n).astype(np.int32)
    return hs, ps, _words_near(rng, BASE, 4, n, 0.15), be, 24, MAX_DIST


def _one_bucket():
    """Blocks of one repeated byte: every lane but the tail shares one hash
    and every window equals every other, so each candidate compares all 8
    words, through the port's own sort stage."""
    blocks = np.full((2, 1024), 0x61, np.uint8)
    blocks[1, 512:] = 0x62
    hs, ps, *sw = _sort_stage(torch.from_numpy(blocks), torch.tensor([1024, 1000]), wcap=32)
    words = torch.stack([w.reshape(-1) for w in sw]).numpy().astype(np.uint32)
    return (hs.reshape(-1).numpy().astype(np.int32), ps.reshape(-1).numpy().astype(np.int32),
            words, 1024, 16, MAX_DIST)


def _ties(nwords):
    """One bucket whose windows share 2 bytes and then differ in the third
    or fourth: many candidates of each lane have the same length, so the
    nearest must win."""
    rng = np.random.default_rng(7 + nwords)
    n = 512
    w = np.full((nwords, n), 0x2A2A2A2A, np.uint32)
    w[0] = (0x00002A2A | (rng.integers(0, 2, n) << 16) | (rng.integers(0, 3, n) << 24)).astype(
        np.uint32)
    if nwords > 1:
        w[1] = (0x2A2A2A00 | rng.integers(0, 2, n)).astype(np.uint32)
    hs = np.zeros(n, np.int32)
    ps = np.arange(n, dtype=np.int32) * 3
    return hs, ps, w, n, 16, MAX_DIST


def _max_dist_edges():
    """Positions stepped so that distances of exactly max_dist and
    max_dist + 1 occur at several d."""
    rng = np.random.default_rng(11)
    n, max_dist = 1024, 100
    steps = rng.choice([1, 25, 33, 34, 50, 51, 100, 101], n)
    ps = np.cumsum(steps).astype(np.int32)
    hs = (rng.random(n) < 0.2).astype(np.int32)
    return hs, ps, _words_near(rng, BASE, 4, n, 0.05), n, 8, max_dist


def _nwords(nwords):
    rng = np.random.default_rng(20 + nwords)
    n = 2 * 512
    hs = rng.integers(0, 3, n).astype(np.int32)
    ps = np.tile(np.arange(512, dtype=np.int32), 2)
    return hs, ps, _words_near(rng, BASE, nwords, n, 0.1), 512, 12, MAX_DIST


def _block_starts(be, depth):
    """Blocks short against depth: most lanes lie within depth of a block
    start, where the candidate would cross into the previous block."""
    rng = np.random.default_rng(be + depth)
    n = 1024 if be > 2 else 250
    hs = rng.integers(0, 2, n).astype(np.int32)
    ps = (np.arange(n) % be).astype(np.int32)
    return hs, ps, _words_near(rng, BASE, 4, n, 0.1), be, depth, MAX_DIST


CASES = {
    "random_order": _random_order,
    "one_bucket": _one_bucket,
    **{f"ties_w{w}": (lambda w=w: _ties(w)) for w in (1, 2, 8)},
    "max_dist_edges": _max_dist_edges,
    **{f"nwords_{w}": (lambda w=w: _nwords(w)) for w in range(1, 9)},
    **{f"block{be}_depth{d}": (lambda be=be, d=d: _block_starts(be, d))
       for be, d in [(64, 40), (64, 16), (4, 6), (2, 3), (1, 2)]},
}


def _twin(hs, ps, words, be, depth, max_dist, device="cpu"):
    t = [torch.from_numpy(hs).to(device), torch.from_numpy(ps).to(device),
         u32.to_i32_bits(torch.from_numpy(words.astype(np.int64))).to(device)]
    return t, dict(depth=depth, max_dist=max_dist, block_elems=be)


@pytest.mark.parametrize("case", list(CASES))
def test_match_twin_equals_xla_on_edges(jax_cpu, case):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import _candidates_xla

    hs, ps, words, be, depth, max_dist = CASES[case]()
    W, n = words.shape
    args, kw = _twin(hs, ps, words, be, depth, max_dist)
    pl, pd = match_candidates_torch(*args, **kw)
    blk = lambda x: jnp.asarray(x.reshape(-1, be))  # noqa: E731
    rl, rd = jax_cpu.vmap(lambda h, p, *w: _candidates_xla(
        h, p, w, depth=depth, max_dist=max_dist, wcap=4 * W))(
            blk(hs), blk(ps), *[blk(w) for w in words])
    assert np.array_equal(np.asarray(rl).reshape(-1), pl.numpy())
    assert np.array_equal(np.asarray(rd).reshape(-1), pd.numpy())
    if be >= 4:
        assert (pl.numpy() > 0).any()  # the case finds matches


def test_match_cases_reach_what_they_name():
    """Each case exercises what its name says, on the twin's output."""
    hs, ps, words, be, depth, max_dist = CASES["one_bucket"]()
    bl, _ = match_candidates_torch(*_twin(hs, ps, words, be, depth, max_dist)[0],
                                   depth=depth, max_dist=max_dist, block_elems=be)
    assert (bl.numpy() == 32).mean() > 0.9  # all 8 words compared, all equal
    hs, ps, words, be, depth, max_dist = CASES["max_dist_edges"]()
    dist = {int(ps[i] - ps[i - d]) for d in range(1, depth + 1) for i in range(d, len(ps))}
    assert {max_dist, max_dist + 1} <= dist
    hs, ps, words, be, depth, max_dist = CASES["ties_w8"]()
    _, bd = match_candidates_torch(*_twin(hs, ps, words, be, depth, max_dist)[0],
                                   depth=depth, max_dist=max_dist, block_elems=be)
    assert (bd.numpy() > 3).mean() > 0.3  # many winners are not the nearest lane


def test_match_kernel_dispatch_table():
    """Which instance a call runs, and the shared memory it asks for."""
    for depth in TEMPLATE_DEPTHS:
        for w in TEMPLATE_WORDS:
            assert kernel_instance(w, depth, 1 << 18) == (depth, w)
            assert kernel_instance(w, depth, 4) == (depth, w)
            assert kernel_instance(w, depth, 2) == (0, 0)  # lanes of a thread split
    for w, depth in [(1, 16), (3, 16), (8, 1), (8, 5), (4, 127), (8, 1100)]:
        assert kernel_instance(w, depth, 1 << 18) == (0, 0)
    assert TILE == 512
    assert smem_bytes(8, 16) == (512 + 16) * 10 * 4
    assert smem_bytes(4, 6) == (512 + 8) * 6 * 4  # halo rounded up to 4
    assert smem_bytes(1, 5) == smem_bytes(2, 5) == (512 + 8) * 4 * 4  # two word rows
    assert smem_bytes(8, 1100) > 48 * 1024  # opts in above the default
    assert smem_bytes(8, 5296) <= SMEM_LIMIT < smem_bytes(8, 5300)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_match_kernel_edges_gpu(cuda, case):
    hs, ps, words, be, depth, max_dist = CASES[case]()
    args, kw = _twin(hs, ps, words, be, depth, max_dist, device=cuda)
    for d in sorted({depth, 4, 32, 48, 5, 127}):
        kw["depth"] = d
        k = match_candidates_cuda(*args, **kw)
        t = match_candidates_torch(*args, **kw)
        assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]), (case, d)


@pytest.mark.gpu
def test_match_kernel_unaligned_gpu(cuda):
    """Inputs at an odd offset, and lane counts not a multiple of 4: the
    kernel stages with scalar loads and stores."""
    hs, ps, words, be, depth, max_dist = CASES["random_order"]()
    args, kw = _twin(hs, ps, words, be, depth, max_dist, device=cuda)
    n = args[0].shape[0]
    shifted = [torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:] for a in args[:2]]
    wbuf = torch.zeros(args[2].numel() + 1, dtype=torch.int32, device=cuda)
    wbuf[1:] = args[2].reshape(-1)
    shifted.append(wbuf[1:].view(args[2].shape[0], n))
    for d in (16, 7):
        kw["depth"] = d
        k = match_candidates_cuda(*shifted, **kw)
        t = match_candidates_torch(*shifted, **kw)
        assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1])
    hs, ps, words, be, depth, max_dist = CASES["block2_depth3"]()
    odd = [torch.from_numpy(x[:-1].copy()).to(cuda) for x in (hs, ps)]
    odd.append(u32.to_i32_bits(torch.from_numpy(words[:, :-1].astype(np.int64))).to(cuda))
    for be_odd, d in [(1, 3), (1, 16)]:
        kw = dict(depth=d, max_dist=max_dist, block_elems=be_odd)
        k = match_candidates_cuda(*odd, **kw)
        t = match_candidates_torch(*odd, **kw)
        assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1])
