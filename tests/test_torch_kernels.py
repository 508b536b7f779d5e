"""The PyTorch port's kernel stages against the JAX reference, on the CPU.

Every stage is integer or exact float work, so each comparison is exact
equality (tolerance 0). Inputs are numpy arrays made from fixed seeds and
handed to both packages. On the CPU the reference runs the XLA twins of its
Pallas kernels (``lcp_candidates_xla``, ``parse_cover_mxu``,
``emit_pack_xla``) and the port runs its plain twins; the tests marked
``gpu`` hold the CUDA kernels to those twins on the card.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.kernels import tables, u32
from compu_tpu_torch.kernels.build_tables import build_tables_cuda
from compu_tpu_torch.kernels.emit_pack import emit_pack_cuda, emit_pack_torch
from compu_tpu_torch.kernels.lcp_match import (
    lcp_candidates_cuda,
    lcp_candidates_torch,
    sort_stage_lex,
)
from compu_tpu_torch.kernels.parse_cover import (
    jump_targets,
    parse_cover_cuda,
    parse_cover_steps_torch,
    parse_cover_torch,
)

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
N_SMALL = 1 << 13


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocks(N=N_SMALL):
    """Three blocks: text, a repeated half (long matches), dense low-entropy
    bytes (deep candidate lists); the last one is short."""
    rng = np.random.default_rng(11)
    blocks = np.zeros((3, N), np.uint8)
    blocks[0] = np.frombuffer(TEXT[:N], np.uint8)
    blocks[1] = np.frombuffer((TEXT[500:500 + N // 2] * 2)[:N], np.uint8)
    blocks[2, : N - 1000] = rng.integers(0, 6, N - 1000, dtype=np.uint8)
    lens = np.array([N, N, N - 1000], np.int32)
    return blocks, lens


# (wcap, keys, stride) of levels 1 (also 2-3), 4, 6 (also 5, 7-9), and the
# device stream's defaults.
SORT_CONFIGS = [(8, 1, 2), (16, 1, 1), (16, 2, 1), (32, 2, 1)]


# ---------------------------------------------------------------------------
# Carry-across: the constant tables
# ---------------------------------------------------------------------------

def _ref_table(name):
    from compu_tpu.kernels import checksum_jax, deflate_jax, deflate_jax_v2, deflate_jax_v3

    return {
        "fixed_lit": (deflate_jax_v3._FIXED_LIT_LEN_NP, tables.FIXED_LIT_LEN_NP),
        "fixed_dist": (deflate_jax_v3._FIXED_DIST_LEN_NP, tables.FIXED_DIST_LEN_NP),
        "cl_order": (deflate_jax_v3.CL_ORDER, tables.CL_ORDER),
        "adler_mod": (np.asarray(deflate_jax.ADLER_MOD), np.asarray(tables.ADLER_MOD)),
        "crc_bits_32": (checksum_jax._crc_bit_matrix(32), tables.crc_bit_matrix(32)),
        "crc_bits_256": (checksum_jax._crc_bit_matrix(256), tables.crc_bit_matrix(256)),
        "crc_fold_32": (deflate_jax_v2._crc_fold_mats(32, 10), tables.crc_fold_mats(32, 10)),
        "crc_fold_256": (deflate_jax_v2._crc_fold_mats(256, 10), tables.crc_fold_mats(256, 10)),
    }[name]


@pytest.mark.parametrize("name", ["fixed_lit", "fixed_dist", "cl_order", "adler_mod",
                                  "crc_bits_32", "crc_bits_256", "crc_fold_32",
                                  "crc_fold_256"])
def test_tables_equal_reference(jax_cpu, name):
    ref, port = _ref_table(name)
    assert ref.dtype == port.dtype and ref.shape == port.shape
    assert np.array_equal(ref, port)
    moved = tables.to_torch({"t": port}, "cpu")["t"]
    assert np.array_equal(moved.numpy(), port)


def test_u32_bit_patterns():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF], np.int64)
    bits = u32.to_i32_bits(torch.from_numpy(vals))
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), vals.astype(np.uint32))
    assert np.array_equal(u32.from_i32_bits(bits).numpy(), vals)


# ---------------------------------------------------------------------------
# Sort stage and B1 (LCP candidates)
# ---------------------------------------------------------------------------

def _ref_sorted(jax_cpu, blocks, lens, wcap, keys, stride):
    import jax.numpy as jnp

    from compu_tpu.kernels.lcp_match import sort_stage_lex as ref_sort

    fn = functools.partial(ref_sort, wcap=wcap, keys=keys, stride=stride)
    return [np.asarray(x) for x in jax_cpu.vmap(fn)(jnp.asarray(blocks), jnp.asarray(lens))]


@pytest.mark.parametrize("wcap,keys,stride", SORT_CONFIGS)
def test_sort_stage_lex_matches_reference(jax_cpu, wcap, keys, stride):
    blocks, lens = _blocks()
    ref = _ref_sorted(jax_cpu, blocks, lens, wcap, keys, stride)
    port = sort_stage_lex(torch.from_numpy(blocks), wcap=wcap, keys=keys, stride=stride)
    assert len(ref) == len(port) == wcap // 4 + 1
    for r, p in zip(ref, port):
        assert np.array_equal(r.astype(np.int64), p.numpy())


@pytest.mark.parametrize("wcap,keys,stride,depth", [(8, 1, 2, 4), (16, 2, 1, 16),
                                                    (16, 2, 1, 48), (32, 2, 1, 8)])
def test_lcp_twin_matches_xla(jax_cpu, wcap, keys, stride, depth):
    import jax.numpy as jnp

    from compu_tpu.kernels.lcp_match import lcp_candidates_xla

    blocks, lens = _blocks()
    ref_ops = _ref_sorted(jax_cpu, blocks, lens, wcap, keys, stride)
    be = N_SMALL // stride
    rl, rd = lcp_candidates_xla(tuple(jnp.asarray(x.reshape(-1)) for x in ref_ops),
                                depth=depth, max_dist=32768, block_elems=be)
    *wbe, ps = sort_stage_lex(torch.from_numpy(blocks), wcap=wcap, keys=keys, stride=stride)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    pl, pd = lcp_candidates_torch(words, ps.reshape(-1).to(torch.int32), depth=depth,
                                  max_dist=32768, block_elems=be)
    assert np.array_equal(np.asarray(rl), pl.numpy())
    assert np.array_equal(np.asarray(rd), pd.numpy())
    assert (pl.numpy() > 0).mean() > 0.2  # the inputs exercise real matches


def test_kernel_wrappers_refuse_cpu_tensors():
    ps = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lcp_candidates_cuda(torch.zeros(2, 256, dtype=torch.int32), ps, depth=4,
                            max_dist=32768, block_elems=256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        parse_cover_cuda(torch.ones(256, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        emit_pack_cuda(ps.reshape(1, 256), ps.reshape(1, 256))
    z = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        build_tables_cuda(torch.ones(2, tables.NLIT, dtype=torch.int64),
                          torch.ones(2, tables.NDIST, dtype=torch.int64), z, z, z)


# ---------------------------------------------------------------------------
# B2 (greedy cover)
# ---------------------------------------------------------------------------

def _steps(S, seed):
    """Advances of the kind the parser gives: literals (1), matches of
    3..258 clipped at the segment end, and junk (<= 0) read as 1."""
    rng = np.random.default_rng(seed)
    N = S * 128
    step = np.where(rng.random(N) < 0.5, 1, rng.integers(3, 259, N))
    step[rng.random(N) < 0.05] = rng.integers(-3, 1)
    seg_rem = 128 - (np.arange(N) & 127)
    return np.minimum(step, seg_rem).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parse_cover_twin_matches_mxu(jax_cpu, seed):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import parse_cover_mxu

    step = _steps(48, seed)
    ref = np.asarray(parse_cover_mxu(jnp.asarray(step), 128))
    nl = jump_targets(torch.from_numpy(step))
    port = parse_cover_torch(nl).reshape(-1).numpy() > 0
    assert np.array_equal(ref, port)


def _walk(nl):
    """The kernel's algorithm, in Python: mark the orbit of 0."""
    mask = np.zeros_like(nl)
    for s in range(nl.shape[0]):
        i = 0
        while i < nl.shape[1]:
            mask[s, i] = 1
            i = nl[s, i]
    return mask


def test_parse_cover_twin_matches_orbit_walk():
    nl = jump_targets(torch.from_numpy(_steps(32, 5)))
    assert np.array_equal(parse_cover_torch(nl).numpy(), _walk(nl.numpy()))


# ---------------------------------------------------------------------------
# B3 (emit pack)
# ---------------------------------------------------------------------------

def _emit_inputs(S, seed):
    """Byte positions over the whole row (so bytes fall off its end) and
    u32 fields covering values >= 2^31, overlapping freely (sums > 255)."""
    rng = np.random.default_rng(seed)
    bytep = rng.integers(0, 512, (S, 256)).astype(np.int32)
    shifted = rng.integers(0, 1 << 32, (S, 256), dtype=np.uint64).astype(np.uint32)
    shifted[:, :4] = [0xFFFFFFFF, 0x80000000, 0xDEADBEEF, 0]
    shifted[rng.random((S, 256)) < 0.3] = 0
    return bytep, shifted


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_twin_matches_xla(jax_cpu, seed):
    import jax.numpy as jnp

    from compu_tpu.kernels.emit_pallas import emit_pack_xla, rows_from_tiles

    bytep, shifted = _emit_inputs(24, seed)
    ref = np.asarray(rows_from_tiles(emit_pack_xla(jnp.asarray(bytep), jnp.asarray(shifted))))
    bits = u32.to_i32_bits(torch.from_numpy(shifted.astype(np.int64)))
    port = emit_pack_torch(torch.from_numpy(bytep), bits)
    assert port.dtype == torch.int32 and port.shape == (24, 512)
    assert np.array_equal(ref, port.numpy())
    assert ref.max() > 255  # overlapping fields: the sum, not an OR


# ---------------------------------------------------------------------------
# Huffman construction and the block CRC
# ---------------------------------------------------------------------------

def _histograms(A, count, seed):
    """Random histograms: sparse and dense, small and ~2^18 totals, and
    power-of-two counts (exact -log2 p), each with >= 2 used symbols."""
    rng = np.random.default_rng(seed)
    out = np.zeros((count, A), np.int32)
    for t in range(count):
        used = int(rng.integers(2, A + 1))
        kind = t % 4
        if kind == 0:
            f = rng.integers(0, 1000, A)
        elif kind == 1:
            f = rng.geometric(0.02, A) * rng.integers(0, 2, A)
        elif kind == 2:
            f = 1 << rng.integers(0, 12, A)
        else:
            f = rng.multinomial(1 << 18, rng.dirichlet(np.full(A, 0.3)))
        f[used:] = 0
        if (f > 0).sum() < 2:
            f[:2] = [3, 1]
        out[t] = f
    return out


@pytest.mark.parametrize("A,cap", [(286, 12), (30, 12), (19, 7)])
def test_build_lengths_sweep(jax_cpu, A, cap):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v3 import build_lengths as ref_build
    from compu_tpu_torch.kernels.deflate_v3 import build_lengths

    freqs = _histograms(A, 20, seed=A)
    ref = np.asarray(jax_cpu.vmap(lambda f: ref_build(f, cap))(jnp.asarray(freqs)))
    port = build_lengths(torch.from_numpy(freqs), cap).numpy()
    assert np.array_equal(ref, port)


def test_canonical_codes_match_reference(jax_cpu):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v3 import canonical_codes as ref_codes
    from compu_tpu_torch.kernels.deflate_v3 import build_lengths, canonical_codes

    lens = build_lengths(torch.from_numpy(_histograms(286, 8, seed=3)), 12)
    fixed288 = np.concatenate([tables.FIXED_LIT_LEN_NP, [8, 8]])
    for row in [*lens.numpy(), fixed288]:
        ref = np.asarray(ref_codes(jnp.asarray(row.astype(np.int32)), 15))
        port = canonical_codes(torch.from_numpy(row[None].astype(np.int64)), 15)[0]
        assert np.array_equal(ref.astype(np.int64), port.numpy())


@pytest.mark.parametrize("N", [1 << 15, 1 << 18])
def test_crc_register_matches_reference(jax_cpu, N):
    import jax.numpy as jnp

    from compu_tpu.kernels.checksum_jax import crc32_lane_registers as ref_lanes
    from compu_tpu.kernels.deflate_jax_v2 import _device_crc_register
    from compu_tpu_torch.kernels.checksum import crc32_lane_registers, device_crc_register

    rng = np.random.default_rng(N)
    blocks = rng.integers(0, 256, (2, N), dtype=np.uint8)
    port = device_crc_register(torch.from_numpy(blocks)).numpy()
    port_lanes = crc32_lane_registers(torch.from_numpy(blocks), lanes=1024).numpy()
    for b in range(2):
        ref = int(_device_crc_register(jnp.asarray(blocks[b])))
        assert int(port[b]) == ref
        lanes = np.asarray(ref_lanes(jnp.asarray(blocks[b]), lanes=1024))
        assert np.array_equal(lanes.astype(np.int64), port_lanes[b])


# ---------------------------------------------------------------------------
# The whole LZ stage, across the device ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", range(1, 10))
def test_match_and_parse_matches_reference(jax_cpu, level):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import match_and_parse_batch as ref_mp
    from compu_tpu_torch.kernels.block_codec import DEV_DEPTH, DEV_KEYS, DEV_STRIDE, DEV_WCAP
    from compu_tpu_torch.kernels.deflate_v2 import match_and_parse_batch

    cfg = dict(depth=DEV_DEPTH[level], wcap=DEV_WCAP[level], stride=DEV_STRIDE[level],
               lex_keys=DEV_KEYS[level])
    blocks, lens = _blocks()
    ref = ref_mp(jnp.asarray(blocks), jnp.asarray(lens), **cfg)
    port = match_and_parse_batch(torch.from_numpy(blocks), torch.from_numpy(lens), **cfg)
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r), p.numpy().astype(np.asarray(r).dtype))


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_lcp_kernel_matches_twin_gpu(cuda):
    for wcap, keys, stride in SORT_CONFIGS:
        blocks, _ = _blocks()
        *wbe, ps = sort_stage_lex(torch.from_numpy(blocks).to(cuda), wcap=wcap,
                                  keys=keys, stride=stride)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe])).contiguous()
        ps = ps.reshape(-1).to(torch.int32).contiguous()
        for depth in (4, 16, 48):
            kw = dict(depth=depth, max_dist=32768, block_elems=N_SMALL // stride)
            k = lcp_candidates_cuda(words, ps, **kw)
            t = lcp_candidates_torch(words, ps, **kw)
            assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1])


@pytest.mark.gpu
def test_parse_cover_kernel_matches_twin_gpu(cuda):
    step = torch.from_numpy(_steps(300, 9).astype(np.int64)).to(cuda)
    assert torch.equal(parse_cover_cuda(step), parse_cover_steps_torch(step))


@pytest.mark.gpu
def test_emit_kernel_matches_twin_gpu(cuda):
    bytep, shifted = _emit_inputs(300, 4)
    bytep = torch.from_numpy(bytep).to(cuda)
    bits = u32.to_i32_bits(torch.from_numpy(shifted.astype(np.int64))).to(cuda)
    assert torch.equal(emit_pack_cuda(bytep, bits), emit_pack_torch(bytep, bits))


# The redesigned B1 at every depth it compiles for (the level ladder's, as
# template instances) and at depths it walks with a runtime count.
LCP_GPU_DEPTHS = sorted({4, 6, 8, 12, 16, 24, 32, 48, 1, 5, 127})


def _lcp_case(cuda, wcap, keys, stride, depth, block_elems=None, offset=0):
    """Kernel against twin on sorted text, repeated and low-entropy blocks.
    ``block_elems`` smaller than the sort blocks puts many block edges in
    reach of the depth; ``offset`` > 0 hands the kernel inputs that are not
    16-byte aligned (its scalar staging path)."""
    blocks, _ = _blocks()
    *wbe, ps = sort_stage_lex(torch.from_numpy(blocks).to(cuda), wcap=wcap,
                              keys=keys, stride=stride)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    ps = ps.reshape(-1).to(torch.int32)
    if offset:
        W, n = words.shape
        wbuf = torch.zeros(W * n + offset, dtype=torch.int32, device=cuda)
        wbuf[offset:] = words.reshape(-1)
        words = wbuf[offset:].view(W, n)
        pbuf = torch.zeros(n + offset, dtype=torch.int32, device=cuda)
        pbuf[offset:] = ps
        ps = pbuf[offset:]
    kw = dict(depth=depth, max_dist=32768,
              block_elems=block_elems or N_SMALL // stride)
    k = lcp_candidates_cuda(words, ps, **kw)
    t = lcp_candidates_torch(words, ps, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]), kw


@pytest.mark.gpu
@pytest.mark.parametrize("depth", LCP_GPU_DEPTHS)
def test_lcp_kernel_every_depth_gpu(cuda, depth):
    for wcap, keys, stride in SORT_CONFIGS:
        _lcp_case(cuda, wcap, keys, stride, depth)
    # Blocks of 64 and 256 lanes: most lanes lie within depth of an edge.
    _lcp_case(cuda, 16, 2, 1, depth, block_elems=64)
    _lcp_case(cuda, 8, 1, 2, depth, block_elems=256)
    _lcp_case(cuda, 16, 2, 1, depth, offset=1)


@pytest.mark.gpu
def test_lcp_kernel_odd_lane_counts_gpu(cuda):
    """n not a multiple of 4 (blocks of 1 and 2 lanes), and a tiny
    max_dist: the kernel still equals the twin."""
    rng = np.random.default_rng(5)
    for n, be in ((6, 2), (7, 1), (1030, 2)):
        words = torch.from_numpy(rng.integers(-4, 4, (3, n)).astype(np.int32)).to(cuda)
        ps = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
        for max_dist in (1, 3, 32768):
            kw = dict(depth=5, max_dist=max_dist, block_elems=be)
            k = lcp_candidates_cuda(words, ps, **kw)
            t = lcp_candidates_torch(words, ps, **kw)
            assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]), (n, kw)


def _emit_case(cuda, S, F, seed, lo=-8, hi=520, offset=0):
    """Random overlapping fields with byte positions in [lo, hi): fields
    outside [0, 512) are dropped, bytes past 512 fall off the row."""
    rng = np.random.default_rng(seed)
    bytep = rng.integers(lo, hi, (S, F)).astype(np.int32)
    shifted = rng.integers(0, 1 << 32, (S, F), dtype=np.uint64).astype(np.int64)
    shifted[rng.random((S, F)) < 0.2] = 0
    p = torch.from_numpy(bytep).to(cuda)
    v = u32.to_i32_bits(torch.from_numpy(shifted)).to(cuda)
    if offset:
        pbuf = torch.zeros(S * F + offset, dtype=torch.int32, device=cuda)
        vbuf = torch.zeros_like(pbuf)
        pbuf[offset:] = p.reshape(-1)
        vbuf[offset:] = v.reshape(-1)
        p, v = pbuf[offset:].view(S, F), vbuf[offset:].view(S, F)
    got = emit_pack_cuda(p, v)
    want = emit_pack_torch(p, v)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (S, F, seed, offset)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("F", [256, 255, 130, 7, 4, 1])
def test_emit_kernel_random_fields_gpu(cuda, F):
    want = _emit_case(cuda, 301, F, seed=F)
    if F >= 130:
        assert int(want.max()) > 255  # overlapping fields sum
    _emit_case(cuda, 301, F, seed=F + 1, offset=1)  # scalar loads only
    _emit_case(cuda, 33, F, seed=F + 2, lo=500, hi=515)  # bytes cross 512


@pytest.mark.gpu
def test_emit_kernel_dense_runs_gpu(cuda):
    """Fields packed as the emit stage packs them: nearly monotone byte
    positions, so most fields combine in registers."""
    rng = np.random.default_rng(8)
    S, F = 257, 256
    bits = rng.integers(0, 14, (S, F))
    off = np.cumsum(bits, 1) - bits
    bytep = np.clip(off >> 3, 0, 511).astype(np.int32)
    vals = rng.integers(0, 1 << 14, (S, F)) & ((1 << bits) - 1)
    shifted = ((vals << (off & 7)) & 0xFFFFFFFF).astype(np.int64)
    p = torch.from_numpy(bytep).to(cuda)
    v = u32.to_i32_bits(torch.from_numpy(shifted)).to(cuda)
    assert torch.equal(emit_pack_cuda(p, v), emit_pack_torch(p, v))
