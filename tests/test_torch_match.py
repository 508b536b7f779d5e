"""The port's hash-bucket matcher against the JAX reference, on the CPU.

Every stage is integer work, so each comparison is exact equality
(tolerance 0). Inputs are numpy arrays made from fixed seeds and handed to
both packages. On the CPU the reference runs ``_candidates_xla`` (and, where
a test asks for it, ``match_candidates_pallas`` in interpret mode); the port
runs ``match_candidates_torch``. The test marked ``gpu`` holds the CUDA
kernel to that twin on the card.
"""

import inspect
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.kernels import u32  # noqa: E402
from compu_tpu_torch.kernels.deflate_v2 import (  # noqa: E402
    HASH_MUL,
    _sort_stage,
    match_and_parse,
    match_and_parse_batch,
)
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

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
N_SMALL = 1 << 13
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


def _blocks(N=N_SMALL):
    """Three blocks: text, a repeated half (long matches), dense low-entropy
    bytes (full hash buckets); the last one is short."""
    rng = np.random.default_rng(5)
    blocks = np.zeros((3, N), np.uint8)
    blocks[0] = np.frombuffer(TEXT[:N], np.uint8)
    blocks[1] = np.frombuffer((TEXT[300:300 + N // 2] * 2)[:N], np.uint8)
    blocks[2, : N - 900] = rng.integers(0, 6, N - 900, dtype=np.uint8)
    lens = np.array([N, N, N - 900], np.int32)
    return blocks, lens


def _ref_sorted(jax, blocks, lens, wcap):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import _sort_stage as ref_sort

    ops = jax.vmap(lambda d, n: ref_sort(d, n, wcap=wcap))(jnp.asarray(blocks),
                                                           jnp.asarray(lens))
    return [np.asarray(x) for x in ops]


def _port_inputs(blocks, lens, wcap):
    """The kernel's flat inputs, as ``match_and_parse_batch`` builds them."""
    hs, ps, *sw = _sort_stage(torch.from_numpy(blocks), torch.from_numpy(lens), wcap=wcap)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in sw]))
    return hs.reshape(-1).to(torch.int32), ps.reshape(-1).to(torch.int32), words


def test_hash_multiplier_is_the_references(jax_cpu):
    from compu_tpu.kernels import deflate_jax_v2

    src = inspect.getsource(deflate_jax_v2._sort_stage)
    assert re.findall(r"v3 \* jnp\.uint32\((\d+)\)", src) == [str(HASH_MUL)]


@pytest.mark.parametrize("wcap", [16, 32])
def test_sort_stage_matches_reference(jax_cpu, wcap):
    blocks, lens = _blocks()
    ref = _ref_sorted(jax_cpu, blocks, lens, wcap)
    port = _sort_stage(torch.from_numpy(blocks), torch.from_numpy(lens), wcap=wcap)
    assert len(ref) == len(port) == wcap // 4 + 2
    for r, p in zip(ref, port):
        assert np.array_equal(r.astype(np.int64), p.numpy())


@pytest.mark.parametrize("wcap,depth", [(16, 6), (32, 16), (16, 32), (8, 1)])
def test_match_twin_matches_xla(jax_cpu, wcap, depth):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import _candidates_xla

    blocks, lens = _blocks()
    hs, ps, *sw = [jnp.asarray(x) for x in _ref_sorted(jax_cpu, blocks, lens, wcap)]
    rl, rd = jax_cpu.vmap(lambda h, p, *w: _candidates_xla(
        h, p, w, depth=depth, max_dist=MAX_DIST, wcap=wcap))(hs, ps, *sw)
    pl, pd = match_candidates_torch(*_port_inputs(blocks, lens, wcap), depth=depth,
                                    max_dist=MAX_DIST, block_elems=N_SMALL)
    assert pl.dtype == pd.dtype == torch.int32
    assert np.array_equal(np.asarray(rl).reshape(-1), pl.numpy())
    assert np.array_equal(np.asarray(rd).reshape(-1), pd.numpy())
    assert (pl.numpy() > 0).mean() > 0.2  # the inputs exercise real matches


def test_match_twin_matches_pallas_interpret(jax_cpu):
    """The reference test's case: one 8192-lane block per Pallas chunk, so
    both the block masks and the chunk halo are crossed."""
    import jax.numpy as jnp

    from compu_tpu.kernels.match_pallas import C, match_candidates_pallas

    N, wcap, depth = C, 16, 6
    rng = np.random.default_rng(7)
    blocks = np.zeros((3, N), np.uint8)
    blocks[0] = np.frombuffer(TEXT[:N], np.uint8)
    blocks[1] = np.frombuffer((TEXT[100:100 + N // 2] * 2)[:N], np.uint8)
    blocks[2] = rng.integers(0, 8, N, dtype=np.uint8)
    lens = np.full(3, N, np.int32)
    hs, ps, *sw = [jnp.asarray(x) for x in _ref_sorted(jax_cpu, blocks, lens, wcap)]
    rl, rd = match_candidates_pallas(hs.reshape(-1), ps.reshape(-1),
                                     tuple(w.reshape(-1) for w in sw), depth=depth,
                                     max_dist=MAX_DIST, block_elems=N, interpret=True)
    pl, pd = match_candidates_torch(*_port_inputs(blocks, lens, wcap), depth=depth,
                                    max_dist=MAX_DIST, block_elems=N)
    assert np.array_equal(np.asarray(rl), pl.numpy())
    assert np.array_equal(np.asarray(rd), pd.numpy())


@pytest.mark.parametrize("wcap,depth", [(32, 16), (16, 32), (16, 8)])
def test_match_and_parse_hash_matches_reference(jax_cpu, wcap, depth):
    """The whole LZ stage with the hash matcher; the reference's stride and
    lex_keys are ignored on this path, and so are the port's."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import match_and_parse_batch as ref_mp

    blocks, lens = _blocks()
    cfg = dict(depth=depth, wcap=wcap, matcher="hash")
    ref = ref_mp(jnp.asarray(blocks), jnp.asarray(lens), **cfg)
    port = match_and_parse_batch(torch.from_numpy(blocks), torch.from_numpy(lens),
                                 stride=2, lex_keys=1, **cfg)
    for r, p in zip(ref, port):
        assert np.array_equal(np.asarray(r), p.numpy().astype(np.asarray(r).dtype))


def test_match_and_parse_single_block(jax_cpu):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import match_and_parse as ref_mp

    blocks, lens = _blocks()
    for matcher in ("hash", "lex"):
        ref = ref_mp(jnp.asarray(blocks[2]), jnp.int32(lens[2]), depth=8, wcap=16,
                     matcher=matcher)
        port = match_and_parse(torch.from_numpy(blocks[2]), int(lens[2]), depth=8,
                               wcap=16, matcher=matcher)
        for r, p in zip(ref, port):
            assert np.array_equal(np.asarray(r), p.numpy().astype(np.asarray(r).dtype))


def test_unknown_matcher_raises():
    from compu_tpu_torch.kernels.deflate_v3 import encode_blocks_dyn

    blocks, lens = _blocks()
    with pytest.raises(ValueError, match="matcher"):
        match_and_parse_batch(torch.from_numpy(blocks), torch.from_numpy(lens),
                              matcher="chain")
    with pytest.raises(ValueError, match="matcher"):
        encode_blocks_dyn(torch.from_numpy(blocks), torch.from_numpy(lens), matcher="")


def test_match_kernel_wrapper_checks():
    """The wrapper refuses CPU tensors, and sizes shared memory from depth:
    no fixed halo cap, a clear error only past the card's limit."""
    z = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        match_candidates_cuda(z, z, z.reshape(1, 256), depth=4, max_dist=MAX_DIST,
                              block_elems=256)
    assert smem_bytes(8, 16) == (TILE + 16) * 10 * 4
    assert smem_bytes(8, 512) <= SMEM_LIMIT < smem_bytes(8, 6000)


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_match_kernel_matches_twin_gpu(cuda):
    """Every template instance (ladder depth x 2, 4, 8 words), the generic
    instance at depths 1, 5, 127, 200 and 1100 (its 64 KB of shared memory
    at 8 words is past the 48 KB default) and at 1, 3, 5 words, and blocks
    of 256 and 4 lanes, smaller than the kernel's 512-lane tile."""
    blocks, lens = _blocks()
    shapes = [(4 * w, d, N_SMALL) for w in TEMPLATE_WORDS for d in TEMPLATE_DEPTHS]
    shapes += [(32, d, N_SMALL) for d in (1, 5, 127, 200, 1100)]
    shapes += [(4, 16, N_SMALL), (12, 16, N_SMALL), (20, 33, N_SMALL),
               (16, 32, 256), (32, 16, 256), (16, 6, 4)]
    seen = set()
    for wcap, depth, be in shapes:
        hs, ps, words = (x.to(cuda).contiguous() for x in _port_inputs(blocks, lens, wcap))
        kw = dict(depth=depth, max_dist=MAX_DIST, block_elems=be)
        seen.add(kernel_instance(wcap // 4, depth, be))
        k = match_candidates_cuda(hs, ps, words, **kw)
        t = match_candidates_torch(hs, ps, words, **kw)
        assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]), (wcap, depth, be)
    assert len(seen) == len(TEMPLATE_DEPTHS) * len(TEMPLATE_WORDS) + 1
