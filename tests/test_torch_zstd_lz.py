"""The port's shared LZ exports for the zstd hybrid (``device_tokens``,
``device_match_tokens``, ``DeviceTokenizer``, ``match_and_parse`` with a
``max_dist``) against the JAX reference, on the CPU.

Every output is integers, so every comparison is exact (tolerance 0). On
the CPU the reference runs the XLA forms of its Pallas kernels and the
port runs the plain versions of its CUDA kernels; the tests marked ``gpu``
hold the CUDA kernels to those plain versions at the zstd path's shape.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.formats.device_lz import DeviceTokenizer  # noqa: E402
from compu_tpu_torch.kernels import deflate_v2  # noqa: E402
from compu_tpu_torch.kernels.deflate_v2 import (  # noqa: E402
    device_match_tokens,
    device_tokens,
    match_and_parse,
)

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
BS = 1 << 14
FAR_BS = 1 << 19
FAR = FAR_BS - 4096


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these tests' large CPU ops: the suite runs
    several workers on a few cores, where spinning thread pools cost more
    than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _text(n=BS):
    return np.frombuffer(TEXT[:n], np.uint8).copy()


@functools.lru_cache(maxsize=1)
def _far_data() -> bytes:
    """tests/test_device_lz.py's far-distance case: noise with one 256-byte
    pattern repeated at distance FAR > 2^18."""
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, FAR_BS, dtype=np.uint8)
    pat = bytes(rng.integers(0, 256, 256, dtype=np.uint8))
    data = bytearray(noise.tobytes())
    data[0:256] = pat
    data[FAR:FAR + 256] = pat
    return bytes(data)


def _both(data: np.ndarray, n: int, **kw):
    """(port, reference) of device_tokens and device_match_tokens."""
    import jax.numpy as jnp

    from compu_tpu.kernels import deflate_jax_v2 as ref

    t = torch.from_numpy(data)
    port_tok = device_tokens(t, n, **{k: v for k, v in kw.items() if k != "cap"})
    port_m, port_c = device_match_tokens(t, n, **kw)
    ref_tok = ref.device_tokens(jnp.asarray(data), jnp.int32(n),
                                **{k: v for k, v in kw.items() if k != "cap"})
    ref_m, ref_c = ref.device_match_tokens(jnp.asarray(data), jnp.int32(n), **kw)
    return ((port_tok.numpy(), port_m.numpy(), int(port_c)),
            (np.asarray(ref_tok), np.asarray(ref_m), int(ref_c)))


def _assert_equal(port, ref):
    for p, r in zip(port, ref):
        assert np.array_equal(p, r)
    assert port[0].dtype == np.int32 and port[1].dtype == np.int32


@pytest.mark.parametrize("n", [BS, BS - 1000])
def test_device_tokens_equal_reference_text(jax_cpu, n):
    """alice29.txt, 16 KiB block, DEFLATE's max_dist (the default)."""
    data = _text()
    data[n:] = 0
    _assert_equal(*_both(data, n))


@pytest.mark.parametrize("max_dist", [131071, (1 << 20) - 1])
def test_device_tokens_equal_reference_far(jax_cpu, max_dist):
    """A 2^19 block whose only match lies FAR back: both exports equal the
    reference's, and the far distance survives the packing."""
    data = np.frombuffer(_far_data(), np.uint8).copy()
    port, ref = _both(data, FAR_BS, max_dist=max_dist)
    _assert_equal(port, ref)
    m = port[1][:port[2]].astype(np.int64)
    far = m[((m[:, 0] & 0xFFFFF) >= FAR) & ((m[:, 0] & 0xFFFFF) < FAR + 256)]
    want = FAR if FAR <= max_dist else None
    assert (far[:, 1].max() if len(far) else None) == want


def test_match_tokens_overflow_equals_reference(jax_cpu):
    """A cap below the match count: the rows are cut at cap, count says
    how many there were, as the reference's."""
    port, ref = _both(_text(), BS, cap=64)
    _assert_equal(port, ref)
    assert port[2] > 64


def test_tokenizer_triples_equal_reference(jax_cpu):
    from compu_tpu.formats.device_lz import DeviceTokenizer as RefTokenizer

    raw = TEXT[:BS - 321]
    port = DeviceTokenizer(BS, BS, device="cpu")(raw)
    ref = RefTokenizer(BS, BS)(raw)
    for p, r in zip(port, ref):
        assert np.array_equal(p, r)


def test_tokenizer_dense_fallback_equals_reference(jax_cpu, monkeypatch):
    """With a cap the matches overflow, both tokenizers take the dense
    per-position transfer, and their triples agree with each other and
    with the matches-only route."""
    from compu_tpu.formats.device_lz import DeviceTokenizer as RefTokenizer
    from compu_tpu.kernels import deflate_jax_v2 as ref

    raw = TEXT[:BS]
    sparse = DeviceTokenizer(BS, BS, device="cpu")(raw)
    monkeypatch.setattr(deflate_v2, "device_match_tokens",
                        functools.partial(deflate_v2.device_match_tokens, cap=16))
    monkeypatch.setattr(ref, "device_match_tokens",
                        functools.partial(ref.device_match_tokens, cap=16))
    port = DeviceTokenizer(BS, BS, device="cpu")(raw)
    want = RefTokenizer(BS, BS)(raw)
    for p, r, s in zip(port, want, sparse):
        assert np.array_equal(p, r)
        assert np.array_equal(p, s)


def test_tokenizer_requires_power_of_two_block():
    with pytest.raises(ValueError, match="power of two"):
        DeviceTokenizer(3 << 14, 1 << 14, device="cpu")


def test_match_and_parse_far_max_dist_equals_reference(jax_cpu):
    """match_and_parse with a window above DEFLATE's: 2^16 bytes of the
    far case's noise with text repeated 40,000 bytes on."""
    import jax
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import match_and_parse as ref_map

    N = 1 << 16
    data = np.frombuffer(_far_data()[:N], np.uint8).copy()
    data[1000:5000] = _text(4000)
    data[41000:45000] = _text(4000)
    port = match_and_parse(torch.from_numpy(data), N, max_dist=60000)
    ref = jax.jit(functools.partial(ref_map, max_dist=60000))(jnp.asarray(data), jnp.int32(N))
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy().astype(np.int64), np.asarray(r).astype(np.int64))
    is_tok, best_len, best_dist = (x[41000:45000] for x in port)
    assert bool(((best_dist == 40000) & is_tok & (best_len >= 3)).any())


def test_match_and_parse_default_window_unchanged(jax_cpu):
    """Without max_dist the stage keeps DEFLATE's 32 KiB window: the same
    arrays as max_dist=32768, and the same packed cover as the reference's
    default."""
    import jax.numpy as jnp

    from compu_tpu.kernels import deflate_jax_v2 as ref

    data = _text()
    default = match_and_parse(torch.from_numpy(data), BS)
    explicit = match_and_parse(torch.from_numpy(data), BS, max_dist=32768)
    for d, e in zip(default, explicit):
        assert torch.equal(d, e)
    want = np.asarray(ref.device_tokens(jnp.asarray(data), jnp.int32(BS)))
    assert np.array_equal(device_tokens(torch.from_numpy(data), BS).numpy(), want)


def test_export_checks():
    t = torch.from_numpy(_text())
    with pytest.raises(ValueError, match="21-bit"):
        device_tokens(t, BS, max_dist=1 << 21)
    with pytest.raises(ValueError, match="21-bit"):
        device_match_tokens(t, BS, max_dist=1 << 21)
    with pytest.raises(ValueError, match="20 bits"):
        device_match_tokens(torch.zeros((1 << 20) + 1024, dtype=torch.uint8), 5)


# ---------------------------------------------------------------------------
# On the card: B1 and B2 at the zstd path's shape, one 2^20-lane block
# ---------------------------------------------------------------------------

def _zstd_shape_inputs(device):
    """B1's and B2's inputs for one 1 MiB tokenizer call of the corpus at
    the zstd path's settings: wcap 32 (8 words), 2 sort keys, stride 1,
    depth 8, max_dist 131,071. B2's is the (2^20,) int64 step array."""
    from compu_tpu_torch.kernels import u32
    from compu_tpu_torch.kernels.deflate_v2 import _post_match
    from compu_tpu_torch.kernels.lcp_match import lcp_candidates_torch, sort_stage_lex
    from compu_tpu_torch.utils.corpus import build_corpus

    N = 1 << 20
    blocks = torch.from_numpy(np.frombuffer(build_corpus(N), np.uint8).copy()[None]).to(device)
    ns = torch.tensor([N], device=device)
    *wbe, ps = sort_stage_lex(blocks, wcap=32, keys=2, stride=1)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    ps32 = ps.reshape(-1).to(torch.int32)
    kw = dict(depth=8, max_dist=131071, block_elems=N)
    bl, bd = lcp_candidates_torch(words, ps32, **kw)
    step, *_ = _post_match(blocks, ns, ps, bl.reshape(1, -1).to(torch.int64),
                           bd.reshape(1, -1).to(torch.int64), wcap=32)
    return (words, ps32, kw), step.reshape(-1)


@pytest.mark.gpu
def test_b1_b2_at_zstd_shape_gpu(cuda):
    from compu_tpu_torch.kernels.lcp_match import lcp_candidates_cuda, lcp_candidates_torch
    from compu_tpu_torch.kernels.parse_cover import parse_cover_cuda, parse_cover_steps_torch

    (words, ps, kw), step = _zstd_shape_inputs(cuda)
    got = lcp_candidates_cuda(words, ps, **kw)
    want = lcp_candidates_torch(words, ps, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[1].max()) > 32768  # distances past DEFLATE's window occur
    assert step.shape == (8192 * 128,) and step.dtype == torch.int64
    assert torch.equal(parse_cover_cuda(step), parse_cover_steps_torch(step))


@pytest.mark.gpu
def test_device_match_tokens_card_equals_cpu_gpu(cuda):
    data = np.frombuffer(_far_data(), np.uint8).copy()
    for kw in ({}, {"max_dist": 131071}, {"max_dist": 131071, "cap": 64}):
        cpu = device_match_tokens(torch.from_numpy(data), FAR_BS, **kw)
        dev = device_match_tokens(torch.from_numpy(data).to(cuda), FAR_BS, **kw)
        assert torch.equal(cpu[0], dev[0].cpu()) and int(cpu[1]) == int(dev[1])
