"""The PyTorch port's block encode end to end, against the JAX reference
and against stock zlib, on the CPU.

Parity is exact: the compressed bytes ``outs[:len]``, the metas
``[len, check]`` and ``seg_bits`` equal the reference's byte for byte.
Inputs are numpy arrays from fixed seeds handed to both packages; the
reference runs under ``JAX_PLATFORMS=cpu`` (tests/conftest.py).
"""

import os
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch import BlockParallelEncoder, ZlibMode, ZlibOptions, make_block_encode_fn  # noqa: E402
from compu_tpu_torch.encoder import ByteVec, EncodeOp, EncodeStatus, Interface  # noqa: E402
from compu_tpu_torch.kernels.deflate_v3 import encode_blocks_dyn  # noqa: E402

DATA = ROOT / "tests" / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
N = 1 << 15
CAP = N + N // 4 + 64

# The cases of tests/test_v3_kernel.py plus edge lengths, in pairs: one
# (B=2, N=2^15) batch each.
CASES = {
    "text": lambda rng: TEXT[:32768],
    "random": lambda rng: rng.integers(0, 256, 32768, dtype=np.uint8).tobytes(),
    "runs": lambda rng: b"a" * 32768,
    "low_entropy": lambda rng: rng.integers(0, 4, 32768, dtype=np.uint8).tobytes(),
    "records": lambda rng: b"".join(b'{"id": %08d}\n' % i for i in range(2000))[:32768],
    "tiny": lambda rng: b"XYZ",
    "mixed": lambda rng: ((TEXT[:1000] + rng.integers(0, 256, 1000, dtype=np.uint8)
                           .tobytes()) * 8)[:16000],
    "empty": lambda rng: b"",
    "one": lambda rng: b"Q",
    "seg_plus_one": lambda rng: rng.integers(0, 3, 129, dtype=np.uint8).tobytes(),
}
PAIRS = [("text", "random"), ("runs", "low_entropy"), ("records", "tiny"),
         ("mixed", "text"), ("empty", "one"), ("seg_plus_one", "runs")]

# Level 6 and level 1 of the block ladder (gzip, with the segment index),
# the zlib device stream's call (depth 8, the kernel's defaults), the hash
# matcher at wcap 32, depth 16 (zlib, and gzip with the segment index), and
# the hash matcher at scripts/time_lex.py's wcap 16, depth 32, check crc.
CONFIGS = {
    "level6": dict(depth=16, wcap=16, lex_keys=2, stride=1, check="crc", with_index=True),
    "level1": dict(depth=4, wcap=8, lex_keys=1, stride=2, check="adler", with_index=True),
    "zlib_device": dict(depth=8, check="adler"),
    "hash_zlib": dict(matcher="hash", depth=16, wcap=32, check="adler"),
    "hash_gzip_index": dict(matcher="hash", depth=16, wcap=32, check="crc", with_index=True),
    "hash_time_lex": dict(matcher="hash", depth=32, wcap=16, check="crc"),
}


@pytest.fixture
def jax_cpu():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(names):
    rng = np.random.default_rng(7)
    raws = [CASES[n](rng) for n in names]
    blocks = np.zeros((len(raws), N), np.uint8)
    lens = np.zeros(len(raws), np.int32)
    for i, raw in enumerate(raws):
        blocks[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lens[i] = len(raw)
    return raws, blocks, lens


def _assert_same_blocks(ref, port, raws):
    """Equal defined bytes, metas and seg_bits; every block inflates."""
    assert np.array_equal(ref[1], port[1])  # metas [len, check]
    for i, raw in enumerate(raws):
        n = int(ref[1][i, 0])
        assert np.array_equal(ref[0][i, :n], port[0][i, :n]), f"block {i} bytes"
        blob = port[0][i, :n].tobytes()
        assert zlib.decompressobj(-15).decompress(blob + b"\x01\x00\x00\xff\xff") == raw
    if len(ref) > 2:
        assert np.array_equal(ref[2], port[2])  # seg_bits


@pytest.mark.parametrize("pair", PAIRS, ids="-".join)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_blocks_dyn_matches_reference(jax_cpu, config, pair):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v3 import encode_blocks_dyn as ref_encode

    raws, blocks, lens = _batch(pair)
    kw = CONFIGS[config]
    ref = [np.asarray(x) for x in ref_encode(jnp.asarray(blocks), jnp.asarray(lens), **kw)]
    port = [x.numpy() for x in encode_blocks_dyn(torch.from_numpy(blocks),
                                                 torch.from_numpy(lens), **kw)]
    assert port[0].shape == ref[0].shape == (2, CAP)
    assert port[0].dtype == np.uint8 and port[1].dtype == np.int32
    _assert_same_blocks(ref, port, raws)


def _corpus(nblocks):
    rng = np.random.default_rng(3)
    text = (TEXT * 2)[: (nblocks - 1) * N]
    return text + rng.integers(0, 16, N - 100, dtype=np.uint8).tobytes()


def test_gzip_stream_matches_reference(jax_cpu):
    """The whole level-6 gzip stream with the segment index, through both
    packages' BlockParallelEncoder, in two pipeline groups. Each package
    gets its own ZlibMode: the port's is a copy, not the reference's."""
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.kernels.block_codec import make_block_encode_fn as ref_make
    from compu_tpu.parallel.scheduler import BlockParallelEncoder as RefEncoder

    data = _corpus(4)
    kw = dict(level=6, segment_index=True, pipeline_groups=2)
    ref_enc = RefEncoder(ref_make(RefMode.Gzip, **kw), block_size=N, mode=RefMode.Gzip,
                         host_fallback=False)
    fn = make_block_encode_fn(ZlibMode.Gzip, device="cpu", **kw)
    enc = BlockParallelEncoder(fn, block_size=N, mode=ZlibMode.Gzip)
    ref_stream, ref_index = ref_enc.encode(data)
    stream, index = enc.encode(data)
    assert [s.state for s in enc.block_statuses] == ["ok"] * 4
    assert stream == ref_stream
    assert zlib.decompress(stream, wbits=31) == data
    assert all(np.array_equal(a, b) for a, b in zip(index.segment_bits, ref_index.segment_bits))
    assert set(fn.last_timings) == {"h2d_dispatch_ms", "sync_meta_ms",
                                    "payload_d2h_ms", "host_asm_ms"}


@pytest.mark.parametrize("mode,wbits", [(ZlibMode.Zlib, 15), (ZlibMode.Deflate, -15)])
def test_block_stream_decodes_with_zlib(mode, wbits):
    data = _corpus(3)
    fn = make_block_encode_fn(mode, level=6, device="cpu")
    enc = BlockParallelEncoder(fn, block_size=N, mode=mode)
    stream, index = enc.encode(data)
    assert [s.state for s in enc.block_statuses] == ["ok"] * 3
    assert zlib.decompress(stream, wbits=wbits) == data
    assert index.segment_bits is None and len(stream) < len(data) // 2


def _failing_step(blocks, lens):
    raise RuntimeError("kernel launch failed")


def _empty_output_step(blocks, lens):
    B = blocks.shape[0]
    return [np.zeros(1, np.uint8)] * B, np.zeros(B, np.int64), np.zeros(B, np.uint32)


@pytest.mark.parametrize("step,error", [(_failing_step, RuntimeError),
                                        (_empty_output_step, ValueError)])
def test_device_fault_raises_without_host_reencode(step, error):
    """With the default arguments a failed device step, or an implausible
    block output, raises and marks the blocks failed: the port never
    re-encodes on the host."""
    enc = BlockParallelEncoder(step, block_size=N, mode=ZlibMode.Gzip)
    with pytest.raises(error):
        enc.encode(_corpus(2))
    assert "failed" in [s.state for s in enc.block_statuses]
    assert "host_fallback" not in [s.state for s in enc.block_statuses]
    with pytest.raises(ValueError, match="no host fallback"):
        BlockParallelEncoder(step, block_size=N, host_fallback=True)


def test_unported_kernels_raise():
    """v1 is not ported by design; v2 is (tests/test_torch_fixed_v2.py)."""
    with pytest.raises(NotImplementedError, match="not ported"):
        make_block_encode_fn(ZlibMode.Gzip, kernel="v1")
    with pytest.raises(ValueError, match="unknown kernel"):
        make_block_encode_fn(ZlibMode.Gzip, kernel="v4")
    assert callable(make_block_encode_fn(ZlibMode.Gzip, kernel="v2", device="cpu"))


def _device_encode(data, mode, chunk=None):
    enc = Interface.zlib_device(ZlibOptions(mode=mode, level=6), block_size=N, device="cpu")
    vec = ByteVec()
    if chunk is None:
        res = enc.encode_vec_full(data, vec, EncodeOp.Finish)
    else:
        for i in range(0, len(data), chunk):
            enc.encode_vec_full(data[i:i + chunk], vec, EncodeOp.Process)
        res = enc.encode_vec_full(b"", vec, EncodeOp.Finish)
    assert res.status is EncodeStatus.Finished
    return vec.data()


@pytest.mark.parametrize("mode,wbits", [(ZlibMode.Zlib, 15), (ZlibMode.Gzip, 31)])
def test_zlib_device_roundtrip(mode, wbits):
    data = TEXT[:100_000]
    out = _device_encode(data, mode)
    assert zlib.decompress(out, wbits=wbits) == data
    assert _device_encode(data, mode, chunk=7_777) == out  # chunked == one-shot


def test_zlib_device_matches_reference(jax_cpu):
    """The reference is handed its own options, sink and op types."""
    from compu_tpu.encoder import Interface as RefInterface
    from compu_tpu.formats.deflate.options import ZlibOptions as RefOptions
    from compu_tpu.status import EncodeOp as RefOp
    from compu_tpu.vec import ByteVec as RefVec

    data = TEXT[:70_000]
    ref = RefInterface.zlib_device(RefOptions(level=6), block_size=N)
    vec = RefVec()
    ref.encode_vec_full(data, vec, RefOp.Finish)
    assert _device_encode(data, ZlibMode.Zlib) == vec.data()


def test_entry_step_on_cpu():
    from compu_tpu_torch.entry import dryrun_multichip, entry

    fn, (data, n) = entry(device="cpu")
    out, meta = fn(data, n)
    blob = out[: int(meta[0])].numpy().tobytes()
    expect = data.numpy().tobytes()
    assert zlib.decompressobj(-15).decompress(blob + b"\x01\x00\x00\xff\xff") == expect
    assert int(meta[1]) == zlib.adler32(expect) - (1 << 32) * (zlib.adler32(expect) >= 1 << 31)
    dryrun_multichip(1, device="cpu")  # one gloo rank in this process


def test_port_never_imports_jax():
    """A small encode through the port, in a fresh interpreter, leaves no
    jax module loaded."""
    code = (
        "import sys, zlib\n"
        "from compu_tpu_torch import BlockParallelEncoder, ZlibMode, make_block_encode_fn\n"
        "from compu_tpu_torch.encoder import Interface\n"
        "data = open('tests/data/alice29.txt', 'rb').read()[:20000]\n"
        "fn = make_block_encode_fn(ZlibMode.Gzip, segment_index=True, device='cpu')\n"
        "enc = BlockParallelEncoder(fn, block_size=1 << 13, mode=ZlibMode.Gzip)\n"
        "assert zlib.decompress(enc.encode(data)[0], wbits=31) == data\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


# ---------------------------------------------------------------------------
# On the card: the CUDA path gives the CPU path's bytes
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cuda_bytes_equal_cpu_gpu(cuda, config):
    for pair in PAIRS:
        raws, blocks, lens = _batch(pair)
        kw = CONFIGS[config]
        cpu = [x.numpy() for x in encode_blocks_dyn(torch.from_numpy(blocks),
                                                    torch.from_numpy(lens), **kw)]
        dev = [x.cpu().numpy() for x in encode_blocks_dyn(
            torch.from_numpy(blocks).to(cuda), torch.from_numpy(lens).to(cuda), **kw)]
        _assert_same_blocks(cpu, dev, raws)
