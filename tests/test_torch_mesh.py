"""The port's multi-device slice on the CPU: ``parallel/mesh.py`` on
``torch.distributed`` with gloo, ``entry.dryrun_multichip``, and the
checksum pieces it reassembles with (``kernels/checksum.adler32_block``,
``ops/checksum.{crc32,fold_lane_registers}``), against the JAX reference
(its steps on the 8-device CPU mesh of tests/conftest.py) and stdlib zlib.

Every comparison is exact. A world of one rank runs in this process; the
two- and four-rank worlds are Python processes of their own, each with its
own ``communicate(timeout=...)``, rendezvous on a port picked by binding
port 0.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch.formats.zstd.huff import HufEncoder  # noqa: E402
from compu_tpu_torch.kernels.checksum import adler32_block, crc32_lane_registers  # noqa: E402
from compu_tpu_torch.ops import checksum  # noqa: E402
from compu_tpu_torch.parallel import mesh as pmesh  # noqa: E402

DATA = ROOT / "tests" / "data"
ALICE = (DATA / "alice29.txt").read_bytes()
BS = 1 << 14
RANK_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def jax_cpu():
    return pytest.importorskip("jax")


@pytest.fixture
def gloo_world():
    """A gloo process group of one rank in this process, and its 1-D mesh."""
    pmesh.init_world(rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{_free_port()}",
                     device="cpu")
    try:
        yield pmesh.default_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_checksum_kernels(jax_cpu):
    """Port of tests/test_parallel.py::test_checksum_kernels, each piece
    also against the reference's."""
    import jax.numpy as jnp

    from compu_tpu.kernels.checksum_jax import adler32_block as ref_adler
    from compu_tpu.ops import checksum as ref_checksum

    payload = ALICE[:BS]
    block = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    assert adler32_block(block, BS) == zlib.adler32(payload)
    padded = torch.zeros(BS, dtype=torch.uint8)
    padded[:5000] = block[:5000]
    want = int(ref_adler(jnp.asarray(padded.numpy()), jnp.int32(5000)))
    assert adler32_block(padded, 5000) == want == zlib.adler32(payload[:5000])
    lanes = 64
    regs = crc32_lane_registers(block[None], lanes=lanes)[0].numpy()
    reg = checksum.fold_lane_registers(regs, BS // lanes)
    assert reg == ref_checksum.fold_lane_registers(regs.astype(np.uint32), BS // lanes)
    assert (reg ^ 0xFFFFFFFF) == zlib.crc32(payload)
    with pytest.raises(ValueError, match="power of two"):
        checksum.fold_lane_registers(regs[:3], BS // lanes)


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 14) - 1, 1 << 14, 100_001, 1 << 20])
def test_crc32_matches_zlib_and_reference(n):
    from compu_tpu.ops.checksum import crc32_lanes as ref_crc32

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert checksum.crc32(data) == zlib.crc32(data) == ref_crc32(data)
    assert checksum.crc32(data, 0x1234567) == zlib.crc32(data, 0x1234567)


def _encode_inputs(B=8, N=4096):
    rng = np.random.default_rng(3)
    blocks = np.zeros((B, N), np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        raw = ALICE[i * 3000:i * 3000 + N - 500 * (i % 3)]
        raw = raw[: N // 2] + rng.integers(0, 8, len(raw) - N // 2, dtype=np.uint8).tobytes()
        blocks[i, : len(raw)] = np.frombuffer(raw, np.uint8)
        lens[i] = len(raw)
    return blocks, lens


def test_sharded_encode_step_matches_reference(jax_cpu, gloo_world):
    """The port's step on a gloo world of one, given the global blocks,
    against the reference's step on its 8-device mesh: per-block bytes,
    lengths, adlers and the total."""
    import jax.numpy as jnp

    from compu_tpu.parallel.mesh import default_mesh as ref_mesh
    from compu_tpu.parallel.mesh import make_sharded_encode_step as ref_make

    blocks, lens = _encode_inputs()
    ref = [np.asarray(x) for x in ref_make(ref_mesh(), depth=8)(jnp.asarray(blocks),
                                                                 jnp.asarray(lens))]
    step = pmesh.make_sharded_encode_step(gloo_world, depth=8)
    outs, out_lens, adlers, total = step(torch.from_numpy(blocks), torch.from_numpy(lens))
    assert np.array_equal(out_lens.numpy(), ref[1])
    assert np.array_equal(adlers.numpy(), ref[2].astype(np.int64).astype(np.uint32).view(np.int32))
    assert int(total) == int(ref[3]) == int(out_lens.sum())
    for i in range(len(lens)):
        n = int(out_lens[i])
        assert np.array_equal(outs[i, :n].numpy(), ref[0][i, :n]), i
        assert adlers[i].numpy().view(np.uint32) == zlib.adler32(blocks[i, : lens[i]].tobytes())


def _literal_inputs():
    """tests/test_parallel.py's stream case: 2 blocks x 4 streams of 96 KB
    of alice29 under one table from its byte counts."""
    data = ALICE[:96_000]
    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    nblocks, per_block = 2, len(data) // 2
    per = (per_block + 3) // 4
    mat = np.zeros((nblocks * 4, per), np.uint8)
    counts = np.zeros(nblocks * 4, np.int32)
    chunks = []
    for b in range(nblocks):
        blk = data[b * per_block:(b + 1) * per_block]
        for s in range(4):
            c = blk[s * per:(s + 1) * per]
            chunks.append(c)
            mat[b * 4 + s, : len(c)] = np.frombuffer(c, np.uint8)
            counts[b * 4 + s] = len(c)
    return freqs + 1, mat, counts, chunks, per + per // 2 + 64


def test_stream_sharded_literal_step(jax_cpu, gloo_world):
    """Each stream equals the host writer's (``HufEncoder.encode_stream``)
    and the reference's step on its 8-device mesh."""
    import jax.numpy as jnp

    from compu_tpu.formats.zstd.huff import HufEncoder as RefHuf
    from compu_tpu.parallel.mesh import default_mesh as ref_mesh
    from compu_tpu.parallel.mesh import make_stream_sharded_literal_step as ref_make

    freqs, mat, counts, chunks, cap = _literal_inputs()
    enc, ref_enc = HufEncoder(freqs), RefHuf(freqs)
    code = np.zeros(256, np.uint32)
    nbits = np.zeros(256, np.int32)
    code[: enc.max_symbol + 1] = enc.code
    nbits[: enc.max_symbol + 1] = enc.nbits
    ref_out, ref_nb = (np.asarray(x) for x in ref_make(ref_mesh(), cap=cap)(
        jnp.asarray(mat), jnp.asarray(counts), jnp.asarray(code), jnp.asarray(nbits)))
    step = pmesh.make_stream_sharded_literal_step(gloo_world, cap=cap)
    out, nb = step(torch.from_numpy(mat), torch.from_numpy(counts),
                   torch.from_numpy(code.astype(np.int64)), torch.from_numpy(nbits))
    assert out.shape == (8, cap) and np.array_equal(nb.numpy(), ref_nb)
    for i, c in enumerate(chunks):
        want = enc.encode_stream(c)
        assert want == ref_enc.encode_stream(c)
        assert out[i, : nb[i]].numpy().tobytes() == want == ref_out[i, : ref_nb[i]].tobytes(), i


def test_lane_sharded_crc_world_of_one(gloo_world):
    """A (1, 1) ("dp", "lane") mesh: the registers of the whole block fold
    to its crc32."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "lane"))
    payload = ALICE[:BS - 1000]
    block = np.zeros(BS, np.uint8)
    block[: len(payload)] = np.frombuffer(payload, np.uint8)
    regs = pmesh.make_lane_sharded_crc(mesh2, lanes_per_device=64)(torch.from_numpy(block[None]))
    assert regs.shape == (1, 64)
    reg = checksum.fold_lane_registers(regs[0].numpy(), BS // 64)
    assert checksum.crc_unshift(reg, 1000) ^ 0xFFFFFFFF == zlib.crc32(payload)


def test_backends_are_fixed_by_device():
    assert pmesh.backend_for("cpu") == "gloo"
    assert pmesh.backend_for(torch.device("cuda", 0)) == "nccl"
    with pytest.raises(ValueError):
        pmesh.backend_for("meta")


WORKER = r"""
import json, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from compu_tpu_torch.kernels.deflate_v2 import encode_blocks_fixed_v2
from compu_tpu_torch.parallel import mesh as pmesh

pmesh.init_world(rank={pid}, world_size=2, init_method={init!r}, device="cpu")
mesh = pmesh.default_mesh(device="cpu")
group = mesh.get_group("dp")
BLOCK = 1 << 14
B = 4
rng = np.random.default_rng(3)
host = rng.integers(65, 91, (B, BLOCK)).astype(np.uint8)
host[:, ::2] = 65  # compressible
lens = np.full(B, BLOCK, dtype=np.int32)
local = slice({pid} * 2, {pid} * 2 + 2)
outs, metas = encode_blocks_fixed_v2(torch.from_numpy(host[local]),
                                     torch.from_numpy(lens[local]), depth=2)
out_lens = pmesh.all_gather_rows(metas[:, 0], group)
total = metas[:, 0].sum(dtype=torch.int64)
dist.all_reduce(total, group=group)
assert int(total) == int(out_lens.sum())
dist.destroy_process_group()
print("RESULT " + json.dumps({{"pid": {pid}, "lens": out_lens.tolist()}}))
"""


def test_two_process_mesh_exchanges_ordering_metadata(jax_cpu):
    """Port of tests/test_distributed.py: two gloo ranks of two blocks each
    encode with the v2 kernel at depth 2 and all-gather the lengths; both
    see the same four, which are the reference's per-block metas."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import encode_block_fixed_v2 as ref_encode

    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER.format(repo=str(ROOT), init=init,
                                                                   pid=pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for pid in (0, 1)]
    results = {}
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=RANK_TIMEOUT_S)
            assert p.returncode == 0, f"process {pid} failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
            results[pid] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert results[0]["lens"] == results[1]["lens"]
    rng = np.random.default_rng(3)
    host = rng.integers(65, 91, (4, BS)).astype(np.uint8)
    host[:, ::2] = 65
    want = [int(np.asarray(ref_encode(jnp.asarray(host[i]), jnp.int32(BS), depth=2)[1])[0])
            for i in range(4)]
    assert results[0]["lens"] == want


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_gloo(n):
    """``dryrun_multichip`` on n gloo ranks, each a process of its own; at 4
    it also runs the (2, 2) ("dp", "lane") lane-sharded crc32."""
    from compu_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n, device="cpu")
