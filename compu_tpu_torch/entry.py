"""Entry points of the port: the flagship device step and the multi-device
dry run.

Port of ``__graft_entry__.entry``: one level-6 256 KiB DEFLATE block encode
(lex/LCP matcher with two sort-key words, depth 16, 16-byte windows); and
of ``__graft_entry__.dryrun_multichip``: one sharded encode step over
``n_devices`` ranks (``parallel/mesh.py``), its outputs checked.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from .kernels.deflate_v3 import encode_block_dyn

DRYRUN_BLOCK = 4096  # a dry run's per-block payload
DRYRUN_TIMEOUT_S = 600.0  # a spawned dry run's limit, rendezvous included
TERM = bytes([0x01, 0x00, 0x00, 0xFF, 0xFF])  # a final empty stored block


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: the level-6 block encode step and a
    256 KiB text block with its length, on ``device``."""
    N = 1 << 18

    def fn(data, n):
        return encode_block_dyn(data, n, depth=16, wcap=16, lex_keys=2)

    text = (b"the quick brown fox jumps over the lazy dog. " * 8192)[:N]
    data = torch.from_numpy(np.frombuffer(text, dtype=np.uint8).copy()).to(device)
    return fn, (data, N)


def _dryrun_payloads(n: int):
    """The reference's dry-run blocks, one a rank: a repeated phrase (1,856
    bytes) and 2,048 bytes of noise (seed 42), zero-padded to 4 KiB."""
    rng = np.random.default_rng(42)
    base = b"compressible dry-run payload " * 64
    N = DRYRUN_BLOCK
    payloads = [base[: N // 2] + rng.integers(0, 256, N // 2, dtype=np.uint8).tobytes()
                for _ in range(n)]
    blocks = np.zeros((n, N), dtype=np.uint8)
    for i, raw in enumerate(payloads):
        blocks[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return payloads, blocks, np.array([len(raw) for raw in payloads], dtype=np.int32)


def _dryrun_rank(rank: int, n: int, init_method: str, device: str) -> None:
    """One rank of the dry run: join the world, run the checks, leave."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh

    dev = pmesh.init_world(rank=rank, world_size=n, init_method=init_method, device=device)
    try:
        _dryrun_checks(rank, n, dev)
    finally:
        dist.destroy_process_group()


def _dryrun_checks(rank: int, n: int, dev: torch.device) -> None:
    """The reference's checks, on every rank: the total is the sum of the
    gathered lengths; the blocks and a final empty stored block decode to
    the payloads (through the host ``Inflate``, as the reference's dry run
    decodes them, and through ``decoder.Interface.zlib_device`` on this
    rank's device and stdlib ``zlib``); the adlers combine to the payloads'
    adler32; on an even world of 2 or more, the lane-sharded crc32 of block
    0 over a (n/2, 2) ("dp", "lane") mesh folds to its crc32."""
    from torch.distributed.device_mesh import init_device_mesh

    from . import decoder
    from .formats.deflate.inflate import Inflate
    from .formats.deflate.options import ZlibMode
    from .ops import checksum
    from .parallel import mesh as pmesh

    payloads, blocks, lens = _dryrun_payloads(n)
    N = DRYRUN_BLOCK
    mesh = pmesh.default_mesh(device=dev)
    step = pmesh.make_sharded_encode_step(mesh, depth=4, nice=32, lazy=True)
    outs, out_lens, adlers, total = step(torch.from_numpy(blocks[rank:rank + 1]),
                                         torch.from_numpy(lens[rank:rank + 1]))
    every = pmesh.all_gather_rows(outs, mesh.get_group("dp")).cpu().numpy()
    out_lens = out_lens.cpu().numpy()
    adlers = adlers.cpu().numpy().view(np.uint32)
    if int(total) != int(out_lens.astype(np.int64).sum()):
        raise AssertionError(f"total {int(total)} != the sum of the lengths {out_lens.sum()}")

    stream = b"".join(every[i, : out_lens[i]].tobytes() for i in range(n)) + TERM
    expect = b"".join(payloads)
    inf = Inflate(ZlibMode.Deflate)
    _, finished = inf.pump(stream, 0)
    if not finished or bytes(inf.sink) != expect:
        raise AssertionError("the host Inflate does not decode the multi-device stream")
    out = bytearray(len(expect) + 16)
    res = decoder.Interface.zlib_device(ZlibMode.Deflate, device=dev).decode(stream, out)
    if res.status is not decoder.DecodeStatus.Finished or bytes(out[: len(expect)]) != expect:
        raise AssertionError(f"multi-device stream does not decode ({res.status})")
    if zlib.decompress(stream, wbits=-15) != expect:
        raise AssertionError("stdlib zlib does not decode the multi-device stream")

    combined = 1
    for i in range(n):
        combined = checksum.adler32_combine(combined, int(adlers[i]), int(lens[i]))
    if combined != checksum.adler32(expect):
        raise AssertionError("the blocks' adlers do not combine to the stream's")

    if n >= 2 and n % 2 == 0:
        mesh2 = init_device_mesh(mesh.device_type, (n // 2, 2), mesh_dim_names=("dp", "lane"))
        lanes_per_dev = 16
        half = mesh2.get_local_rank("lane")
        crc_step = pmesh.make_lane_sharded_crc(mesh2, lanes_per_device=lanes_per_dev)
        regs = crc_step(torch.from_numpy(blocks[:1, half * N // 2:(half + 1) * N // 2]))
        reg = checksum.fold_lane_registers(regs[0].cpu().numpy(), N // (lanes_per_dev * 2))
        crc = checksum.crc_unshift(reg, N - int(lens[0])) ^ 0xFFFFFFFF
        if crc != checksum.crc32(payloads[0]):
            raise AssertionError("lane-sharded crc32 differs from the payload's")
    if rank == 0:
        print(f"dryrun_multichip({n}): OK, {n} blocks, {int(total)} compressed bytes, "
              f"checksums verified", flush=True)


def free_port() -> int:
    """A free TCP port on the loopback address, for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One full multi-device step on tiny shapes, checked: ``n_devices``
    ranks, one block of 4 KiB each, encoded by the sharded step
    (``parallel/mesh.py``) with the lengths and adlers gathered, then the
    reference's checks (:func:`_dryrun_checks`); on an even world also the
    2-D ("dp", "lane") mesh's lane-sharded crc32.

    ``device`` is CUDA by default: NCCL, one card a rank, so ``n_devices``
    may not pass the visible cards. ``"cpu"`` runs the ranks on gloo. One
    rank runs in this process (which must have no process group yet);
    more run in as many Python processes, each stopped at
    ``DRYRUN_TIMEOUT_S``. Raises if any rank's check fails."""
    import torch.distributed as dist

    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    if n_devices == 1:
        if dist.is_initialized():
            raise RuntimeError("a process group already exists in this process")
        _dryrun_rank(0, 1, init_method, kind)
        return
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(pathlib.Path(__file__).resolve().parent.parent), os.environ.get("PYTHONPATH", "")]))
    if kind == "cpu":
        # gloo ranks on one host each take every core otherwise, and then
        # wait on each other: a dry run of 4 ranks took 55 s against 5 s on
        # an 8-core CPU.
        env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from compu_tpu_torch.entry import _dryrun_rank; "
                               f"_dryrun_rank({rank}, {n_devices}, {init_method!r}, {kind!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(n_devices)]
    deadline = time.monotonic() + DRYRUN_TIMEOUT_S
    failed = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if rank == 0:
                print(out, end="", flush=True)
            if proc.returncode:
                failed.append(f"rank {rank} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n" + "\n".join(failed))
