"""The port's tiled device adler32 against the JAX reference and stock zlib,
on the CPU.

The partials are integer sums, so every comparison is exact (tolerance 0).
On the CPU the reference runs its Pallas kernel in interpret mode and the
port runs ``adler32_partials_torch``; the test marked ``gpu`` holds the CUDA
kernel to that twin on the card.
"""

import pathlib
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.kernels import adler_tiles  # noqa: E402
from compu_tpu_torch.kernels.adler_tiles import (  # noqa: E402
    TILE,
    adler32_device,
    adler32_partials_cuda,
    adler32_partials_torch,
)

DATA = pathlib.Path(__file__).parent / "data"
TEXT = (DATA / "alice29.txt").read_bytes()
N = 1 << 16


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(kind, n=N):
    rng = np.random.default_rng(17)
    return {
        "text": lambda: np.frombuffer(TEXT[:n], np.uint8),
        "random": lambda: rng.integers(0, 256, n, dtype=np.uint8),
        "ones": lambda: np.full(n, 255, np.uint8),  # the int32 sums' largest
    }[kind]().copy()


def test_constants_are_the_references(jax_cpu):
    from compu_tpu.kernels import pallas_kernels

    assert adler_tiles.TILE == pallas_kernels.TILE
    assert adler_tiles.ADLER_MOD == pallas_kernels.ADLER_MOD


@pytest.mark.parametrize("kind", ["text", "random", "ones"])
def test_partials_twin_matches_reference(jax_cpu, kind):
    import jax.numpy as jnp

    from compu_tpu.kernels.pallas_kernels import adler32_partials

    data = _bytes(kind)
    ref = np.asarray(adler32_partials(jnp.asarray(data)))
    port = adler32_partials_torch(torch.from_numpy(data))
    assert port.dtype == torch.int32 and port.shape == (N // TILE, 2)
    assert np.array_equal(ref[:, 0, :2], port.numpy())


@pytest.mark.parametrize("n", [N, N - 777, 1024])
def test_adler32_device_matches_zlib(n):
    block = np.zeros(N, np.uint8)
    block[:n] = np.frombuffer(TEXT[:n], np.uint8)
    assert adler32_device(torch.from_numpy(block), n) == zlib.adler32(TEXT[:n])


def test_partials_of_a_flat_batch_are_the_blocks():
    """One call over (B*N,) bytes gives each block's partials in order, and
    each block's adler32 from its own rows."""
    blocks = np.stack([_bytes(k) for k in ("text", "random", "ones")])
    flat = adler32_partials_torch(torch.from_numpy(blocks.reshape(-1)))
    per = N // TILE
    for b in range(3):
        own = adler32_partials_torch(torch.from_numpy(blocks[b]))
        assert torch.equal(flat[b * per:(b + 1) * per], own)
        assert adler32_device(torch.from_numpy(blocks[b]), N) == zlib.adler32(blocks[b].tobytes())


def test_adler32_device_equals_block_checksum():
    """The zlib path's metas carry the plain ``_block_checksum``; the device
    adler32 of the same padded blocks agrees with it."""
    from compu_tpu_torch.kernels.deflate_v3 import _block_checksum

    blocks = np.stack([_bytes(k) for k in ("text", "random", "ones")])
    lens = np.array([N, N - 5000, 1], np.int64)
    for b, n in enumerate(lens):
        blocks[b, n:] = 0
    chk = _block_checksum(torch.from_numpy(blocks), torch.from_numpy(lens), "adler")
    for b, n in enumerate(lens):
        assert adler32_device(torch.from_numpy(blocks[b]), int(n)) == int(chk[b])


RAGGED = [N, N - 777, 1, 0, 1024, N // 2 + 3]


def _ragged_batch():
    """Six blocks of N bytes, zero past ragged lengths (0 and 1 included)."""
    kinds = ("text", "random", "ones", "text", "random", "ones")
    blocks = np.stack([_bytes(k) for k in kinds])
    for b, n in enumerate(RAGGED):
        blocks[b, n:] = 0
    return blocks


@pytest.mark.parametrize("lens", [RAGGED, torch.tensor(RAGGED)], ids=["list", "tensor"])
def test_batched_adler32_device_matches_per_block_and_zlib(lens):
    """One call over a (B, N) batch gives each block's adler32: equal to the
    single-block call and to zlib.adler32 of the block's bytes."""
    blocks = _ragged_batch()
    got = adler32_device(torch.from_numpy(blocks), lens)
    assert got == [adler32_device(torch.from_numpy(blocks[b]), n)
                   for b, n in enumerate(RAGGED)]
    assert got == [zlib.adler32(blocks[b, :n].tobytes()) for b, n in enumerate(RAGGED)]


def test_adler_wrapper_checks():
    with pytest.raises(ValueError, match="CUDA tensor"):
        adler32_partials_cuda(torch.zeros(TILE, dtype=torch.uint8))
    with pytest.raises(ValueError, match="whole tiles"):
        adler32_partials_torch(torch.zeros(TILE + 1, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain twin
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_adler_kernel_matches_twin_gpu(cuda):
    data = np.concatenate([_bytes(k) for k in ("text", "random", "ones")])
    d = torch.from_numpy(data).to(cuda)
    assert torch.equal(adler32_partials_cuda(d), adler32_partials_torch(d))
    block = torch.zeros(N, dtype=torch.uint8, device=cuda)
    block[:N - 777] = d[:N - 777]
    assert adler32_device(block, N - 777) == zlib.adler32(TEXT[:N - 777])


@pytest.mark.gpu
@pytest.mark.parametrize("lens_on", ["list", "cuda"])
def test_batched_adler32_device_one_launch_gpu(cuda, lens_on):
    """The batched call makes one kernel launch for the whole batch and
    gives zlib's values, with the lengths as a list or a CUDA tensor."""
    from compu_tpu_torch import _build

    blocks = _ragged_batch()
    lens = RAGGED if lens_on == "list" else torch.tensor(RAGGED, device=cuda)
    _build.reset_launch_counts()
    got = adler32_device(torch.from_numpy(blocks).to(cuda), lens)
    assert _build.LAUNCHES["adler_tiles"] == 1
    assert got == [zlib.adler32(blocks[b, :n].tobytes()) for b, n in enumerate(RAGGED)]
