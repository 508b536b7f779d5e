"""B2, the greedy cover, as one function from the int64 step array to the
bool mask: the plain version and the CPU route of ``parse_cover`` against
the reference's ``parse_cover_mxu`` (JAX on the CPU), the CPU model of the
kernel's lanes against the orbit walk, the wrapper's refusals, and, marked
``gpu``, the CUDA kernel against the plain version on the card. Every
comparison is exact (tolerance 0): the function is integer work.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch import _build
from compu_tpu_torch.kernels import parse_cover as pc

SEG = pc.SEG


@pytest.fixture
def jax_cpu():
    """The JAX reference, on the CPU (tests/conftest.py pins the platform)."""
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_steps(S, seed):
    """Literals (1), matches of 3..258 clipped at the segment end, and junk
    (<= 0, read as 1), as the parser gives them."""
    rng = np.random.default_rng(seed)
    N = S * SEG
    step = np.where(rng.random(N) < 0.5, 1, rng.integers(3, 259, N))
    step[rng.random(N) < 0.05] = rng.integers(-3, 1)
    return np.minimum(step, SEG - (np.arange(N) & (SEG - 1)))


def _case(name):
    """(N,) int64 steps of one edge case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    local = np.arange(8 * SEG) & (SEG - 1)
    if name == "seed":
        step = _random_steps(40, 3)
    elif name == "literals":  # every step 1: 127 hops a segment
        step = np.ones(4 * SEG)
    elif name == "to_the_end":  # every step ends exactly at the segment's end
        step = SEG - local
    elif name == "some_to_the_end":  # maximal steps among literals and short ones
        step = np.where(rng.random(local.size) < 0.2, SEG - local, rng.integers(1, 5, local.size))
    elif name == "one_segment":
        step = _random_steps(1, 4)
    elif name == "odd_count":  # 37 segments: not a multiple of a block's or warp's
        step = _random_steps(37, 5)
    elif name == "short":  # steps of 1-4: every entry offset of a window occurs
        step = rng.integers(1, 5, 24 * SEG)
    elif name == "junk":  # beyond int32, negative and zero: clamped to 1..128
        step = rng.integers(-(1 << 62), 1 << 62, 6 * SEG)
        step[rng.random(step.size) < 0.5] = rng.integers(-2, 3)
    else:
        raise KeyError(name)
    return np.asarray(step, np.int64)


CASES = ["seed", "literals", "to_the_end", "some_to_the_end", "one_segment", "odd_count",
         "short", "junk"]
INT32_CASES = [c for c in CASES if c != "junk"]


def _walk(step):
    """The cover by its definition: the orbit of each segment's 0."""
    nl = np.minimum((np.arange(step.size) & (SEG - 1)) + np.clip(step, 1, SEG), SEG)
    mask = np.zeros(step.size, bool)
    for s in range(0, step.size, SEG):
        i = 0
        while i < SEG:
            mask[s + i] = True
            i = nl[s + i]
    return mask


@pytest.mark.parametrize("name", INT32_CASES)
def test_plain_version_and_cpu_route_match_mxu(jax_cpu, name):
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import parse_cover_mxu

    step = _case(name)
    ref = np.asarray(parse_cover_mxu(jnp.asarray(step.astype(np.int32)), SEG))
    t = torch.from_numpy(step)
    assert np.array_equal(pc.parse_cover_steps_torch(t).numpy(), ref)
    got = pc.parse_cover(t)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", CASES)
def test_lanes_model_matches_orbit_walk(name):
    step = _case(name)
    want = _walk(step)
    assert np.array_equal(pc.parse_cover_lanes_torch(torch.from_numpy(step)).numpy(), want)
    assert np.array_equal(pc.parse_cover_steps_torch(torch.from_numpy(step)).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lanes_model_matches_plain_version(seed):
    step = torch.from_numpy(_random_steps(300, seed).astype(np.int64))
    assert torch.equal(pc.parse_cover_lanes_torch(step), pc.parse_cover_steps_torch(step))


@pytest.mark.parametrize("bad,err,match", [
    (torch.ones(256, dtype=torch.int32), TypeError, "int64"),
    (torch.ones(200, dtype=torch.int64), ValueError, "multiple of 128"),
    (torch.ones(2, 128, dtype=torch.int64), ValueError, "multiple of 128"),
    (torch.ones(256, dtype=torch.int64), ValueError, "CUDA tensor"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(bad, err, match):
    with pytest.raises(err, match=match):
        pc.parse_cover_cuda(bad)


def test_parse_cover_refuses_other_devices():
    with pytest.raises(ValueError, match="no parse_cover for device"):
        pc.parse_cover(torch.ones(128, dtype=torch.int64, device="meta"))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version_gpu(cuda, name):
    step = torch.from_numpy(_case(name)).to(cuda)
    got = pc.parse_cover_cuda(step)
    assert got.dtype == torch.bool
    assert torch.equal(got, pc.parse_cover_steps_torch(step))
    assert np.array_equal(got.cpu().numpy(), _walk(_case(name)))


@pytest.mark.gpu
def test_kernel_at_the_deflate_shape_gpu(cuda):
    step = torch.from_numpy(_random_steps(32768, 6).astype(np.int64)).to(cuda)
    assert torch.equal(pc.parse_cover_cuda(step), pc.parse_cover_steps_torch(step))


@pytest.mark.gpu
def test_parse_cover_is_one_launch_gpu(cuda, monkeypatch):
    def plain(*_):
        raise AssertionError("the plain version ran on the card")

    step = torch.from_numpy(_case("seed")).to(cuda)
    want = pc.parse_cover_steps_torch(step)
    monkeypatch.setattr(pc, "parse_cover_steps_torch", plain)
    monkeypatch.setattr(pc, "jump_targets", plain)
    _build.reset_launch_counts()
    got = pc.parse_cover(step)
    assert _build.LAUNCHES["parse_cover"] == 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_refuses_unaligned_and_int32_gpu(cuda):
    step = torch.ones(4 * SEG + 2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        pc.parse_cover_cuda(step[1:1 + 2 * SEG])
    with pytest.raises(TypeError, match="int64"):
        pc.parse_cover_cuda(step[:SEG].to(torch.int32))
