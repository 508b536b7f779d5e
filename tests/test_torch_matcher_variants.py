"""The matcher's two variants, parameters in the port where the JAX
reference reads environment variables: B1's far tie (``prefer_far``,
``COMPU_LCP_TIE=far``) and no distance-1 run extension (``run_ext=False``,
``COMPU_RUN_EXT=0``).

The reference reads both when it traces, and its jitted caches do not key
on the environment, so its un-jitted pieces (``lcp_candidates_xla``,
``_post_match``) run here under ``monkeypatch.setenv``, and its whole
block encode runs in a fresh interpreter with the variable set. Every
comparison is exact (integer functions).
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch.kernels import u32  # noqa: E402
from compu_tpu_torch.kernels.deflate_v2 import _post_match  # noqa: E402
from compu_tpu_torch.kernels.deflate_v3 import encode_block_dyn  # noqa: E402
from compu_tpu_torch.kernels.lcp_match import (  # noqa: E402
    lcp_candidates_cuda,
    lcp_candidates_torch,
    sort_stage_lex,
)

TEXT = (ROOT / "tests" / "data" / "alice29.txt").read_bytes()
N = 1 << 13
BLOCK = 1 << 14  # the whole-block comparison's block


def _blocks():
    """Text, a repeated half (equal-length ties at two distances), and runs
    of a few byte values (distance-1 runs)."""
    rng = np.random.default_rng(5)
    blocks = np.zeros((3, N), np.uint8)
    blocks[0] = np.frombuffer(TEXT[:N], np.uint8)
    blocks[1] = np.frombuffer((TEXT[700:700 + N // 4] * 4)[:N], np.uint8)
    blocks[2, : N - 300] = np.repeat(rng.integers(0, 4, (N - 300) // 20 + 1), 20)[: N - 300]
    return blocks, np.array([N, N, N - 300], np.int32)


def _block_case():
    """One 16 KiB block of text, a repeat of it, and byte runs."""
    rng = np.random.default_rng(9)
    raw = (TEXT[:6000] + TEXT[:4000] + bytes(np.repeat(rng.integers(0, 256, 200), 25)))[:BLOCK]
    block = np.zeros(BLOCK, np.uint8)
    block[: len(raw)] = np.frombuffer(raw, np.uint8)
    return block, len(raw)


@pytest.fixture
def jax_cpu():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sorted(blocks, wcap, keys):
    *wbe, ps = sort_stage_lex(torch.from_numpy(blocks), wcap=wcap, keys=keys)
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    return [w.numpy() for w in wbe], ps.numpy(), words, ps.reshape(-1).to(torch.int32)


@pytest.mark.parametrize("tie", ["near", "far"])
@pytest.mark.parametrize("wcap,keys,depth", [(16, 2, 16), (32, 2, 8), (8, 1, 4)])
def test_lcp_tie_rule_matches_xla(jax_cpu, monkeypatch, tie, wcap, keys, depth):
    """``prefer_far`` against ``lcp_candidates_xla`` under COMPU_LCP_TIE."""
    import jax.numpy as jnp

    from compu_tpu.kernels.lcp_match import lcp_candidates_xla

    if tie == "far":
        monkeypatch.setenv("COMPU_LCP_TIE", "far")
    else:
        monkeypatch.delenv("COMPU_LCP_TIE", raising=False)
    blocks, _ = _blocks()
    wbe, ps, words, ps32 = _sorted(blocks, wcap, keys)
    kw = dict(depth=depth, max_dist=32768, block_elems=N)
    rl, rd = lcp_candidates_xla(
        tuple(jnp.asarray(w.reshape(-1).astype(np.uint32)) for w in wbe)
        + (jnp.asarray(ps.reshape(-1).astype(np.int32)),), **kw)
    pl, pd = lcp_candidates_torch(words, ps32, prefer_far=tie == "far", **kw)
    assert np.array_equal(np.asarray(rl), pl.numpy())
    assert np.array_equal(np.asarray(rd), pd.numpy())
    near = lcp_candidates_torch(words, ps32, **kw)
    far = lcp_candidates_torch(words, ps32, prefer_far=True, **kw)
    assert torch.equal(near[0], far[0])  # the rule changes distances, never lengths
    assert (far[1] > near[1]).sum() > 100 and not (far[1] < near[1]).any()


@pytest.mark.parametrize("run_ext", [True, False])
def test_post_match_run_ext_matches_reference(jax_cpu, monkeypatch, run_ext):
    """``_post_match(run_ext=...)`` against the reference's under
    COMPU_RUN_EXT, from the same sorted candidates."""
    import jax.numpy as jnp

    from compu_tpu.kernels.deflate_jax_v2 import _post_match as ref_post

    if run_ext:
        monkeypatch.delenv("COMPU_RUN_EXT", raising=False)
    else:
        monkeypatch.setenv("COMPU_RUN_EXT", "0")
    blocks, lens = _blocks()
    wcap = 32
    _, ps, words, ps32 = _sorted(blocks, wcap, 2)
    bl, bd = lcp_candidates_torch(words, ps32, depth=8, max_dist=32768, block_elems=N)
    bl, bd = bl.reshape(3, N).to(torch.int64), bd.reshape(3, N).to(torch.int64)
    port = _post_match(torch.from_numpy(blocks), torch.from_numpy(lens).to(torch.int64),
                       torch.from_numpy(ps), bl, bd, wcap=wcap, run_ext=run_ext)
    for b in range(3):
        ref = ref_post(jnp.asarray(blocks[b]), jnp.int32(lens[b]),
                       jnp.asarray(ps[b].astype(np.int32)), jnp.asarray(bl[b].numpy(), jnp.int32),
                       jnp.asarray(bd[b].numpy(), jnp.int32), max_len=258, wcap=wcap)
        for r, p in zip(ref, port):
            assert np.array_equal(np.asarray(r).astype(np.int64), p[b].numpy().astype(np.int64))
    other = _post_match(torch.from_numpy(blocks), torch.from_numpy(lens).to(torch.int64),
                        torch.from_numpy(ps), bl, bd, wcap=wcap, run_ext=not run_ext)
    assert not torch.equal(port[1], other[1])  # the runs make the switch matter


REF_ENCODE = """
import json, sys
import numpy as np
sys.path.insert(0, {root!r})
import jax.numpy as jnp
from compu_tpu.kernels.deflate_jax_v3 import encode_block_dyn
block = np.load({path!r})
out, meta, seg = encode_block_dyn(jnp.asarray(block), jnp.int32({n}), depth=8,
                                  with_index=True, check="crc")
m = int(np.asarray(meta)[0])
print(json.dumps({{"out": np.asarray(out)[:m].tobytes().hex(),
                  "meta": np.asarray(meta).tolist(), "seg": np.asarray(seg).tolist()}}))
"""


def test_encode_block_variants_match_reference(jax_cpu, tmp_path):
    """One 16 KiB block through ``encode_block_dyn`` with each variant
    against the reference's, each traced in a fresh interpreter with its
    variable set (both run at once)."""
    block, n = _block_case()
    path = tmp_path / "block.npy"
    np.save(path, block)
    variants = {"far": ({"COMPU_LCP_TIE": "far"}, dict(prefer_far=True)),
                "no_run_ext": ({"COMPU_RUN_EXT": "0"}, dict(run_ext=False))}
    code = REF_ENCODE.format(root=str(ROOT), path=str(path), n=n)
    procs = {}
    for name, (env, _) in variants.items():
        full = {k: v for k, v in os.environ.items()
                if k not in ("COMPU_LCP_TIE", "COMPU_RUN_EXT")}
        procs[name] = subprocess.Popen([sys.executable, "-c", code],
                                       env={**full, "JAX_PLATFORMS": "cpu", **env},
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    refs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, err[-3000:]
            refs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    enc = functools.partial(encode_block_dyn, torch.from_numpy(block), n, depth=8,
                            with_index=True, check="crc")
    default = enc()
    for name, (_, kw) in variants.items():
        out, meta, seg = enc(**kw)
        ref = refs[name]
        assert meta.tolist() == ref["meta"], name
        assert out[: ref["meta"][0]].numpy().tobytes().hex() == ref["out"], name
        assert seg.tolist() == ref["seg"], name
        assert not torch.equal(out, default[0]), name  # the variant is live on this block


@pytest.mark.gpu
def test_far_tie_kernel_matches_twin_gpu(cuda):
    """Both tie rules of B1 against the plain twin on the card, at the
    ladder's template depths and a runtime depth."""
    blocks, _ = _blocks()
    for wcap, keys in [(16, 2), (32, 2)]:
        *wbe, ps = sort_stage_lex(torch.from_numpy(blocks).to(cuda), wcap=wcap, keys=keys)
        words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe])).contiguous()
        ps = ps.reshape(-1).to(torch.int32).contiguous()
        for depth in (8, 16, 5):
            for far in (False, True):
                kw = dict(depth=depth, max_dist=32768, block_elems=N, prefer_far=far)
                k = lcp_candidates_cuda(words, ps, **kw)
                t = lcp_candidates_torch(words, ps, **kw)
                assert torch.equal(k[0], t[0]) and torch.equal(k[1], t[1]), (wcap, depth, far)
