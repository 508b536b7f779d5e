"""P1's transition table (``csrc/fse_seq_scan.cu``) against the scan's
plain version and the JAX reference, on the CPU.

The kernel builds, in a prologue, one uint16 entry per (channel, symbol,
state) and walks each chain as one table read a step.
``fse_transition_table_torch`` builds the same table; walking it here as
the kernel does must give ``fse_seq_scan_torch``'s pushes and final states
exactly, and through the pack the reference's ``_seq_bitstream`` bytes
(tolerance 0: all integers), for real ``FseEncodeTable``s: the predefined
LL/ML/OF distributions, compressed tables at table_log 5-9, and channels
in RLE mode. The tests marked ``gpu`` hold the kernel to the twin at the
largest table logs.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from compu_tpu_torch.formats.zstd import tables as T  # noqa: E402
from compu_tpu_torch.formats.zstd.fse import FseEncodeTable  # noqa: E402
from compu_tpu_torch.formats.zstd.huff import normalize_counts  # noqa: E402
from compu_tpu_torch.kernels import zstd_seq  # noqa: E402

#: (default distribution, default log, alphabet, largest log) per channel.
CHANNELS = ((T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG, T.MAX_LL_SYMBOL + 1, T.MAX_LL_LOG),
            (T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG, T.MAX_ML_SYMBOL + 1, T.MAX_ML_LOG),
            (T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG, T.MAX_OF_SYMBOL + 1, T.MAX_OF_LOG))
CASES = ["predefined", "log5", "log6", "log7", "log8", "log9", "rle_ml", "rle_ll_of"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _channel(rng, c: int, kind: str, n: int):
    """One channel's table (None in RLE mode) and n codes that it counts."""
    dist, dlog, nsym, max_log = CHANNELS[c]
    if kind == "predefined":
        norm, log = np.asarray(dist, np.int64), dlog
    else:
        log = min(int(kind[3:]), max_log)
        used = rng.choice(nsym, min(nsym * 2 // 3, 1 << (log - 1)), replace=False)
        freqs = np.zeros(nsym, np.int64)
        freqs[used] = (rng.pareto(1.2, len(used)) * 40).astype(np.int64) + 1
        # A sample of 2^(log + 2) or more gives the log asked for.
        freqs *= -(-(1 << (log + 3)) // int(freqs.sum()))
        norm, log = normalize_counts(freqs, int(freqs.sum()), log)
        assert norm is not None and log == min(int(kind[3:]), max_log)
    norm = np.asarray(norm, np.int64)
    syms = np.nonzero(norm)[0]
    p = np.abs(norm[syms]).astype(np.float64)
    codes = rng.choice(syms, n, p=p / p.sum()).astype(np.int32)
    return FseEncodeTable([int(x) for x in norm], log), codes


def _case(kind: str, n: int, seed: int = 0):
    """Scan inputs for n sequences: three tables of ``kind`` (a channel
    named in an ``rle_*`` kind has no table and one code throughout)."""
    rng = np.random.default_rng(seed)
    tabs, codes = [], []
    for c, name in enumerate(("ll", "ml", "of")):
        if kind.startswith("rle") and name in kind:
            tabs.append(None)
            codes.append(np.full(n, 3, np.int32))
            continue
        t, k = _channel(rng, c, "log9" if kind.startswith("rle") else kind, n)
        tabs.append(t)
        codes.append(k)
    P = 1 << max(4, (n - 1).bit_length())
    return zstd_seq.scan_inputs(*codes, *tabs, P, "cpu"), tabs


def _walk(codes, inits, st, dnb, df, logs, ens, nseq: int):
    """The kernel's walk over its table, step by step: the row of the
    step's symbol plus the chain's byte offset, one read a step."""
    flat, base = zstd_seq.fse_transition_table_torch(st, dnb, df, logs, ens)
    flat = flat.numpy()
    P = codes.shape[1]
    push_v = np.repeat(inits.numpy()[None].astype(np.int64), P, 0)
    push_b = np.zeros((P, 3), np.int64)
    final = inits.numpy().astype(np.int64)
    steps = nseq - 1
    for c in range(3):
        if int(ens[c]) <= 0:
            continue
        lg = int(logs[c])
        one = 1 << lg
        off = ((int(inits[c]) - one) & (one - 1)) << 1
        syms = np.minimum(codes[c].numpy(), zstd_seq.TABLE_SYMS[c] - 1)
        for j in range(steps):
            row = 2 * (base[c] + (int(syms[nseq - 2 - j]) << lg))
            e = int(flat[(row + off) >> 1])
            push_v[j, c] = (off >> 1) + one
            push_b[j, c] = e >> 12
            off = e & 0x3FE
        final[c] = (off >> 1) + one
        push_v[steps:, c] = final[c]
    return (torch.from_numpy(push_v.astype(np.int32)), torch.from_numpy(push_b.astype(np.int32)),
            torch.from_numpy(final.astype(np.int32)))


@pytest.mark.parametrize("kind", CASES)
def test_table_walk_equals_twin_and_reference(kind):
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from compu_tpu.kernels.zstd_seq_jax import _seq_bitstream

    n = 1500
    (codes, inits, st, dnb, df, logs, ens), tabs = _case(kind, n, seed=len(kind))
    assert [t is None for t in tabs] == [kind.startswith("rle") and name in kind
                                         for name in ("ll", "ml", "of")]
    walked = _walk(codes, inits, st, dnb, df, logs, ens, n)
    twin = zstd_seq.fse_seq_scan_torch(codes, inits, st, dnb, df, ens, logs, n)
    assert all(torch.equal(w, t) for w, t in zip(walked, twin))

    rng = np.random.default_rng(99)
    P = codes.shape[1]
    xbits = rng.integers(0, 6, (3, P)).astype(np.int32)
    xvals = (rng.integers(0, 1 << 20, (3, P)) & ((1 << xbits) - 1)).astype(np.int32)
    cap = (P * 6 * 32) // 8 + 64
    out, total = zstd_seq._pack(*walked, torch.from_numpy(xvals), torch.from_numpy(xbits),
                                logs, ens, n, cap)
    ref, ref_total = _seq_bitstream(
        *(jnp.asarray(a) for a in (codes.numpy(), xvals, xbits, inits.numpy(), st.numpy(),
                                   dnb.numpy(), df.numpy(), logs.numpy(), ens.numpy())),
        n, cap=cap)
    assert int(total) == int(ref_total)
    nbytes = (int(total) + 7) // 8
    assert out[:nbytes].numpy().tobytes() == np.asarray(ref)[:nbytes].tobytes()


@pytest.mark.parametrize("kind", ["log5", "log9"])
def test_table_layout_and_size(kind):
    """Each enabled channel's rows are TABLE_SYMS[c] x 2^log entries, one
    after another, within the kernel's reserved 123,904 bytes; every entry
    names a state of its row and at most table_log bits."""
    (_, _, st, dnb, df, logs, ens), _ = _case(kind, 200)
    flat, base = zstd_seq.fse_transition_table_torch(st, dnb, df, logs, ens)
    sizes = [zstd_seq.TABLE_SYMS[c] << int(logs[c]) for c in range(3)]
    assert base == [0, sizes[0], sizes[0] + sizes[1]]
    assert flat.numel() == sum(sizes) and 2 * flat.numel() <= 123904
    assert int(flat.max()) < 1 << 16 and int((flat >> 12).max()) <= int(logs.max())
    assert all(int((flat[base[c]:base[c] + sizes[c]] & 0x3FF).max()) < 2 << int(logs[c])
               for c in range(3))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 17, 7000, 14884])
@pytest.mark.parametrize("kind", ["log9", "rle_ml", "rle_ll_of"])
def test_kernel_equals_twin_at_largest_logs_gpu(cuda, n, kind):
    """The kernel at table logs 9, 9 and 8 (the largest table), with and
    without RLE channels."""
    args, _ = _case(kind, n, seed=n)
    codes, inits, st, dnb, df, logs, ens = (a.to(cuda) for a in args)
    got = zstd_seq.fse_seq_scan_cuda(codes, inits, st, dnb, df, ens, logs, n)
    want = zstd_seq.fse_seq_scan_torch(codes, inits, st, dnb, df, ens, logs, n)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
