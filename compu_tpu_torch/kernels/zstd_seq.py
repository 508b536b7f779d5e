"""The zstd sequences bitstream on the device (RFC 8878 §3.1.1.4).

Port of ``compu_tpu/kernels/zstd_seq_jax.py`` (``_chan_arrays``,
``_seq_bitstream``, ``encode_sequences_device``). The host builds the
three FSE encode tables (LL, ML, OF) and chooses the modes; the device
runs the interleaved state chains and packs the bitstream, byte for byte
the host ``ForwardBitWriter`` push loop's output.

The state chains are sequential: the reference ran them as one
``lax.scan``. Here ``fse_seq_scan`` runs them as one CUDA kernel launch
(``csrc/fse_seq_scan.cu``) for a CUDA tensor, and as a Python loop over
tensors, ``fse_seq_scan_torch``, for a CPU tensor. The pack that follows
(a cumsum of the field widths, then four byte-lane scatter-adds) is plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

STBL = 512  # max FSE table size (table_log <= 9 for LL/ML, 8 for OF)
NSYM = 64   # max symbol count (LL 36, ML 53, OF ~32)


def _chan_arrays(table):
    """Pad one FseEncodeTable (or None) to fixed shapes: (state_table,
    delta_nbits, delta_find, table_log, enabled)."""
    st = np.zeros(STBL, np.int32)
    dnb = np.zeros(NSYM, np.int32)
    df = np.zeros(NSYM, np.int32)
    if table is None:
        return st, dnb, df, np.int32(0), np.int32(0)
    n = 1 << table.table_log
    st[:n] = table.state_table
    k = len(table.delta_nbits)
    dnb[:k] = table.delta_nbits
    df[:k] = table.delta_find
    return st, dnb, df, np.int32(table.table_log), np.int32(1)


def _check_scan(codes, inits, st, dnb, df, ens, logs, nseq: int) -> int:
    """Validate the scan's arguments; returns P."""
    if codes.dim() != 2 or codes.shape[0] != 3:
        raise ValueError(f"codes must be (3, P), got {tuple(codes.shape)}")
    P = codes.shape[1]
    if not 1 <= nseq <= P:
        raise ValueError(f"nseq must be in [1, {P}], got {nseq}")
    for name, t, shape in (("inits", inits, (3,)), ("st", st, (3, STBL)),
                           ("dnb", dnb, (3, NSYM)), ("df", df, (3, NSYM)),
                           ("ens", ens, (3,)), ("logs", logs, (3,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    return P


def fse_seq_scan_torch(codes, inits, st, dnb, df, ens, logs, nseq: int):
    """Plain version: the three channels' state chains, one step a loop
    iteration. ``codes`` (3, P) int32 symbols in sequence order (rows LL,
    ML, OF), ``inits`` (3,) the states after sequence nseq-1, ``st`` (3,
    512), ``dnb``/``df`` (3, 64) the tables, ``ens`` (3,) 1 where a channel
    has a table, ``logs`` (3,) the table logs (the kernel's table layout;
    unused here). Step j codes sequence nseq-2-j. Returns ``push_v`` and
    ``push_b`` (P, 3) int32, the state pushed at each step and its bit
    count (0 for a channel without a table and for rows j >= nseq-1, which
    hold the final state), and the final states (3,) int32."""
    P = _check_scan(codes, inits, st, dnb, df, ens, logs, nseq)
    dev = codes.device
    steps = nseq - 1
    push_v = inits.to(torch.int64).repeat(P, 1)
    push_b = torch.zeros(P, 3, dtype=torch.int64, device=dev)
    # Only the channels with a table step; the others keep their state and
    # push 0 bits.
    on = torch.nonzero(ens > 0).reshape(-1)
    if steps and on.numel():
        order = torch.arange(nseq - 2, -1, -1, device=dev)
        sym = codes.to(torch.int64)[on][:, order]
        dn = dnb.to(torch.int64)[on].gather(1, sym).T.contiguous()  # (steps, k)
        fd = df.to(torch.int64)[on].gather(1, sym).T.contiguous()
        tab = st.to(torch.int64)[on].reshape(-1)
        row = torch.arange(on.numel(), device=dev) * STBL
        state = inits.to(torch.int64)[on]
        vs, bs = [], []
        for j in range(steps):
            nb = (state + dn[j]) >> 16
            vs.append(state)
            bs.append(nb)
            idx = ((state >> nb.clamp(min=0)) + fd[j]).clamp_(0, STBL - 1)
            state = torch.take(tab, idx + row)
        push_v[:steps, on] = torch.stack(vs)
        push_b[:steps, on] = torch.stack(bs)
        push_v[steps:, on] = state
    return push_v.to(torch.int32), push_b.to(torch.int32), push_v[-1].to(torch.int32)


def fse_seq_scan_cuda(codes, inits, st, dnb, df, ens, logs, nseq: int):
    """The CUDA kernel (``csrc/fse_seq_scan.cu``); the contract of
    :func:`fse_seq_scan_torch` under the kernel's precondition, which every
    section the encoder writes meets: each channel with a table starts in
    a state of [2^log, 2^(log+1)) (``init_state`` gives one) and codes only
    symbols that its table counts (the encoder builds each table from the
    symbols it codes). The kernel's per-(symbol, state) transition table
    covers just those; :func:`fse_transition_table_torch` is its model."""
    from .. import _build

    _build.require(codes, "codes", ndim=2)
    for name, t, ndim in (("inits", inits, 1), ("st", st, 2), ("dnb", dnb, 2),
                          ("df", df, 2), ("ens", ens, 1), ("logs", logs, 1)):
        _build.require(t, name, ndim=ndim)
        if t.device != codes.device:
            raise ValueError(f"{name} must be on {codes.device}")
    P = _check_scan(codes, inits, st, dnb, df, ens, logs, nseq)
    push_v = torch.empty(P, 3, dtype=torch.int32, device=codes.device)
    push_b = torch.empty_like(push_v)
    final = torch.empty(3, dtype=torch.int32, device=codes.device)
    err = _build.lib().compu_fse_seq_scan(
        codes.data_ptr(), P, nseq, inits.data_ptr(), st.data_ptr(), dnb.data_ptr(),
        df.data_ptr(), ens.data_ptr(), logs.data_ptr(), push_v.data_ptr(),
        push_b.data_ptr(), final.data_ptr(), _build.stream_handle(codes))
    _build.check_launch(err, "fse_seq_scan")
    return push_v, push_b, final


def fse_seq_scan(codes, inits, st, dnb, df, ens, logs, nseq: int):
    """The state chains: the kernel on CUDA, the plain version on the
    CPU."""
    kind = codes.device.type
    if kind == "cuda":
        return fse_seq_scan_cuda(codes, inits, st, dnb, df, ens, logs, nseq)
    if kind == "cpu":
        return fse_seq_scan_torch(codes, inits, st, dnb, df, ens, logs, nseq)
    raise ValueError(f"no fse_seq_scan for device {codes.device}")


#: Symbols each channel's rows of the kernel's transition table cover
#: (MAX_{LL,ML,OF}_SYMBOL + 1), as ``csrc/fse_seq_scan.cu``'s kSyms*.
TABLE_SYMS = (36, 53, 32)


def fse_transition_table_torch(st, dnb, df, logs, ens):
    """The kernel's transition table as its prologue builds it, for the
    tests: per enabled channel c, symbol s < TABLE_SYMS[c] and state offset
    u < 2^log, the uint16 entry ``2 * (next - 2^log) | nb << 12`` of the
    step from state 2^log + u coding s (the twin's nb, clamp and
    max(nb, 0); out-of-range ``next`` masked into the row). Returns the
    flat table as int32 holding the uint16 words (the channels' rows one
    after another, a disabled channel none) and each channel's first
    entry."""
    rows, base, at = [], [], 0
    for c in range(3):
        base.append(at)
        if int(ens[c]) <= 0:
            continue
        lg = min(max(int(logs[c]), 0), 9)
        size = 1 << lg
        n = TABLE_SYMS[c] << lg
        e = torch.arange(n, dtype=torch.int64)
        s = e >> lg
        state = size + (e & (size - 1))
        nb = (state + dnb[c].to(torch.int64)[s]) >> 16
        idx = ((state >> nb.clamp(min=0)) + df[c].to(torch.int64)[s]).clamp(0, STBL - 1)
        nxt = st[c].to(torch.int64)[idx]
        rows.append((((nxt - size) & (size - 1)) << 1) | ((nb & 15) << 12))
        at += n
    flat = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.int64)
    return flat.to(torch.int32), base


def _pack(push_v, push_b, final, xvals, xbits, logs, ens, nseq: int, cap: int):
    """The push list in the writer's order, packed: for each sequence the
    of, ml, ll state pushes then its ll, ml, of extra bits; the last
    sequence's extras first, the three flushes and the sentinel bit last.
    Returns (bytes (cap,) uint8, total bits as a 0-dim tensor)."""
    P = xvals.shape[1]
    dev = xvals.device
    idx = nseq - 2 - torch.arange(P, device=dev)
    valid = idx >= 0
    at = torch.clamp(idx, 0, P - 1)
    xv = xvals.to(torch.int64)[:, at]
    xb = xbits.to(torch.int64)[:, at]
    pv, pb = push_v.to(torch.int64), push_b.to(torch.int64)
    fields_v = torch.stack([pv[:, 2], pv[:, 1], pv[:, 0], xv[0], xv[1], xv[2]], 1)
    fields_b = torch.stack([pb[:, 2], pb[:, 1], pb[:, 0], xb[0], xb[1], xb[2]], 1)
    fields_b = torch.where(valid[:, None], fields_b, 0)
    last = min(max(nseq - 1, 0), P - 1)
    logs_on = torch.where(ens > 0, logs, 0).to(torch.int64)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    fin = final.to(torch.int64)
    all_v = torch.cat([xvals[:, last].to(torch.int64), fields_v.reshape(-1),
                       fin[1:2], fin[2:3], fin[0:1], one])
    all_b = torch.cat([xbits[:, last].to(torch.int64), fields_b.reshape(-1),
                       logs_on[1:2], logs_on[2:3], logs_on[0:1], one])
    all_v = all_v & ((1 << all_b) - 1)
    end = torch.cumsum(all_b, 0)
    off = end - all_b
    shifted = torch.where(all_b > 0, all_v << (off & 7), 0)
    base = off >> 3
    out = torch.zeros(cap, dtype=torch.int64, device=dev)
    for k in range(4):  # a field is at most 25 bits + 7 of phase: 4 bytes
        out.scatter_add_(0, torch.clamp(base + k, 0, cap - 1), (shifted >> (8 * k)) & 0xFF)
    return (out & 0xFF).to(torch.uint8), end[-1]


def scan_inputs(ll_codes, ml_codes, of_codes, ll_t, ml_t, of_t, P: int, device):
    """The scan's tensors on ``device`` for n sequences padded to P:
    ``codes`` (3, P), ``inits`` (3,), ``st`` (3, 512), ``dnb`` and ``df``
    (3, 64), ``logs`` and ``ens`` (3,), all int32. A channel's table is
    None in RLE mode."""
    n = len(ll_codes)
    codes = np.zeros((3, P), np.int32)
    for row, c in enumerate((ll_codes, ml_codes, of_codes)):
        codes[row, :n] = c
    if codes.min() < 0 or codes.max() >= NSYM:
        raise ValueError(f"sequence codes must be in [0, {NSYM})")
    chans = [_chan_arrays(t) for t in (ll_t, ml_t, of_t)]
    inits = np.asarray([
        t.init_state(int(c[-1])) if t is not None else 0
        for t, c in ((ll_t, ll_codes), (ml_t, ml_codes), (of_t, of_codes))
    ], np.int32)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    st, dnb, df, logs, ens = (up(np.stack([c[k] for c in chans])) for k in range(5))
    return up(codes), up(inits), st, dnb, df, logs, ens


def encode_sequences_device(ll_codes, ml_codes, of_codes, ll_x, ml_x, of_x,
                            ll_xb, ml_xb, of_xb, ll_t, ml_t, of_t,
                            device) -> bytes:
    """The sequences bitstream on ``device``, byte for byte the host push
    loop's. The tables are the host's FseEncodeTable per channel (None for
    a channel in RLE mode: no state pushes). Returns the bitstream bytes,
    without the section headers the host wrote."""
    n = len(ll_codes)
    if n == 0:
        raise ValueError("no sequences to encode")
    P = 1 << max(4, (n - 1).bit_length())
    codes, inits, st, dnb, df, logs, ens = scan_inputs(
        ll_codes, ml_codes, of_codes, ll_t, ml_t, of_t, P, device)
    xvals = np.zeros((3, P), np.int32)
    xbits = np.zeros((3, P), np.int32)
    for row, (x, b) in enumerate(((ll_x, ll_xb), (ml_x, ml_xb), (of_x, of_xb))):
        xvals[row, :n] = x
        xbits[row, :n] = b
    push_v, push_b, final = fse_seq_scan(codes, inits, st, dnb, df, ens, logs, n)
    # worst-case bits: 6 fields x (25 bits) per seq + head/tail
    cap = (P * 6 * 32) // 8 + 64
    out, total_bits = _pack(push_v, push_b, final, torch.from_numpy(xvals).to(device),
                            torch.from_numpy(xbits).to(device), logs, ens, n, cap)
    nbytes = (int(total_bits) + 7) // 8
    return out[:nbytes].cpu().numpy().tobytes()
