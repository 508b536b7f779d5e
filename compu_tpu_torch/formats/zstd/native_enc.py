"""ctypes wrappers for the zstd encoder's loops in the host runtime
(``runtime/csrc/compu_zstd_enc.cpp``): the port's copy of
``compu_tpu/formats/zstd/native_enc.py``. Each gives the bytes or arrays
of its pure-Python twin in ``encode.py``/``huff.py``, which the tests hold
it against; the encoder calls these wherever the reference's does:

* ``seq_from_tokens``: a token cover to sequences (``_sequences_from_tokens``);
* ``resolve_offsets``: repeat-offset resolution (``_resolve_offset_values``);
* ``seq_bitstream``: the sequences' FSE bitstream (the push loop of
  ``_sequences_section``);
* ``huf_stream``: one Huffman literal stream (``HufEncoder.encode_stream``);
* ``fse_pair_stream``: the two-state FSE weight stream
  (``HufEncoder._describe_fse``);
* ``optimal_parse``: one round of the host route's cost-model parse
  (``_zstd_optimal_tokens``; its twin is ``_optimal_dp_py``);
* ``promote_rep``: the host route's repeat-offset promotion
  (``_promote_rep_offsets``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...runtime import native


def seq_from_tokens(data: bytes, tok_pos, tok_len, tok_dist):
    """Token cover -> (literals bytes, (ll, off, ml) int32 arrays)."""
    lib = native.lib()
    ntok = len(tok_pos)
    tp = np.ascontiguousarray(tok_pos, dtype=np.int64)
    tl = np.ascontiguousarray(tok_len, dtype=np.int64)
    td = np.ascontiguousarray(tok_dist, dtype=np.int64)
    out_ll = np.empty(ntok + 1, dtype=np.int32)
    out_off = np.empty(ntok + 1, dtype=np.int32)
    out_ml = np.empty(ntok + 1, dtype=np.int32)
    out_lits = ctypes.create_string_buffer(len(data) + 1)
    lits_len = ctypes.c_longlong(0)
    nseq = lib.compu_zstd_seq_from_tokens(
        bytes(data), ntok,
        tp.ctypes.data, tl.ctypes.data, td.ctypes.data,
        out_ll.ctypes.data, out_off.ctypes.data, out_ml.ctypes.data,
        out_lits, ctypes.byref(lits_len),
    )
    lits = out_lits.raw[: lits_len.value]
    return lits, (out_ll[:nseq], out_off[:nseq], out_ml[:nseq])


def resolve_offsets(ll_arr, off_arr, rep_in):
    """Repeat-offset resolution. Returns (OF values int64 array, rep_out)."""
    n = len(ll_arr)
    ll = np.ascontiguousarray(ll_arr, dtype=np.int32)
    off = np.ascontiguousarray(off_arr, dtype=np.int32)
    rep = np.asarray(list(rep_in) if rep_in is not None else [1, 4, 8], dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    native.lib().compu_zstd_resolve_offsets(
        ll.ctypes.data, off.ctypes.data, n, rep.ctypes.data, out.ctypes.data)
    return out, [int(rep[0]), int(rep[1]), int(rep[2])]


def _enc_args(table):
    """(has, state_table, delta_nbits, delta_find, log) for a channel."""
    if table is None:
        return (0, None, None, None, 0)
    st = np.ascontiguousarray(table.state_table, dtype=np.int64)
    dn = np.ascontiguousarray(table.delta_nbits, dtype=np.int64)
    df = np.ascontiguousarray(table.delta_find, dtype=np.int64)
    return (1, st, dn, df, table.table_log)  # the arrays live until the call returns


def seq_bitstream(ll_codes, ml_codes, of_codes, ll_x, ll_xb, ml_x, ml_xb,
                  of_x, of_xb, ll_enc, ml_enc, of_enc) -> bytes:
    """The sequences' bitstream: every sequence's extras and the three
    channels' FSE state updates, pushed in the reverse of the decoder's
    read order, then the states' flushes."""
    n = len(ll_codes)
    if n == 0:
        return b""
    a = lambda x, dt: np.ascontiguousarray(x, dtype=dt)  # noqa: E731
    llc, mlc, ofc = a(ll_codes, np.int32), a(ml_codes, np.int32), a(of_codes, np.int32)
    llx, llxb = a(ll_x, np.int32), a(ll_xb, np.int32)
    mlx, mlxb = a(ml_x, np.int32), a(ml_xb, np.int32)
    ofx, ofxb = a(of_x, np.int64), a(of_xb, np.int32)
    chans = [_enc_args(t) for t in (ll_enc, ml_enc, of_enc)]
    cap = n * 16 + 64
    out = ctypes.create_string_buffer(cap)

    def flat(t):
        has, st, dn, df, log = t
        return [has] + [x.ctypes.data if x is not None else None for x in (st, dn, df)] + [log]

    r = native.lib().compu_zstd_seq_bitstream(
        n,
        llc.ctypes.data, mlc.ctypes.data, ofc.ctypes.data,
        llx.ctypes.data, llxb.ctypes.data,
        mlx.ctypes.data, mlxb.ctypes.data,
        ofx.ctypes.data, ofxb.ctypes.data,
        *flat(chans[0]), *flat(chans[1]), *flat(chans[2]),
        out, cap,
    )
    if r < 0:
        raise RuntimeError(f"compu_zstd_seq_bitstream overflowed its {cap}-byte buffer")
    return out.raw[:r]


def huf_stream(data: bytes, code, nbits) -> bytes:
    """One Huffman literal stream (backward bit order, sentinel ended)."""
    c = np.ascontiguousarray(code, dtype=np.uint32)
    nb = np.ascontiguousarray(nbits, dtype=np.int32)
    if len(c) < 256:
        c = np.concatenate([c, np.zeros(256 - len(c), np.uint32)])
        nb = np.concatenate([nb, np.zeros(256 - len(nb), np.int32)])
    cap = len(data) * 2 + 64
    out = ctypes.create_string_buffer(cap)
    r = native.lib().compu_huf_encode_stream(
        bytes(data), len(data), c.ctypes.data, nb.ctypes.data, out, cap)
    if r < 0:
        raise RuntimeError(f"compu_huf_encode_stream overflowed its {cap}-byte buffer")
    return out.raw[:r]


def optimal_parse(full: bytes, hist_len: int, n: int, lens_k, dists_k,
                  litcost, mlcost_len, dc_k, rep_dc: float, sublens,
                  rep0_init: int):
    """The btultra DP relax loop and backtrack (the twin of the Python loop
    in the reference's ``encode.py::_zstd_optimal_tokens``). Returns (pos,
    len, dist) int64 arrays."""
    K = lens_k.shape[1]
    lk = np.ascontiguousarray(lens_k, dtype=np.int64)
    dk = np.ascontiguousarray(dists_k, dtype=np.int64)
    lc = np.ascontiguousarray(litcost, dtype=np.float64)
    mc = np.zeros(256, dtype=np.float64)
    mc[: len(mlcost_len)] = mlcost_len
    dck = np.ascontiguousarray(dc_k, dtype=np.float64)
    sl = np.ascontiguousarray(sublens, dtype=np.int32)
    out_pos = np.empty(n + 1, dtype=np.int32)
    out_len = np.empty(n + 1, dtype=np.int32)
    out_dist = np.empty(n + 1, dtype=np.int32)
    t = native.lib().compu_zstd_optimal_parse(
        bytes(full), hist_len, n,
        lk.ctypes.data, dk.ctypes.data, K,
        lc.ctypes.data, mc.ctypes.data, dck.ctypes.data,
        float(rep_dc), sl.ctypes.data, len(sl), int(rep0_init),
        out_pos.ctypes.data, out_len.ctypes.data, out_dist.ctypes.data)
    if t < 0:
        raise MemoryError("compu_zstd_optimal_parse could not allocate its tables")
    return (out_pos[:t].astype(np.int64), out_len[:t].astype(np.int64),
            out_dist[:t].astype(np.int64))


def promote_rep(full: bytes, hist_len: int, seqs, rep_in):
    """Repeat-offset promotion (the twin of the reference's
    ``_promote_rep_offsets``). ``seqs`` is an (n, 3) array or list of
    (ll, off, ml). Returns the promoted (n, 3) int64 array."""
    sa = np.asarray(seqs, dtype=np.int64)
    n = len(sa)
    ll = np.ascontiguousarray(sa[:, 0], dtype=np.int32)
    off = np.ascontiguousarray(sa[:, 1], dtype=np.int32)
    ml = np.ascontiguousarray(sa[:, 2], dtype=np.int32)
    rep = np.asarray(list(rep_in) if rep_in is not None else [1, 4, 8], dtype=np.int64)
    native.lib().compu_zstd_promote_rep(
        bytes(full), len(full), hist_len,
        ll.ctypes.data, off.ctypes.data, ml.ctypes.data, n, rep.ctypes.data)
    return np.stack([ll.astype(np.int64), off.astype(np.int64), ml.astype(np.int64)], axis=1)


def fse_pair_stream(syms, enc) -> bytes | None:
    """The two-state FSE weight stream (``huff.py::_describe_fse``'s loop):
    state A codes the even positions, B the odd. None for fewer than two
    symbols, where the loop has no pair of states either."""
    s = bytes(bytearray(syms))
    if len(s) < 2:
        return None
    st = np.ascontiguousarray(enc.state_table, dtype=np.int64)
    dn = np.ascontiguousarray(enc.delta_nbits, dtype=np.int64)
    df = np.ascontiguousarray(enc.delta_find, dtype=np.int64)
    cap = len(s) * 4 + 64
    out = ctypes.create_string_buffer(cap)
    r = native.lib().compu_fse_pair_stream(
        s, len(s), st.ctypes.data, dn.ctypes.data, df.ctypes.data, enc.table_log, out, cap)
    if r < 0:
        raise RuntimeError(f"compu_fse_pair_stream overflowed its {cap}-byte buffer")
    return out.raw[:r]
