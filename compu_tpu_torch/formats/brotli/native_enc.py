"""ctypes wrappers for the brotli encoder's loops in the host runtime
(``runtime/csrc/compu_brotli_enc.cpp``): the port's copy of
``compu_tpu/formats/brotli/native_enc.py``. Each gives the arrays or bits
of its pure-Python twin in ``encode.py`` (``_commands_from_tokens_py``,
``_plan_distances``, ``_emit_body_py``), which the tests hold it against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ...runtime import native
from ..base import CodecFailure
from . import consts as C


def commands_from_tokens(tok_pos, tok_len, tok_dist, max_copy: int):
    """Token cover -> (start, ins, cl, dist) arrays; dist -1 = trailing
    literal-only command."""
    ntok = len(tok_pos)
    tp = np.ascontiguousarray(tok_pos, dtype=np.int64)
    tl = np.ascontiguousarray(tok_len, dtype=np.int64)
    td = np.ascontiguousarray(tok_dist, dtype=np.int64)
    start = np.empty(ntok + 1, dtype=np.int64)
    ins = np.empty(ntok + 1, dtype=np.int64)
    cl = np.empty(ntok + 1, dtype=np.int64)
    dist = np.empty(ntok + 1, dtype=np.int64)
    ncmd = native.lib().compu_brotli_commands_from_tokens(
        ntok, tp.ctypes.data, tl.ctypes.data, td.ctypes.data, max_copy,
        start.ctypes.data, ins.ctypes.data, cl.ctypes.data, dist.ctypes.data)
    return start[:ncmd], ins[:ncmd], cl[:ncmd], dist[:ncmd]


def plan_distances(ic, cc, dist, ring_in):
    """Distance plan. Returns (dsym, dextra, dbits, ring_out): dsym -2 for
    a literal-only command, -1 for the implicit ring[0]."""
    n = len(ic)
    ica = np.ascontiguousarray(ic, dtype=np.int64)
    cca = np.ascontiguousarray(cc, dtype=np.int64)
    da = np.ascontiguousarray(dist, dtype=np.int64)
    ring = np.asarray(list(ring_in), dtype=np.int64)
    dsym = np.empty(n, dtype=np.int64)
    dextra = np.empty(n, dtype=np.int64)
    dbits = np.empty(n, dtype=np.int64)
    r = native.lib().compu_brotli_plan_distances(
        n, ica.ctypes.data, cca.ctypes.data, da.ctypes.data,
        ring.ctypes.data, dsym.ctypes.data, dextra.ctypes.data,
        dbits.ctypes.data)
    if r < 0:
        from .encode import ERR_ENC

        raise CodecFailure(ERR_ENC, "distance too large")
    return dsym, dextra, dbits, [int(x) for x in ring]


def emit_commands(data: bytes, tail2: bytes, start, ins, cl, dist,
                  ic, cc, cmd, dsym, dextra, dbits,
                  cmd_code, dist_code, lit_codes_list, cmap,
                  acc_in: int, nbits_in: int):
    """Body bitstream. Returns (bytes, acc_out, nbits_out)."""
    a = lambda x: np.ascontiguousarray(x, dtype=np.int64)  # noqa: E731
    ntrees = len(lit_codes_list)
    lit_codes = np.zeros((ntrees, 256), dtype=np.int64)
    lit_lens = np.zeros((ntrees, 256), dtype=np.int64)
    for t, pc in enumerate(lit_codes_list):
        lit_codes[t, : len(pc.codes)] = pc.codes
        lit_lens[t, : len(pc.lengths)] = pc.lengths
    cmd_codes = a(cmd_code.codes)
    cmd_lens = a(cmd_code.lengths)
    dist_codes = a(dist_code.codes)
    dist_lens = a(dist_code.lengths)
    cmap_a = a(cmap)
    lut0 = np.ascontiguousarray(C.CONTEXT_TABLE[1024:1280], dtype=np.uint8)
    lut1 = np.ascontiguousarray(C.CONTEXT_TABLE[1280:1536], dtype=np.uint8)
    n = len(data)
    ncmd = len(start)
    cap = n * 3 + ncmd * 10 + 1024
    out = ctypes.create_string_buffer(cap)
    acc_out = ctypes.c_uint64(0)
    nbits_out = ctypes.c_int(0)
    starts, inss, cls, dists = a(start), a(ins), a(cl), a(dist)
    ics, ccs, cmds = a(ic), a(cc), a(cmd)
    dsyms, dextras, dbitss = a(dsym), a(dextra), a(dbits)
    r = native.lib().compu_brotli_emit_commands(
        bytes(data), n, bytes(tail2), ncmd,
        starts.ctypes.data, inss.ctypes.data, cls.ctypes.data,
        dists.ctypes.data,
        ics.ctypes.data, ccs.ctypes.data, cmds.ctypes.data,
        dsyms.ctypes.data, dextras.ctypes.data, dbitss.ctypes.data,
        cmd_codes.ctypes.data, cmd_lens.ctypes.data,
        dist_codes.ctypes.data, dist_lens.ctypes.data,
        ntrees, lit_codes.ctypes.data, lit_lens.ctypes.data,
        cmap_a.ctypes.data, lut0.ctypes.data, lut1.ctypes.data,
        acc_in, nbits_in,
        out, cap, ctypes.byref(acc_out), ctypes.byref(nbits_out))
    if r < 0:
        raise RuntimeError(f"compu_brotli_emit_commands overflowed its {cap}-byte buffer")
    return out.raw[:r], int(acc_out.value), int(nbits_out.value)
