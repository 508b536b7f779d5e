#!/usr/bin/env python3
"""P1 and P2 of this tree beside their design of commit da778ed, on one card.

    python3 ab_chains.py PARENT_DIR

``PARENT_DIR`` holds a checkout of commit da778ed (``git archive da778ed``
unpacked), whose ``compu_tpu_torch/csrc/fse_seq_scan.cu`` and
``huf_lit_decode.cu`` are the state-chain and literal-decode kernels
before their redesign. Both are built into a library of their own and
called through their C interface of that commit. On the inputs of
``chip_smoke.py``'s report (P1: the first MiB's largest sequences section;
P2: the largest literal section of the 16 MB corpus's zstd_device frame)
each design is held to the plain twin exactly and timed with
``chip_smoke.device_ms`` in turns, parent, this tree, this tree, parent,
with the cycles a step at the SM clock of a shared-memory chase measured
in the same run. Then the loops of each kernel in the SASS (``cuobjdump``)
that read shared memory are printed first: instructions by pipe, and
the opcode sequence in ``ab_chains_sass.txt`` beside the built libraries
(``compu_tpu_torch/_build/``). The last line is one JSON object with the
times.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import sys

import torch

import chip_smoke as cs
from compu_tpu_torch import _build
from compu_tpu_torch.kernels import zstd_lit_decode, zstd_seq

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGNATURES = {
    "compu_fse_seq_scan": (_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "compu_huf_decode_lanes": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P),
}


def parent_kernels(parent: pathlib.Path):
    """The parent's two kernels as callables with this tree's wrappers'
    arguments."""
    srcs = [parent / "compu_tpu_torch" / "csrc" / n for n in ("fse_seq_scan.cu",
                                                              "huf_lit_decode.cu")]
    lib = ctypes.CDLL(str(_build.build(srcs, "libcompu_parent")))
    for name, argtypes in PARENT_SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int

    def p1(codes, inits, st, dnb, df, ens, logs, nseq):
        P = codes.shape[1]
        pv = torch.empty(P, 3, dtype=torch.int32, device=codes.device)
        pb, fin = torch.empty_like(pv), torch.empty(3, dtype=torch.int32, device=codes.device)
        if lib.compu_fse_seq_scan(codes.data_ptr(), P, nseq, inits.data_ptr(), st.data_ptr(),
                                  dnb.data_ptr(), df.data_ptr(), ens.data_ptr(), pv.data_ptr(),
                                  pb.data_ptr(), fin.data_ptr(), _build.stream_handle(codes)):
            raise RuntimeError("the parent's fse_seq_scan failed to launch")
        return pv, pb, fin

    def p2(streams, bits0, counts, symbol, nbits, max_bits, max_steps):
        L, S = streams.shape[0], max_bits.shape[0]
        out = torch.empty(L, max_steps, dtype=torch.uint8, device=streams.device)
        ok = torch.empty(L, dtype=torch.bool, device=streams.device)
        host_ok = torch.empty_like(ok)
        if lib.compu_huf_decode_lanes(streams.data_ptr(), streams.shape[1], bits0.data_ptr(),
                                      counts.data_ptr(), symbol.data_ptr(), nbits.data_ptr(),
                                      max_bits.data_ptr(), L // S, S, out.data_ptr(), max_steps,
                                      ok.data_ptr(), host_ok.data_ptr(),
                                      _build.stream_handle(streams)):
            raise RuntimeError("the parent's huf_decode_lanes failed to launch")
        return out, ok, host_ok

    return _build.library_path(srcs, "libcompu_parent"), p1, p2


def side_by_side(name: str, parent_fn, kernel, twin, args, kw, steps: int, ghz: float) -> dict:
    """Both designs equal to the twin, then timed parent, tree, tree, parent."""
    want = twin(*args, **kw)
    for fn in (parent_fn, kernel):
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: a design differs from the plain twin")
    order = [("parent", parent_fn), ("tree", kernel), ("tree", kernel), ("parent", parent_fn)]
    times = {"parent": [], "tree": []}
    for label, fn in order:
        times[label].append(cs.device_ms(fn, args, kw, k=50))
    res = {"name": name, "steps": steps, "parent_ms": times["parent"], "tree_ms": times["tree"],
           "parent_cycles_per_step": [t * 1e6 * ghz / steps for t in times["parent"]],
           "tree_cycles_per_step": [t * 1e6 * ghz / steps for t in times["tree"]]}
    cs.log("ab " + json.dumps(res))
    return res


def dump_loops(label: str, lib_path, symbol: str, out) -> None:
    """Every loop of ``symbol`` that reads shared memory: its length, its
    instructions by pipe and its opcodes."""
    for body in cs.sass_loops(lib_path, symbol):
        ops = [op for _, op, _ in body]
        if not any(op.startswith("LDS") for op in ops):
            continue
        pipes = collections.Counter(str(cs._pipe(op)) for op in ops)
        line = (f"sass {label} {symbol} loop at 0x{body[0][0]:x}: {len(body)} instructions, "
                f"by pipe {json.dumps(dict(sorted(pipes.items())))}")
        cs.log(line)
        out.write(line + "\n")
        for addr, op, rest in body:
            out.write(f"  {addr:05x} {op}{rest.split(';')[0]}\n")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison needs one GPU")
    if len(sys.argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} PARENT_DIR")
    parent = pathlib.Path(sys.argv[1]).resolve()
    lib_parent, p1_parent, p2_parent = parent_kernels(parent)
    lib_tree = _build.build()
    with open(_build.BUILD_DIR / "ab_chains_sass.txt", "w") as fh:
        for label, lib in (("parent", lib_parent), ("tree", lib_tree)):
            for symbol in ("fse_seq_scan_kernel", "huf_decode_lanes_kernel"):
                dump_loops(label, lib, symbol, fh)
    chase = cs.smem_round_trip()
    ghz = chase["cycles"] / chase["ns"]
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    scan_args, scan_kw = cs.record_scan_inputs(corpus[:cs.ZSTD_SPAN])
    frame = cs.zstd_frame(corpus, torch.device("cuda"))
    out, kept = cs.record_lane_inputs(lambda: cs.zstd_decode(frame, torch.device("cuda")))
    if out != corpus:
        raise AssertionError("the decode of the zstd_device frame differs from the corpus")
    lane_kw = {"max_steps": kept["max_steps"]}
    steps2 = int(torch.clamp(kept["args"][2], 0, kept["max_steps"]).max())
    res = [side_by_side("fse_seq_scan", p1_parent, zstd_seq.fse_seq_scan_cuda,
                        zstd_seq.fse_seq_scan_torch, scan_args, scan_kw, scan_kw["nseq"] - 1, ghz),
           side_by_side("huf_decode_lanes", p2_parent, zstd_lit_decode.huf_decode_lanes_cuda,
                        zstd_lit_decode.huf_decode_lanes_torch, kept["args"], lane_kw, steps2,
                        ghz)]
    print(json.dumps({"sm_ghz": ghz, "smem_read": chase, "kernels": res}))


if __name__ == "__main__":
    main()
