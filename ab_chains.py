#!/usr/bin/env python3
"""Redesigned kernels of this tree beside their earlier design, on one card.

    python3 ab_chains.py chains PARENT_DIR        # P1 and P2; PARENT_DIR: commit da778ed
    python3 ab_chains.py parse_cover PARENT_DIR   # B2; PARENT_DIR: commit f8599b4
    python3 ab_chains.py inflate_scan PARENT_DIR  # P3; PARENT_DIR: commit 21570d8

``PARENT_DIR`` holds a checkout of the commit named (``git archive``
unpacked). The earlier kernel is built from it into a library of its own
and called through its C interface of that commit.

``chains``: ``fse_seq_scan.cu`` and ``huf_lit_decode.cu`` of da778ed are
the state-chain and literal-decode kernels before their redesign. On the
inputs of ``chip_smoke.py``'s report (P1: the first MiB's largest
sequences section; P2: the largest literal section of the 16 MB corpus's
zstd_device frame) each design is held to the plain twin exactly and
timed with ``chip_smoke.device_ms`` in turns, parent, this tree, this
tree, parent, with the cycles a step at the SM clock of a shared-memory
chase measured in the same run. The loops of each kernel in the SASS
(``cuobjdump``) that read shared memory are printed first: instructions by
pipe, and the opcode sequence in ``ab_chains_sass.txt`` beside the built
libraries (``compu_tpu_torch/_build/``).

``parse_cover``: ``parse_cover.cu`` of f8599b4 is B2 before its redesign,
a kernel from the (S, 128) int32 jump targets to an int32 mask, one lane
of a warp walking each segment's orbit; that commit's whole function is
``jump_targets``, the kernel and ``> 0``. On the step arrays of
``chip_smoke.py``'s report (the gzip_lex path's first 16 blocks, 4,194,304
positions; the zstd path's first 1 MiB tokenizer call, 1,048,576) both
designs are held to the plain version exactly and timed in turns, empty
launch, copy floor, parent, this tree, this tree, parent, copy floor,
empty launch, beside B2's bound (``chip_smoke.parse_work``). The copy
floor (``smoke_csrc/copy_floor.cu``) moves B2's bytes, the steps in and a
byte a position out, and does no work; the empty launch is its grid with
nothing to do. Both kernels' loops that read shared memory go to
``ab_parse_cover_sass.txt``.

``inflate_scan``: ``inflate_scan.cu`` of 21570d8 is P3 before its
redesign, one 4-byte store a record slot from each thread's own row and a
bit container refilled from device memory; its C interface is this
tree's. On the first batch of ``chip_smoke.py``'s gzip_decode path (the
gzip_lex stream of the 16 MB corpus, 16 blocks of 256 KiB, 32,768 lanes)
at both of P3's shapes (``chip_smoke.p3_inputs``: the 12-bit tables at
(6, 26), the dyn route's 15-bit tables at (1, 128)) both designs are held
to the plain version exactly and timed in turns, empty launch, copy floor,
parent, this tree, this tree, parent, copy floor, empty launch, beside
P3's bound (``chip_smoke.inflate_scan_work``). The copy floor
(``compu_inflate_copy_floor`` in ``smoke_csrc/copy_floor.cu``) reads each
256-lane block's run of the stream and writes its rows of 511, coalesced,
on P3's grid, and does no work. Both kernels' loops that read shared
memory go to ``ab_inflate_scan_sass.txt``.

The last line is one JSON object with the times.
"""

from __future__ import annotations

import collections
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

import chip_smoke as cs
from compu_tpu_torch import _build
from compu_tpu_torch.kernels import inflate_scan, parse_cover, zstd_lit_decode, zstd_seq

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


def chains_main(parent: pathlib.Path) -> None:
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


def parse_cover_main(parent: pathlib.Path) -> None:
    srcs = [parent / "compu_tpu_torch" / "csrc" / "parse_cover.cu"]
    lib_parent = _build.build(srcs, "libcompu_parent_b2")
    walk = ctypes.CDLL(str(lib_parent)).compu_parse_cover
    walk.argtypes, walk.restype = [_P, _P, _LL, _P], ctypes.c_int
    smoke = ctypes.CDLL(str(_build.build(cs.SMOKE_SOURCES, "libcompu_smoke")))
    floor, empty = smoke.compu_copy_floor, smoke.compu_empty_launch
    floor.argtypes, floor.restype = [_P, _P, _LL, _P], ctypes.c_int
    empty.argtypes, empty.restype = [_LL, _P], ctypes.c_int

    def parent_design(step):
        nl = parse_cover.jump_targets(step)
        mask = torch.empty_like(nl)
        if walk(nl.data_ptr(), mask.data_ptr(), nl.shape[0], _build.stream_handle(nl)):
            raise RuntimeError("the parent's parse_cover failed to launch")
        return mask.reshape(-1) > 0

    def copy_floor(step):
        out = torch.empty(step.shape[0], dtype=torch.uint8, device=step.device)
        if floor(step.data_ptr(), out.data_ptr(), step.shape[0] // 128,
                 _build.stream_handle(step)):
            raise RuntimeError("compu_copy_floor failed to launch")
        return out

    def empty_launch(step):
        if empty(step.shape[0] // 128, _build.stream_handle(step)):
            raise RuntimeError("compu_empty_launch failed to launch")

    with open(_build.BUILD_DIR / "ab_parse_cover_sass.txt", "w") as fh:
        for label, lib in (("parent", lib_parent), ("tree", _build.build())):
            dump_loops(label, lib, "parse_cover_kernel", fh)
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    blocks, lens = cs.split_blocks(corpus)
    zstd_call = torch.from_numpy(np.frombuffer(corpus[:cs.ZSTD_SPAN], np.uint8).copy()[None]).cuda()
    inputs = cs.kernel_inputs(torch.from_numpy(blocks[:16]).cuda(),
                              torch.from_numpy(lens[:16]).cuda(),
                              torch.zeros(0, dtype=torch.uint8), zstd_call, None)
    res = []
    for path in ("gzip_lex", "zstd_device"):
        (step,), _ = inputs["parse_cover", path]
        want = parse_cover.parse_cover_steps_torch(step)
        for fn in (parent_design, parse_cover.parse_cover_cuda):
            got = fn(step)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"parse_cover ({path}): a design differs from the plain one")
        nbytes, ops = cs.parse_work((step,), {}, want)
        bound = max(nbytes / cs.HBM_BYTES_PER_S, ops / cs.INT32_OPS_PER_S) * 1e3
        times = {"empty_launch": [], "copy_floor": [], "parent": [], "tree": []}
        for label, fn in (("empty_launch", empty_launch), ("copy_floor", copy_floor),
                          ("parent", parent_design), ("tree", parse_cover.parse_cover_cuda),
                          ("tree", parse_cover.parse_cover_cuda), ("parent", parent_design),
                          ("copy_floor", copy_floor), ("empty_launch", empty_launch)):
            times[label].append(cs.device_ms(fn, (step,), {}, k=50))
        entry = {"name": "parse_cover", "path": path, "positions": step.numel(),
                 "bytes": nbytes, "ops": ops, "bound_ms": bound,
                 **{f"{k}_ms": v for k, v in times.items()},
                 **{f"{k}_share_of_bound": [bound / t for t in v] for k, v in times.items()}}
        cs.log("ab " + json.dumps(entry))
        res.append(entry)
    print(json.dumps({"kernels": res}))


def first_decode_batch(corpus: bytes) -> list:
    """The first batch ``BlockParallelDecoder()`` uploads when it decodes
    the gzip_lex stream of ``corpus`` (encoded on the card)."""
    enc, _ = cs.make_encoder("gzip_lex")
    stream, index = enc.encode(corpus)
    with cs.first_upload() as kept:
        out = cs.BlockParallelDecoder(block_size=cs.BLOCK).decode(stream, index)
    if out != corpus:
        raise AssertionError("the decode of the gzip_lex stream differs from the corpus")
    return kept


def inflate_scan_main(parent: pathlib.Path) -> None:
    lib_parent = _build.build([parent / "compu_tpu_torch" / "csrc" / "inflate_scan.cu"],
                              "libcompu_parent_p3")
    scan = ctypes.CDLL(str(lib_parent)).compu_inflate_scan
    scan.argtypes, scan.restype = list(_build._SIGNATURES["compu_inflate_scan"]), ctypes.c_int
    smoke = ctypes.CDLL(str(_build.build(cs.SMOKE_SOURCES, "libcompu_smoke")))
    floor, empty = smoke.compu_inflate_copy_floor, smoke.compu_empty_launch
    floor.argtypes = [_P, _LL, _I, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P]
    floor.restype = ctypes.c_int
    empty.argtypes, empty.restype = [_LL, _P], ctypes.c_int

    def outputs(comps, seg_bits, R):
        L = seg_bits.numel()
        return (torch.empty(L, R, dtype=torch.int32, device=comps.device),
                torch.empty(L, dtype=torch.int32, device=comps.device),
                torch.empty(L, dtype=torch.bool, device=comps.device))

    def parent_design(comps, seg_bits, ns, lit, dist, k, rsteps):
        rec, outp, bad = outputs(comps, seg_bits, k * rsteps)
        bits = lit.shape[1].bit_length() - 1
        if scan(comps.data_ptr(), comps.shape[1], comps.shape[0], seg_bits.data_ptr(),
                seg_bits.shape[1], ns.data_ptr(), lit.data_ptr(), dist.data_ptr(), bits, k,
                rsteps, rec.data_ptr(), outp.data_ptr(), bad.data_ptr(),
                _build.stream_handle(comps)):
            raise RuntimeError("the parent's inflate_scan failed to launch")
        return rec, outp, bad

    with open(_build.BUILD_DIR / "ab_inflate_scan_sass.txt", "w") as fh:
        for label, lib, symbol in (("parent", lib_parent, "inflate_scan_kernelILi12ELb1E"),
                                   ("tree", _build.build(), "inflate_scan_kernelILi12EE")):
            dump_loops(label, lib, symbol, fh)
    chase = cs.smem_round_trip()
    ghz = chase["cycles"] / chase["ns"]
    batch = first_decode_batch(cs.build_corpus(cs.CORPUS_BYTES))
    # Each block's bits up to its last non-zero byte, where its sync flush ends.
    nonzero = batch[0] != 0
    ends = ((nonzero.shape[1] - torch.argmax(nonzero.flip(1).to(torch.uint8), 1)) * 8).to(
        torch.int32)

    def copy_floor(comps, seg_bits, ns, lit, dist, k, rsteps):
        rec, outp, bad = outputs(comps, seg_bits, k * rsteps)
        if floor(comps.data_ptr(), comps.shape[1], comps.shape[0], seg_bits.data_ptr(),
                 seg_bits.shape[1], ns.data_ptr(), ends.data_ptr(), lit.data_ptr(),
                 dist.data_ptr(), lit.shape[1].bit_length() - 1, k * rsteps, rec.data_ptr(),
                 outp.data_ptr(), bad.data_ptr(), _build.stream_handle(comps)):
            raise RuntimeError("compu_inflate_copy_floor failed to launch")
        return rec, outp, bad

    def empty_launch(comps, seg_bits, *_, **__):
        if empty(seg_bits.numel() // 32, _build.stream_handle(comps)):
            raise RuntimeError("compu_empty_launch failed to launch")

    res = []
    for shape, (args, kw) in cs.p3_inputs(batch).items():
        want = inflate_scan.inflate_scan_torch(*args, **kw)
        for fn in (parent_design, inflate_scan.inflate_scan_cuda):
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"inflate_scan ({shape}): a design differs from the plain "
                                     f"one")
        nbytes, reads, chain = cs.inflate_scan_work(args, kw, want)
        bound = max(nbytes / cs.HBM_BYTES_PER_S * 1e3, chain["ops_ms"])
        times = {"empty_launch": [], "copy_floor": [], "parent": [], "tree": []}
        for label, fn in (("empty_launch", empty_launch), ("copy_floor", copy_floor),
                          ("parent", parent_design), ("tree", inflate_scan.inflate_scan_cuda),
                          ("tree", inflate_scan.inflate_scan_cuda), ("parent", parent_design),
                          ("copy_floor", copy_floor), ("empty_launch", empty_launch)):
            times[label].append(cs.device_ms(fn, args, kw, k=50))
        entry = {"name": "inflate_scan", "shape": shape, "k": kw["k"], "rsteps": kw["rsteps"],
                 "lanes": args[1].numel(), "bytes": nbytes, "longest_lane_reads": reads,
                 "chain_ms": chain["ops_ms"], "bound_ms": bound,
                 **{f"{k}_ms": v for k, v in times.items()},
                 **{f"{k}_share_of_bound": [bound / t for t in v] for k, v in times.items()},
                 **{f"{k}_cycles_per_read": [t * 1e6 * ghz / reads for t in times[k]]
                    for k in ("parent", "tree")}}
        cs.log("ab " + json.dumps(entry))
        res.append(entry)
    print(json.dumps({"sm_ghz": ghz, "smem_read": chase, "kernels": res}))


MODES = {"chains": chains_main, "parse_cover": parse_cover_main,
         "inflate_scan": inflate_scan_main}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison needs one GPU")
    if len(sys.argv) != 3 or sys.argv[1] not in MODES:
        raise SystemExit(f"usage: {sys.argv[0]} {{{','.join(MODES)}}} PARENT_DIR")
    MODES[sys.argv[1]](pathlib.Path(sys.argv[2]).resolve())


if __name__ == "__main__":
    main()
