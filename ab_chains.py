#!/usr/bin/env python3
"""Redesigned kernels of this tree beside their earlier design, on one card.

    python3 ab_chains.py chains PARENT_DIR        # P1 and P2; PARENT_DIR: commit da778ed
    python3 ab_chains.py parse_cover PARENT_DIR   # B2; PARENT_DIR: commit f8599b4
    python3 ab_chains.py inflate_scan PARENT_DIR  # P3; PARENT_DIR: commit 21570d8
    python3 ab_chains.py inflate_spec PARENT_DIR  # P4; PARENT_DIR: commit bac9186
    python3 ab_chains.py build_tables PARENT_DIR  # P5; PARENT_DIR: commit ecc7b5f
    python3 ab_chains.py inflate_resolve PARENT_DIR  # P7 and P6; PARENT_DIR: commit f23e061

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

``inflate_spec``: ``inflate_spec.cu`` of bac9186 is P4 before its
redesign, the block's 15-bit direct tables (2 x 128 KiB) read through the
read-only cache and all 192 record slots of every lane written. On
``chip_smoke.py``'s two gzip_foreign_decode waves (stdlib zlib's level-6
gzip stream of the 16 MB corpus, decoded once on the card with its waves
recorded: the first wave of the first dynamic block, and the last wave)
the earlier design is fed its 15-bit tables (``inflate_lut._lit_lut_block``
and ``_dist_lut_block`` at 15 bits, the tables its decode built) and this
tree's its compact tables; both are held to the plain version on the
defined records (the earlier design's records with outlen > 0, in slot
order, against the first ``nrec`` slots) and the lanes exactly, then
timed in turns, parent, this tree at 64, 128 and 256 lanes a CUDA block
(the kernel's 128, and copies of its source built with its
``kBlockLanes`` edited), the same back, parent, beside P4's bound
(``chip_smoke.spec_scan_work``), with the cycles a table read of the
longest lane; then each grid with every lane retired at its start
(``total_bits`` 0: the copies of the tables and the span, the lanes'
words and the launch); then a copy of this tree's kernel that reads the SM
clock (``CLOCK_EDITS``): per warp, its loop's cycles and iterations, and
the long-code walks. Each size's scan loop that reads shared memory goes
to ``ab_inflate_spec_sass.txt``.

``build_tables``: ``build_tables.cu`` of ecc7b5f is P5 before its
redesign: its wrapper seeds the histograms and takes the lit/len and
distance start lengths in torch (the plain version's ``seed_histograms``
and ``start_lengths`` here), and each fill step divides. On
``chip_smoke.py``'s three P5 shapes (gzip_lex's first 16-block group,
mesh_encode's 64-block batch, the synthetic sweep of 64 rows) both
designs are held to the plain version exactly, then timed in turns,
wrapper and launch alone of each, forward and back, beside P5's bound
(``chip_smoke.build_tables_work``: the slowest block's dependent tree
steps x one measured warp reduction), with the cycles a step at the SM
clock of a shared-memory chase. The SM clock's chases also give one warp
reduction (``redux``) and one step of a tree spread over four warps
(``compu_block_redux_chase`` in ``smoke_csrc/redux_chase.cu``: a warp
reduction, a word a warp through shared memory, one barrier), the floor
of the wider design that the kernel's header weighs. Both kernels' loops
that hold a shuffle (the fill steps) go to ``ab_build_tables_sass.txt``.

``inflate_resolve``: ``inflate_resolve.cu`` of f23e061 is P7 and P6
before their redesign: the indexed expansion zeroes the map, scatters
slot ids with atomics, takes chunk maxima and scans the map (three grid
barriers); the foreign one a warp 1,024 positions, one lane a position;
P6 passes over the whole map in every hop, with a copy pass before and an
output pass after. That commit's package is imported from PARENT_DIR under
another name (``parent_compu_tpu_torch``: the package's imports are
relative; it builds its own library in its own ``_build/``), and its
kernels run beside this tree's on ``chip_smoke.py``'s inputs:
gzip_decode's first batch (the gzip_lex stream of the 16 MB corpus,
encoded on the card, 16 blocks of 256 KiB: P3's records at (6, 26), the
blocks' lengths and the scan's flag) and gzip_foreign_decode's
stream-global token list (stdlib zlib's level-6 gzip stream of the
corpus). Both designs must equal the plain versions exactly (roots, bytes,
``ok``, rounds); then in turns, parent, this tree, this tree, parent, P7
and P6 alone with ``chip_smoke.device_ms`` beside their bounds
(``chip_smoke.expand_work``, ``resolve_work``) and both together on the
host clock around a synchronised call (median of 5). Phases: a copy of
each design's source with block 0's SM clock read at each cooperative
kernel's start and after each grid barrier (``stamped_library``), per
phase the median of 5 launches in microseconds. The doubling is replayed
hop by hop in PyTorch on the same roots (``doubling_trace``): the
unresolved count after each hop and the share of 512-position tiles that
still hold an unresolved position after each round. One grid barrier
alone is timed at several blocks an SM and threads a block
(``smoke_csrc/grid_sync.cu``). One call of each design runs under
torch.profiler (``chip_smoke.device_profile``).

The last line is one JSON object with the times.
"""

from __future__ import annotations

import collections
import ctypes
import importlib
import importlib.util
import json
import pathlib
import re
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from compu_tpu_torch import _build
from compu_tpu_torch.kernels import (
    build_tables as bt,
    inflate_lut,
    inflate_resolve,
    inflate_scan,
    inflate_spec,
    parse_cover,
    zstd_lit_decode,
    zstd_seq,
)

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


def dump_loops(label: str, lib_path, symbol: str, out, reads: str = "LDS",
               longest: int | None = None) -> None:
    """Every loop of ``symbol`` that holds an opcode starting with ``reads``
    (shared-memory reads by default), of at most ``longest`` instructions if
    given: its length, its instructions by pipe and its opcodes."""
    for body in cs.sass_loops(lib_path, symbol):
        ops = [op for _, op, _ in body]
        if not any(op.startswith(reads) for op in ops) or len(ops) > (longest or len(ops)):
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


def compact_records(rec: torch.Tensor) -> torch.Tensor:
    """(RF, L) records with their outlen > 0 slots moved, in slot order, to
    the front of each lane's column; 0 after them."""
    emits = (rec & 0x1FF) > 0
    pos = torch.cumsum(emits.to(torch.int64), 0) - 1
    out = torch.zeros_like(rec)
    lane = torch.arange(rec.shape[1], device=rec.device).expand_as(rec)
    out[pos[emits], lane[emits]] = rec[emits]
    return out


# A copy of P4 that also records, per lane, the SM clock from the end of
# its prologue to its loop's exit, its loop's iterations and its long-code
# walks, in record slots 191, 190 and 189 (above every lane's nrec in the
# waves it is run on).
CLOCK_EDITS = (
    ("  int step = 0, taken = 0;\n",
     "  int step = 0, taken = 0;\n  const long long c0 = clock64();\n  int iters = 0, walks = 0;\n"),
    ("    const uint32_t lo = __funnelshift_r(w0, w1, rel);\n",
     "    ++iters;\n    const uint32_t lo = __funnelshift_r(w0, w1, rel);\n"),
    ("      if ((a & 3) == 3) a = lit_long.walk(",
     "      ++walks;\n      if ((a & 3) == 3) a = lit_long.walk("),
    ("  bad = bad || over;  // record-slot overflow\n",
     "  bad = bad || over;  // record-slot overflow\n  rec[189 * kLanes + lane] = walks;\n"
     "  rec[190 * kLanes + lane] = iters;\n"
     "  rec[191 * kLanes + lane] = static_cast<int>(clock64() - c0);\n"),
)


# The kernel's lanes a CUDA block, edited in copies of its source to time
# the other sizes.
BLOCK_LANES_LINE = "constexpr int kBlockLanes = 128;"


def edited_library(source: str, edits, name: str) -> pathlib.Path:
    """This tree's ``csrc/<source>`` with each (old, new) of ``edits`` made,
    built as a library of its own; its path."""
    src = (_build.CSRC / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit does not fit {source}: {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    path.write_text(src)
    return _build.build([path], f"lib{name}")


def edited_spec(edits, name: str):
    """P4 built from this tree's source with each (old, new) of ``edits``
    made, called as ``spec_scan_wave_cuda``; and its library."""
    lib = edited_library("inflate_spec.cu", edits, name)
    fn = ctypes.CDLL(str(lib)).compu_inflate_spec
    fn.argtypes, fn.restype = list(_build._SIGNATURES["compu_inflate_spec"]), ctypes.c_int

    def call(comp, tables, wave_bit0, total_bits):
        lanes = torch.empty(5, inflate_spec.LANES, dtype=torch.int32, device=comp.device)
        rec = torch.empty(inflate_spec.RF, inflate_spec.LANES, dtype=torch.int32,
                          device=comp.device)
        if fn(comp.data_ptr(), comp.numel() // 4, tables.data_ptr(), wave_bit0, total_bits,
              lanes.data_ptr(), rec.data_ptr(), _build.stream_handle(comp)):
            raise RuntimeError(f"{name} failed to launch")
        return lanes, rec
    return call, lib


def warp_clock(lanes: torch.Tensor, rec: torch.Tensor) -> dict:
    """From a clocked scan: per warp of 32 lanes, its loop's cycles (its
    lanes leave the loop together) and iterations (its longest lane's);
    the slowest warp's, their ratio, the median warp's, and the walks."""
    if int(lanes[3].max()) >= 189:
        raise AssertionError("a lane's records reach the clock probe's slots")
    walks, iters, cycles = (rec[k].to(torch.int64).reshape(-1, 32) for k in (189, 190, 191))
    wcyc, wit = cycles.max(1).values, iters.max(1).values
    slow = int(torch.argmax(wcyc))
    return {"slowest_warp": slow, "slowest_warp_cycles": int(wcyc[slow]),
            "slowest_warp_iterations": int(wit[slow]),
            "slowest_warp_cycles_per_iteration": int(wcyc[slow]) / max(int(wit[slow]), 1),
            "slowest_warp_walks": int(walks[slow].sum()),
            "median_warp_cycles": float(wcyc.double().median()),
            "walks": int(walks.sum()), "lanes_with_a_walk": int((walks > 0).sum())}


def inflate_spec_main(parent: pathlib.Path) -> None:
    lib_parent = _build.build([parent / "compu_tpu_torch" / "csrc" / "inflate_spec.cu"],
                              "libcompu_parent_p4")
    scan = ctypes.CDLL(str(lib_parent)).compu_inflate_spec
    scan.argtypes, scan.restype = [_P, _LL, _P, _P, _LL, _LL, _P, _P, _P], ctypes.c_int

    def parent_design(comp, lit15, dist15, wave_bit0, total_bits):
        lanes = torch.empty(5, inflate_spec.LANES, dtype=torch.int32, device=comp.device)
        rec = torch.empty(inflate_spec.RF, inflate_spec.LANES, dtype=torch.int32,
                          device=comp.device)
        if scan(comp.data_ptr(), comp.numel() // 4, lit15.data_ptr(), dist15.data_ptr(),
                wave_bit0, total_bits, lanes.data_ptr(), rec.data_ptr(),
                _build.stream_handle(comp)):
            raise RuntimeError("the parent's inflate_spec failed to launch")
        return lanes, rec

    trees = {128: (inflate_spec.spec_scan_wave_cuda, _build.build())}
    for n in (64, 256):
        trees[n] = edited_spec(((BLOCK_LANES_LINE, f"constexpr int kBlockLanes = {n};"),),
                               f"compu_p4_lanes{n}")
    clocked, _ = edited_spec(CLOCK_EDITS, "compu_p4_clocked")
    with open(_build.BUILD_DIR / "ab_inflate_spec_sass.txt", "w") as fh:
        for n, (_, lib) in sorted(trees.items()):
            dump_loops(f"tree_{n}", lib, "inflate_spec_kernel", fh)
    chase = cs.smem_round_trip()
    ghz = chase["cycles"] / chase["ns"]
    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    stream = cs.gzip_stream(corpus)
    with cs.recorded_waves() as kept:
        res, out = cs.foreign_decode(stream, len(corpus))
    if out != corpus:
        raise AssertionError(f"the foreign decode of the corpus's gzip stream failed: {res}")
    res = []
    for shape in ("first", "last"):
        (comp, tables), kw = kept[shape]
        lit, dist = (torch.from_numpy(np.asarray(x)).cuda() for x in kept[f"{shape}_lens"])
        lit15 = inflate_lut._lit_lut_block(lit[None], 15)[0].contiguous()
        dist15 = inflate_lut._dist_lut_block(dist[None], 15)[0].contiguous()
        want = inflate_spec.spec_scan_wave_torch(comp, tables, **kw)
        got_p = parent_design(comp, lit15, dist15, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got_p[0], want[0])
                and torch.equal(compact_records(got_p[1]), want[1])):
            raise AssertionError(f"inflate_spec ({shape}): the parent's design differs from the "
                                 f"plain version")
        for n, (tree, _) in sorted(trees.items()):
            got, held = cs.spec_defined(tree(comp, tables, **kw), want)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, held)):
                raise AssertionError(f"inflate_spec ({shape}, {n} lanes a block): this tree's "
                                     f"design differs from the plain version")
        nbytes, reads, chain = cs.spec_scan_work((comp, tables), kw, want)
        bound = max(nbytes / cs.HBM_BYTES_PER_S * 1e3, chain["ops_ms"])
        times = collections.defaultdict(list)
        order = [("parent", parent_design, (comp, lit15, dist15))]
        order += [(f"tree_{n}", tree, (comp, tables)) for n, (tree, _) in sorted(trees.items())]
        for label, fn, args in order + order[::-1]:
            times[label].append(cs.device_ms(fn, args, kw, k=50))
        # The same grid with every lane retired at its start: the tables'
        # and span's copies, the lanes' words and the launch.
        for n, (tree, _) in sorted(trees.items()):
            times[f"tree_{n}_retired"].append(
                cs.device_ms(tree, (comp, tables), dict(kw, total_bits=0), k=50))
        clock = warp_clock(*clocked(comp, tables, **kw))
        entry = {"name": "inflate_spec", "shape": shape, **kw, "bytes": nbytes,
                 "record_bytes": chain["record_bytes"], "longest_lane_reads": reads,
                 "chain_ms": chain["ops_ms"], "bound_ms": bound,
                 **{f"{k}_ms": v for k, v in times.items()},
                 **{f"{k}_share_of_bound": [bound / t for t in v] for k, v in times.items()},
                 **{f"{k}_cycles_per_read": [t * 1e6 * ghz / reads for t in v]
                    for k, v in times.items() if not k.endswith("retired")},
                 "clock": clock}
        cs.log("ab " + json.dumps(entry))
        res.append(entry)
    print(json.dumps({"sm_ghz": ghz, "smem_read": chase, "kernels": res}))


# A copy of P5 that reads the SM clock at the end of each phase of a block
# and writes the readings, with the lit/len and code-length trees' loops,
# over the first P5_CLOCKS words of the block's hdr_vals row. P5_AFTER
# names each phase and the phase it follows (the tree warps, and then the
# code warps, run side by side from the same start). The reads clobber
# memory, so the compiler keeps them between the shared-memory accesses
# and barriers around them.
P5_AFTER = {"start": None, "lit_loaded": "start", "lit_start_lengths": "lit_loaded",
            "lit_tree": "lit_start_lengths", "dist_tree": "start", "trees_synced": "start",
            "costs_synced": "trees_synced", "cl_tree": "costs_synced", "cl_codes": "cl_tree",
            "choice": "cl_codes", "codes": "costs_synced", "codes_synced": "costs_synced",
            "end": "codes_synced"}
P5_STEPS = ("lit_lengthening_cycles", "lit_fill_cycles", "lit_lengthening_steps",
            "lit_fill_steps", "cl_tree_cycles", "cl_tree_steps")
P5_CLOCKS = len(P5_AFTER) + len(P5_STEPS)


def _clock(k: int, who: str = "lane == 0") -> str:
    return f"    if ({who}) s_clk[{k}] = clk();\n"


_AT = {name: k for k, name in enumerate(P5_AFTER)}
_STEP = {name: len(P5_AFTER) + k for k, name in enumerate(P5_STEPS)}
P5_CLOCK_EDITS = (
    ("namespace {\n\nconstexpr",
     "namespace {\n\n__shared__ long long s_clk[32];\n\n"
     "__device__ __forceinline__ long long clk() {\n  long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) :: \"memory\");\n"
     "  return t;\n}\n\nconstexpr"),
    ("  nused = static_cast<int>(team.sum(__reduce_add_sync(kFull, nused)));\n",
     "  nused = static_cast<int>(team.sum(__reduce_add_sync(kFull, nused)));\n"
     "  const long long cf0 = clk();\n  int nfix = 0, nfill = 0;\n"),
    ("  for (int it = 0; it < kFixIters && sum > budget; ++it) {",
     "  for (int it = 0; it < kFixIters && sum > budget; ++it, ++nfix) {"),
    ("  Pick mine = lane_pick<0, NPL>(key, u, budget - sum);\n",
     "  Pick mine = lane_pick<0, NPL>(key, u, budget - sum);\n  const long long cf1 = clk();\n"),
    ("  for (int it = 0; it < kFillIters && sum < budget; ++it) {",
     "  for (int it = 0; it < kFillIters && sum < budget; ++it, ++nfill) {"),
    ("  if (sum == budget) return;\n",
     f"  if (nsym == kLit && threadIdx.x == 0) {{\n"
     f"    s_clk[{_STEP['lit_lengthening_cycles']}] = cf1 - cf0;\n"
     f"    s_clk[{_STEP['lit_fill_cycles']}] = clk() - cf1;\n"
     f"    s_clk[{_STEP['lit_lengthening_steps']}] = nfix;\n"
     f"    s_clk[{_STEP['lit_fill_steps']}] = nfill;\n  }}\n"
     f"  if (nsym == kCl && lane == 0) {{\n    s_clk[{_STEP['cl_tree_cycles']}] = clk() - cf0;\n"
     f"    s_clk[{_STEP['cl_tree_steps']}] = nfix + nfill;\n  }}\n  if (sum == budget) return;\n"),
    ("  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     + _clock(_AT["start"], "tid == 0")),
    ("    start_lengths(team, freq, l, mid);\n    build_lengths(team, freq, l, kLit, kCap, k_tab, "
     "s_key);\n",
     _clock(_AT["lit_loaded"], "tid == 0") + "    start_lengths(team, freq, l, mid);\n"
     + _clock(_AT["lit_start_lengths"], "tid == 0") + "    build_lengths(team, freq, l, kLit, "
     "kCap, k_tab, s_key);\n" + _clock(_AT["lit_tree"], "tid == 0")),
    ("    build_lengths(team, freq, l, kDist, kCap, k_tab, s_key + kLit);\n",
     "    build_lengths(team, freq, l, kDist, kCap, k_tab, s_key + kLit);\n"
     + _clock(_AT["dist_tree"])),
    ("  __syncthreads();\n\n  // Each warp's share",
     "  __syncthreads();\n" + _clock(_AT["trees_synced"], "tid == 0") + "\n  // Each warp's share"),
    ("  __syncthreads();\n\n  if (warp == 0) {\n    // The code-length tree",
     "  __syncthreads();\n" + _clock(_AT["costs_synced"], "tid == 0")
     + "\n  if (warp == 0) {\n    // The code-length tree"),
    ("    build_lengths(team, freq, l, kCl, kClCap, k_tab, s_key);\n",
     "    build_lengths(team, freq, l, kCl, kClCap, k_tab, s_key);\n" + _clock(_AT["cl_tree"])),
    ("      s_cl_code[lane] = code;\n    }\n",
     "      s_cl_code[lane] = code;\n    }\n" + _clock(_AT["cl_codes"])),
    ("      header_total_out[b] = use_dyn ? 17 + kCl * 3 + hb : 3;\n    }\n",
     "      header_total_out[b] = use_dyn ? 17 + kCl * 3 + hb : 3;\n    }\n"
     + _clock(_AT["choice"])),
    ("      if (lane < kDist) s_code[kLit + lane] = code;\n    }\n",
     "      if (lane < kDist) s_code[kLit + lane] = code;\n    }\n"
     + _clock(_AT["codes"], "tid == 32")),
    ("  __syncthreads();\n\n  const bool use_dyn = s_use_dyn;\n",
     "  __syncthreads();\n" + _clock(_AT["codes_synced"], "tid == 0")
     + "\n  const bool use_dyn = s_use_dyn;\n"),
    ("    hdr_bits_out[static_cast<long long>(b) * kHdr + i] = bits;\n  }\n}\n",
     "    hdr_bits_out[static_cast<long long>(b) * kHdr + i] = bits;\n  }\n  __syncthreads();\n"
     + _clock(_AT["end"], "tid == 0") + "  __syncthreads();\n"
     f"  if (tid < {P5_CLOCKS}) hdr_vals_out[static_cast<long long>(b) * kHdr + tid] = "
     "s_clk[tid];\n}\n"),
)


def p5_outputs(B: int, dev) -> list:
    """P5's eight outputs for B blocks, in its C interface's order."""
    out = [torch.empty(B, n, dtype=torch.int64, device=dev)
           for n in (bt.NLIT, bt.NLIT, bt.NDIST, bt.NDIST, bt.NHDR, bt.NHDR)]
    return out + [torch.empty(B, dtype=torch.int64, device=dev),
                  torch.empty(B, dtype=torch.bool, device=dev)]


def p5_clock(args) -> dict:
    """The clocked copy of P5 (``P5_CLOCK_EDITS``) on ``args``: per phase,
    the median and the largest over the blocks of the cycles from the
    previous phase's end (the lit/len and distance trees and the code
    stage's warps run side by side, each from the same start), and the
    lit/len tree's loops' cycles and steps."""
    fn = ctypes.CDLL(str(edited_library("build_tables.cu", P5_CLOCK_EDITS,
                                        "compu_p5_clocked"))).compu_build_tables
    fn.argtypes, fn.restype = list(_build._SIGNATURES["compu_build_tables"]), ctypes.c_int
    dev = args[0].device
    out = p5_outputs(args[0].shape[0], dev)
    tabs = [bt.tables.on_device(n, dev) for n in ("start_thresholds", "cl_start_len", "flat_k")]
    for _ in range(2):  # a warm launch, then the one read
        if fn(*(t.data_ptr() for t in (*args, *tabs, *out)), args[0].shape[0],
              _build.stream_handle(args[0])):
            raise RuntimeError("the clocked P5 failed to launch")
    torch.cuda.synchronize()
    clk = out[4][:, :P5_CLOCKS].double()
    res = {}
    for name, prev in P5_AFTER.items():
        if prev is not None:
            d = clk[:, _AT[name]] - clk[:, _AT[prev]]
            res[name] = {"median": float(d.median()), "max": float(d.max())}
    whole = clk[:, _AT["end"]] - clk[:, _AT["start"]]
    res["whole"] = {"median": float(whole.median()), "max": float(whole.max())}
    for name, k in _STEP.items():
        res[name] = {"median": float(clk[:, k].median()), "max": float(clk[:, k].max())}
    return res


def p5_inputs(corpus: bytes) -> dict:
    """P5's inputs as ``chip_smoke.py`` holds it: the histograms of
    gzip_lex's first 16-block group (its matcher at the level-6 ladder),
    of mesh_encode's 64-block batch (``encode_blocks_dyn``'s defaults at
    depth 8) and the synthetic sweep, each (lit, dist, xl, xd, ns)."""
    blocks, lens = cs.split_blocks(corpus)
    out = {}
    for shape, cut, kw in (("gzip_lex", slice(0, 16), cs.LADDER),
                           ("mesh_encode", slice(None), {"depth": 8})):
        b = torch.from_numpy(blocks[cut]).cuda()
        ns = torch.from_numpy(lens[cut]).cuda().to(torch.int64)
        hists = cs._tok_hist_from_match(b, ns, *cs.match_and_parse_batch(b, ns, **kw))
        out[shape] = hists[1:] + (ns,)
    out["synthetic"] = cs.synthetic_tables_inputs(torch.device("cuda"))
    return out


def build_tables_main(parent: pathlib.Path) -> None:
    lib_parent = _build.build([parent / "compu_tpu_torch" / "csrc" / "build_tables.cu"],
                              "libcompu_parent_p5")
    launch = ctypes.CDLL(str(lib_parent)).compu_build_tables
    launch.argtypes, launch.restype = [_P] * 17 + [_LL, _P], ctypes.c_int
    dev = torch.device("cuda")
    tabs = [bt.tables.on_device(n, dev) for n in ("cl_start_len", "flat_k")]

    def parent_launch(lf, df, ll, dl, xl, xd, ns):
        """The earlier design's launch alone, on seeded histograms and start
        lengths."""
        B = lf.shape[0]
        out = p5_outputs(B, dev)
        if launch(*(t.data_ptr() for t in (lf, df, ll, dl, xl, xd, ns, *tabs, *out)), B,
                  _build.stream_handle(lf)):
            raise RuntimeError("the parent's build_tables failed to launch")
        return tuple(out)

    def parent_prepare(lf, df, xl, xd, ns):
        """The earlier design's wrapper: the plain version's seeding and
        start lengths, then its launch."""
        lf, df = bt.seed_histograms(lf, df)
        return (lf, df, bt.start_lengths(lf, bt.CAPBITS), bt.start_lengths(df, bt.CAPBITS),
                xl, xd, ns)

    def parent_wrapper(*args):
        return parent_launch(*parent_prepare(*args))

    def tree_wrapper(*args):
        return tuple(bt.build_tables_cuda(*args).values())

    def tree_launch(*args):
        return tuple(bt.launch_p5(*args).values())

    with open(_build.BUILD_DIR / "ab_build_tables_sass.txt", "w") as fh:
        for label, lib in (("parent", lib_parent), ("tree", _build.build())):
            # The kernel's backward branches also span whole phases: those
            # stretches are no step's loop.
            dump_loops(label, lib, "build_tables_kernel", fh, reads="SHFL.IDX", longest=1000)
    chase = cs.smem_round_trip()
    ghz = chase["cycles"] / chase["ns"]
    warp_step = cs.redux_round_trip()
    wide_step = cs._chase("compu_block_redux_chase", 1 << 18)
    cs.log("redux four-warp step " + json.dumps(wide_step))
    res = []
    for shape, args in p5_inputs(cs.build_corpus(cs.CORPUS_BYTES)).items():
        want = tuple(bt.build_tables_torch(*args).values())
        prepared = parent_prepare(*args)
        for label, fn, a in (("parent", parent_launch, prepared), ("tree", tree_wrapper, args),
                             ("tree launch", tree_launch, args)):
            got = fn(*a)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"build_tables ({shape}): the {label} design differs from "
                                     f"the plain version")
        nbytes, steps, chain = cs.build_tables_work(args, {}, want)
        times = collections.defaultdict(list)
        order = [("parent_wrapper", parent_wrapper, args),
                 ("parent_launch", parent_launch, prepared),
                 ("tree_wrapper", tree_wrapper, args), ("tree_launch", tree_launch, args)]
        for label, fn, a in order + order[::-1]:
            times[label].append(cs.device_ms(fn, a, {}, k=50))
        bound = max(nbytes / cs.HBM_BYTES_PER_S * 1e3, chain["ops_ms"])
        entry = {"name": "build_tables", "shape": shape, "blocks": int(args[0].shape[0]),
                 "clock_cycles": p5_clock(args),
                 "bytes": nbytes, "chain_steps": steps, "steps_max": chain["steps_max"],
                 "flat_tree_rows": chain["flat_tree_rows"], "bound_ms": bound,
                 **{f"{k}_ms": v for k, v in times.items()},
                 **{f"{k}_share_of_bound": [bound / t for t in v] for k, v in times.items()},
                 **{f"{k}_cycles_per_step": [t * 1e6 * ghz / steps for t in v]
                    for k, v in times.items()}}
        cs.log("ab " + json.dumps(entry))
        res.append(entry)
    print(json.dumps({"sm_ghz": ghz, "smem_read": chase, "warp_reduction": warp_step,
                      "four_warp_step": wide_step, "kernels": res}))


def parent_package(parent: pathlib.Path, name: str = "parent_compu_tpu_torch"):
    """The package of the checkout in ``parent``, imported as ``name``."""
    init = parent / "compu_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_ms(fn, args, reps: int = 5) -> float:
    """Median ms of ``reps`` calls of ``fn``, each synchronised, after a warm one."""
    fn(*args)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def resolution_inputs(corpus: bytes) -> dict:
    """gzip_decode's first batch and gzip_foreign_decode's token list, as
    ``chip_smoke.py`` records them: {path: {kernel: (args, kw)}}."""
    enc, _ = cs.make_encoder("gzip_lex")
    stream, index = enc.encode(corpus)
    with cs.recorded_resolution() as gz:
        if cs.BlockParallelDecoder(block_size=cs.BLOCK).decode(stream, index) != corpus:
            raise AssertionError("the decode of the gzip_lex stream differs from the corpus")
    with cs.recorded_resolution() as foreign:
        res, out = cs.foreign_decode(cs.gzip_stream(corpus), len(corpus))
        if out != corpus:
            raise AssertionError(f"the foreign decode differs from the corpus: {res}")
    return {"gzip_decode": gz, "gzip_foreign_decode": foreign}


# A copy of inflate_resolve.cu that reads the SM clock (clock64) in block 0's
# thread 0 at the start of each cooperative kernel and after each of its
# grid barriers, into a device array read back after the launch.
STAMP_DEF = """
__device__ long long g_stamps[256];
__device__ int g_nstamps;

__device__ __forceinline__ void stamp() {
  if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamps < 256) {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
    g_stamps[g_nstamps++] = t;
  }
}

extern "C" int compu_stamps_reset() {
  const int zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_nstamps, &zero, sizeof(int)));
}

extern "C" int compu_stamps_read(void* host, void* n) {
  cudaError_t err = cudaMemcpyFromSymbol(n, g_nstamps, sizeof(int));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  return static_cast<int>(err);
}
"""


def stamped_library(source: pathlib.Path, name: str, signatures: dict) -> ctypes.CDLL:
    """``source`` with a clock stamp at each cooperative kernel's start and
    after each of its grid barriers (``STAMP_DEF``), built as a library of
    its own and loaded with the resolution's C ``signatures`` (its tree's)."""
    src = source.read_text()
    anchor = "namespace cg = cooperative_groups;\n"
    if src.count(anchor) != 1:
        raise AssertionError(f"the stamps do not fit {source}")
    src = src.replace(anchor, anchor + STAMP_DEF)
    src, syncs = re.subn(r"^(\s*)grid\.sync\(\);", r"\g<0>\n\1stamp();", src, flags=re.M)
    src, starts = re.subn(r"^(\s*)cg::grid_group grid = cg::this_grid\(\);", r"\g<0>\n\1stamp();",
                          src, flags=re.M)
    if not syncs or starts != 2:
        raise AssertionError(f"the stamps do not fit {source}: {syncs} barriers, {starts} kernels")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    path.write_text(src)
    lib = ctypes.CDLL(str(_build.build([path], f"lib{name}")))
    for entry, argtypes in signatures.items():
        if entry.startswith(("compu_inflate_resolve", "compu_inflate_expand")) and \
                hasattr(lib, entry):
            getattr(lib, entry).argtypes = list(argtypes)
            getattr(lib, entry).restype = ctypes.c_int
    lib.compu_stamps_read.argtypes = [_P, _P]
    return lib


def stamped_call(build_mod, lib, fn, args, kw, ghz: float, reps: int = 5) -> list:
    """``fn`` (a wrapper that finds its library through ``build_mod.lib``)
    run on the stamped library ``lib``: per launch, block 0's stamps as
    microseconds from the first; ``reps`` launches after a warm one."""
    saved = build_mod.lib
    build_mod.lib = lambda: lib
    runs = []
    try:
        for k in range(reps + 1):
            if lib.compu_stamps_reset():
                raise RuntimeError("compu_stamps_reset failed")
            fn(*args, **kw)
            torch.cuda.synchronize()
            buf, n = (ctypes.c_longlong * 256)(), ctypes.c_int()
            if lib.compu_stamps_read(ctypes.addressof(buf), ctypes.addressof(n)):
                raise RuntimeError("compu_stamps_read failed")
            if k:
                runs.append([(buf[i] - buf[0]) / ghz / 1e3 for i in range(n.value)])
    finally:
        build_mod.lib = saved
    return runs


def phase_split(runs: list, labels: list) -> dict:
    """Median microseconds of each phase between consecutive stamps, by
    label; by number where the stamps do not match the labels."""
    n = min(len(r) for r in runs) - 1
    if any(len(r) != len(labels) + 1 for r in runs):
        labels = [f"phase{i}" for i in range(n)]
    return {lab: statistics.median(r[i + 1] - r[i] for r in runs) for i, lab in enumerate(labels)}


def parent_p6_labels(rounds, nsub: int) -> list:
    """PR 19's resolve_kernel between its stamps: the copy with the count,
    two hops a whole-map round, the compaction's count and its writes, a
    compacted round's read and its write-back, the output."""
    labels = ["copy_count"]
    for r in range(rounds[0]):
        labels += [f"round{r + 1}_hop1", f"round{r + 1}_hop2"]
    if nsub:
        labels += ["compaction_count", "compaction_write"]
        for k in range(rounds[1]):
            labels += [f"sub{k + 1}_read", f"sub{k + 1}_write"]
    return labels + ["output"]


def tree_p6_labels(rounds, nsub: int) -> list:
    """This tree's resolve_kernel between its stamps: round 1 from the
    input with the count before it (run whether or not the count lets it
    count), one pass each later whole-map round, the compaction, one
    barrier a compacted round; the tiles left and the flag after the last
    stamp (no barrier)."""
    labels = ["round1_count"] + [f"round{r + 1}" for r in range(1, rounds[0])]
    if nsub:
        labels.append("compaction")
        labels += [f"sub{k + 1}" for k in range(rounds[1])]
    return labels


def doubling_trace(root: torch.Tensor, valid: torch.Tensor, ksub: int, max_iters: int,
                   tile: int = 512) -> dict:
    """The reference's schedule replayed hop by hop on ``root``: the
    unresolved valid positions after each hop, and the share of
    ``tile``-position tiles that still hold an unresolved position (any,
    valid or not: a hop must visit them) after each whole-map round; then
    the compacted set's unresolved count after each of its rounds."""
    root = root.to(torch.int64)
    NT = root.shape[0]
    ntiles = -(-NT // tile)

    def tiles_left(r):
        m = torch.zeros(ntiles * tile, dtype=torch.bool, device=r.device)
        m[:NT] = r >= 0
        return int(m.reshape(ntiles, tile).any(1).sum()) / ntiles

    hop = lambda r: torch.where(r >= 0, r[torch.clamp(r, min=0)], r)  # noqa: E731
    left = int(((root >= 0) & valid).sum())
    trace = {"tiles": ntiles, "unresolved_before": left, "unresolved_after_hop": [],
             "tile_share_before": tiles_left(root), "tile_share_after_round": []}
    it = 0
    while left > ksub and it < max_iters:
        for _ in range(2):
            root = hop(root)
            trace["unresolved_after_hop"].append(int(((root >= 0) & valid).sum()))
        left = trace["unresolved_after_hop"][-1]
        trace["tile_share_after_round"].append(tiles_left(root))
        it += 1
    cand = torch.nonzero((root >= 0) & valid).reshape(-1)[:ksub]
    sub = root[cand]
    trace["compacted"] = int(cand.numel())
    trace["compacted_unresolved_after_round"] = []
    k = 0
    while k < max_iters and bool((sub >= 0).any()):
        sub = torch.where(sub >= 0, root[torch.clamp(sub, min=0)], sub)
        root[cand] = sub
        trace["compacted_unresolved_after_round"].append(int((sub >= 0).sum()))
        k += 1
    return trace


def grid_sync_costs() -> dict:
    """One grid barrier alone (``smoke_csrc/grid_sync.cu``): a launch of
    1,000 barriers less a launch of none, over 1,000, at each of
    (blocks an SM, threads a block), by CUDA events, median of 5."""
    fn = ctypes.CDLL(str(_build.build(cs.SMOKE_SOURCES, "libcompu_smoke"))).compu_grid_sync
    fn.argtypes, fn.restype = [_P, _I, _I, _I, _P], ctypes.c_int
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for per_sm, threads in ((1, 512), (2, 512), (4, 512), (1, 1024), (2, 1024)):
        def launch_ms(n):
            times = []
            for _ in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if fn(sink.data_ptr(), n, per_sm, threads, stream):
                    raise RuntimeError(f"compu_grid_sync failed at {per_sm} x {threads}")
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return statistics.median(times[1:])
        none, many = launch_ms(0), launch_ms(1000)
        res[f"{per_sm}x{threads}"] = {"launch_us": none * 1e3,
                                      "barrier_us": (many - none) / 1000 * 1e3}
    cs.log("grid_sync " + json.dumps(res))
    return res


def inflate_resolve_main(parent: pathlib.Path) -> None:
    pkg = parent_package(parent)
    p_res = importlib.import_module(f"{pkg.__name__}.kernels.inflate_resolve")
    p_build = importlib.import_module(f"{pkg.__name__}._build")
    if p_res.__file__ == inflate_resolve.__file__:
        raise AssertionError("the parent's package is this tree's")
    with open(_build.BUILD_DIR / "ab_inflate_resolve_sass.txt", "w") as fh:
        # The loops that load from global memory: the hops' tile loops (do
        # the map's stores hold back the next tile's loads?), the
        # expansions' lane and tile loops.
        for label, lib in (("parent", p_build.build()), ("tree", _build.build())):
            for symbol in ("resolve_kernel", "expand_indexed_kernel", "expand_foreign_kernel"):
                dump_loops(label, lib, symbol, fh, reads="LDG", longest=800)
    chase = cs.smem_round_trip()
    ghz = chase["cycles"] / chase["ns"]
    barriers = grid_sync_costs()
    stamped = {"parent": (p_build, p_res, stamped_library(
                   parent / "compu_tpu_torch" / "csrc" / "inflate_resolve.cu", "compu_p67_parent",
                   p_build._SIGNATURES)),
               "tree": (_build, inflate_resolve, stamped_library(
                   _build.CSRC / "inflate_resolve.cu", "compu_p67_tree", _build._SIGNATURES))}
    recorded = resolution_inputs(cs.build_corpus(cs.CORPUS_BYTES))
    res = []
    for path, kept in recorded.items():
        (ex_args, ex_kw), (rs_args, rs_kw) = kept["inflate_expand"], kept["inflate_resolve"]
        foreign = path == "gzip_foreign_decode"
        ex_name = "expand_foreign_cuda" if foreign else "expand_indexed_cuda"
        rs_name = "resolve_foreign_roots_cuda" if foreign else "resolve_indexed_cuda"
        designs = {label: (getattr(mod, ex_name), getattr(mod, rs_name))
                   for label, (_, mod, _) in stamped.items()}
        root = cs.expand_twin(*ex_args, **ex_kw)
        want = cs.resolve_twin(*rs_args, **rs_kw)
        for label, (ex, rs) in designs.items():
            got_root = ex(*ex_args, **ex_kw)
            got = rs(*rs_args, **rs_kw)
            torch.cuda.synchronize()
            if not (torch.equal(got_root, root) and all(torch.equal(g, w)
                                                        for g, w in zip(got, want))):
                raise AssertionError(f"{path}: the {label} design differs from the plain version")

        def both(label, args):
            ex, rs = designs[label]
            if foreign:
                return rs(ex(*args, **ex_kw))
            r = ex(args[0], **ex_kw)
            return rs(r, *args[1:], **rs_kw)

        both_args = ex_args if foreign else (ex_args[0], rs_args[1], rs_args[2])
        times = collections.defaultdict(list)
        for label in ("parent", "tree", "tree", "parent"):
            ex, rs = designs[label]
            times[f"{label}_p7_ms"].append(cs.device_ms(ex, ex_args, ex_kw, k=50))
            times[f"{label}_p6_ms"].append(cs.device_ms(rs, rs_args, rs_kw, k=20))
            times[f"{label}_host_ms"].append(host_ms(lambda *a, lb=label: both(lb, a), both_args))
        ex_bytes, _ = cs.expand_work(ex_args, ex_kw, root)
        rs_bytes, hops, chain = cs.resolve_work(rs_args, rs_kw, want)
        p7_bound = ex_bytes / cs.HBM_BYTES_PER_S * 1e3
        p6_bound = max(rs_bytes / cs.HBM_BYTES_PER_S * 1e3, chain["ops_ms"])
        NT = root.numel()
        if foreign:
            valid = torch.ones(NT, dtype=torch.bool, device=root.device)
            max_iters, ksub = inflate_resolve.foreign_max_iters(NT), 0
        else:
            N = rs_kw["N"]
            gp = torch.arange(NT, device=root.device)
            valid = (gp % N) < rs_args[1].to(torch.int64)[gp // N]
            max_iters, ksub = inflate_resolve.indexed_schedule(NT)
        trace = doubling_trace(root, valid, ksub, max_iters)
        rounds = want[2].tolist()
        nsub = trace["compacted"]
        phases = {}
        for label, (bmod, mod, lib) in stamped.items():
            ex, rs = getattr(mod, ex_name), getattr(mod, rs_name)
            p6_labels = (parent_p6_labels if label == "parent" else tree_p6_labels)(rounds, nsub)
            phases[label] = {"p6_us": phase_split(stamped_call(bmod, lib, rs, rs_args, rs_kw, ghz),
                                                  p6_labels)}
            if not foreign:
                p7_labels = (["zero", "scatter", "chunk_max"] if label == "parent"
                             else ["lane_summaries"])
                phases[label]["p7_us"] = phase_split(
                    stamped_call(bmod, lib, ex, ex_args, ex_kw, ghz), p7_labels)
        entry = {"path": path, "positions": NT, "ok": int(want[1][0]), "rounds": rounds,
                 **{k: v for k, v in times.items()},
                 "p7_bound_ms": p7_bound, "p6_bound_ms": p6_bound,
                 **{f"{k[:-3]}_share_of_bound": [(p6_bound if "p6" in k else p7_bound) / t
                                                 for t in v]
                    for k, v in times.items() if "_p" in k},
                 "longest_chain": chain["longest_chain"], "p6_chain_hops": hops,
                 "l2_load_ns": chain["ns_per_op"], "trace": trace, "phases_us": phases,
                 "parent_profiled": cs.device_profile(lambda: both("parent", both_args)),
                 "tree_profiled": cs.device_profile(lambda: both("tree", both_args))}
        cs.log("ab " + json.dumps(entry))
        res.append(entry)
    print(json.dumps({"sm_ghz": ghz, "grid_sync": barriers, "l2_load": cs.l2_round_trip(),
                      "kernels": res}))


MODES = {"chains": chains_main, "parse_cover": parse_cover_main,
         "inflate_scan": inflate_scan_main, "inflate_spec": inflate_spec_main,
         "build_tables": build_tables_main, "inflate_resolve": inflate_resolve_main}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison needs one GPU")
    if len(sys.argv) != 3 or sys.argv[1] not in MODES:
        raise SystemExit(f"usage: {sys.argv[0]} {{{','.join(MODES)}}} PARENT_DIR")
    MODES[sys.argv[1]](pathlib.Path(sys.argv[2]).resolve())


if __name__ == "__main__":
    main()
