#!/usr/bin/env python3
"""Redesigned kernels of this tree beside their earlier design, on one card.

    python3 ab_chains.py chains PARENT_DIR        # P1 and P2; PARENT_DIR: commit da778ed
    python3 ab_chains.py parse_cover PARENT_DIR   # B2; PARENT_DIR: commit f8599b4
    python3 ab_chains.py inflate_scan PARENT_DIR  # P3; PARENT_DIR: commit 21570d8
    python3 ab_chains.py inflate_spec PARENT_DIR  # P4; PARENT_DIR: commit bac9186

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
from compu_tpu_torch.kernels import (
    inflate_lut,
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


def edited_spec(edits, name: str):
    """P4 built from this tree's source with each (old, new) of ``edits``
    made, called as ``spec_scan_wave_cuda``; and its library."""
    src = (_build.CSRC / "inflate_spec.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"the edit does not fit the kernel: {old!r}")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{name}.cu"
    path.write_text(src)
    lib = _build.build([path], f"lib{name}")
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


MODES = {"chains": chains_main, "parse_cover": parse_cover_main,
         "inflate_scan": inflate_scan_main, "inflate_spec": inflate_spec_main}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison needs one GPU")
    if len(sys.argv) != 3 or sys.argv[1] not in MODES:
        raise SystemExit(f"usage: {sys.argv[0]} {{{','.join(MODES)}}} PARENT_DIR")
    MODES[sys.argv[1]](pathlib.Path(sys.argv[2]).resolve())


if __name__ == "__main__":
    main()
