#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``compu_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # stage times and device idle share

Drives four paths of the port over the 16 MB benchmark corpus
(``compu_tpu_torch.utils.corpus.build_corpus``; 64 blocks of 256 KiB, in
4 groups of 16):

* **gzip_lex**, the flagship deployment: level-6 gzip with the segment
  index, through ``make_block_encode_fn`` and ``BlockParallelEncoder``;
* **zlib_hash**: the hash matcher (wcap 32, the encode's default, depth 16)
  in zlib mode, through ``_encode_blocks_batched`` and
  ``BlockParallelEncoder(mode=Zlib)``;
* **zlib_hash_time_lex**: the same at ``scripts/time_lex.py``'s hash shape,
  wcap 16, depth 32;
* **adler_device**: ``adler32_device`` of each block.

Each path names the kernels it must launch; the launch counts are set to 0
just before a path runs and read just after. Phases, each raising on
failure:

1. report torch, CUDA and the card (name and power limit);
2. build the CUDA kernels from ``compu_tpu_torch/csrc``;
3. hold each kernel to its plain twin at each of its paths' shapes (the
   first 16 blocks; the adler tiles over the whole corpus in one launch),
   exactly, and time both with CUDA events: k back-to-back launches between
   one pair of events, divided by k, the median of 5 such runs (see
   ``device_ms``). Each kernel's bound is the larger of the bytes it must
   move over the card's memory rate and the integer operations it must do
   over the card's INT32 rate, both counted from this run's inputs (B1's
   cost per candidate read from the built kernel's SASS, ``cuobjdump``);
4. encode the corpus end to end on each encode path (one warm run, median
   of three each), check that zlib gives the corpus back, every block
   status is ok, and the path launched its kernels;
5. run adler_device and require each block's adler32 to equal
   ``zlib.adler32`` and the zlib_hash path's metas;
6. encode the first 4 blocks on the CPU (the twins) and on the card, on
   each encode path, and require equal bytes, metas and segment index;
7. encode ``tests/data/alice29.txt`` through ``Interface.zlib_device()``.

The last two lines printed are the kernel report and the result, each one
JSON object. Each kernel entry carries ``ms``, ``plain_ms``, ``bound_ms``
(with the ``bytes`` and ``ops`` it counts), ``bound_by``,
``share_of_bound`` (bound_ms / ms), ``launches`` (on its path's run) and
``launches_per_encode``, and ``library_ms`` null with the reason: no one
PyTorch call computes any of the five functions. Without a CUDA device it
fails and prints no result.

``--profile`` runs none of that. It encodes the corpus on each encode path
once with every stage synchronised before and after (ms per stage), and
once under ``torch.profiler``. From the profile it counts the CUDA kernels
and copies, takes the union of their intervals as the device's busy time,
and prints the idle share of the profiled wall time, one JSON line a path.
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from compu_tpu_torch import BlockParallelEncoder, ZlibMode, ZlibOptions, _build
from compu_tpu_torch import make_block_encode_fn
from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface
from compu_tpu_torch.kernels import deflate_v2, deflate_v3, u32
from compu_tpu_torch.kernels.adler_tiles import (
    adler32_device,
    adler32_partials_cuda,
    adler32_partials_torch,
)
from compu_tpu_torch.kernels.block_codec import (
    DEV_DEPTH,
    DEV_KEYS,
    DEV_STRIDE,
    DEV_WCAP,
    _encode_blocks_batched,
)
from compu_tpu_torch.kernels.deflate_v2 import _post_match, _sort_stage, match_and_parse_batch
from compu_tpu_torch.kernels.deflate_v3 import (
    _build_tables,
    _pack_inputs,
    _tok_hist_from_match,
    encode_blocks_dyn,
)
from compu_tpu_torch.kernels.emit_pack import emit_pack_cuda, emit_pack_torch
from compu_tpu_torch.kernels.lcp_match import (
    _adj_from_words,
    lcp_candidates_cuda,
    lcp_candidates_torch,
    sort_stage_lex,
)
from compu_tpu_torch.kernels.match_candidates import (
    match_candidates_cuda,
    match_candidates_torch,
)
from compu_tpu_torch.kernels.parse_cover import jump_targets, parse_cover_cuda, parse_cover_torch
from compu_tpu_torch.utils.corpus import TEXT_PATH, build_corpus

LEVEL = 6
BLOCK = 1 << 18
GROUPS = 4
CORPUS_BYTES = 16 << 20
LADDER = dict(depth=DEV_DEPTH[LEVEL], wcap=DEV_WCAP[LEVEL], lex_keys=DEV_KEYS[LEVEL],
              stride=DEV_STRIDE[LEVEL])
# The hash paths' matcher settings: the encode's default wcap, and the
# shape of the reference's only hash caller, scripts/time_lex.py:41.
HASH_PATHS = {
    "zlib_hash": dict(matcher="hash", wcap=32, depth=16),
    "zlib_hash_time_lex": dict(matcher="hash", wcap=16, depth=32),
}
MAX_DIST = 32768

# The kernels each path must launch.
PATHS = {
    "gzip_lex": ("lcp_candidates", "parse_cover", "emit_pack"),
    **{p: ("match_candidates", "parse_cover", "emit_pack") for p in HASH_PATHS},
    "adler_device": ("adler_tiles",),
}

# The card's rates the bounds are taken against: the H100 SXM's device
# memory rate (NVIDIA's data sheet), and its INT32 issue rate, 64 INT32
# lanes per SM x 132 SMs x the 1.98 GHz boost clock. All five kernels do
# integer work outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Launches timed back to back cycle through enough copies of the inputs
# that each launch reads at least this many bytes no launch since its
# last use has touched (twice the 50 MB L2), so every launch reads its
# inputs from device memory, as the bound assumes.
COLD_BYTES = 100 << 20
# The cost of one B1 candidate in the built kernel (lcp_candidate_cost),
# read from its SASS once the library is built.
LCP_COST: dict = {}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# SASS opcodes by the pipe that runs them on the H100. Per SM and clock:
# ALU and FMA (IMAD and IMUL run there) 64 lanes each, the XU (leading
# zeros, bit reverse, conversions) 16, and one warp instruction issued per
# clock in each of the 4 partitions, 128 lanes in all, memory ones included.
SASS_FMA = ("IMAD", "IMUL")
SASS_XU = ("FLO", "POPC", "BREV", "MUFU", "I2F", "F2I", "I2I", "F2F")
SASS_MEM = ("LD", "ST", "ATOM", "RED", "LDS", "STS", "LDG", "STG", "LDGSTS", "LDSM")
SASS_SKIP = ("BRA", "BSSY", "BSYNC", "EXIT", "NOP", "BAR", "WARPSYNC", "CALL", "RET",
             "YIELD", "DEPBAR", "S2R", "CS2R", "S2UR", "LDC", "BPT", "MEMBAR")


def sass_counts(lib_path, symbol: str) -> collections.Counter:
    """Instructions of one kernel of the built library by pipe, from
    ``cuobjdump -sass`` (the CUDA toolkit that built it): ``alu``, ``fma``,
    ``xu``, ``mem``; control, special-register and uniform-datapath
    instructions are left out. ``symbol`` is a part of the mangled name."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, inside, found = collections.Counter(), False, 0
    for line in text.splitlines():
        if "Function :" in line:
            inside = symbol in line
            found += inside
            continue
        m = inside and re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)",
                                 line)
        if not m:
            continue
        op = m.group(1).split(".")[0]
        if op in SASS_SKIP or op.startswith("U"):
            continue
        counts["fma" if op in SASS_FMA else "xu" if op in SASS_XU
               else "mem" if op in SASS_MEM else "alu"] += 1
    if not found or not counts:
        raise AssertionError(f"no kernel {symbol} in the SASS of {lib_path.name}")
    return collections.Counter({k: v / found for k, v in counts.items()})


def lcp_candidate_cost(lib_path) -> dict:
    """What one B1 candidate costs in the compiled kernel: the instructions
    that ``lcp_kernel<16>`` has more than ``lcp_kernel<8>``, both unrolled,
    over the 64 candidates a thread weighs more (4 lanes x 2 directions x
    8 depths), so that staging, ``adj`` and the epilogue cancel. ``cost``
    is the time of one candidate in INT32-lane issues (64 per SM and
    clock): the busiest of the ALU, the FMA pipe, the XU (at a quarter of
    the rate) and issue (at twice the rate)."""
    c16 = sass_counts(lib_path, "lcp_kernelILi16E")
    c8 = sass_counts(lib_path, "lcp_kernelILi8E")
    per = {k: (c16[k] - c8[k]) / 64 for k in ("alu", "fma", "xu", "mem")}
    per["cost"] = max(per["alu"], per["fma"], 4 * per["xu"], sum(per.values()) / 2)
    return per


# Work of each kernel on one call: (bytes, ops) from the inputs, keywords
# and outputs. Bytes count each input once and each output once; ops count
# the integer operations the function needs on these inputs, per unit:
def lcp_work(args, kw, outs):
    """Per lane and direction, the candidates until the running min of
    ``adj`` is 0 (a candidate past it has length 0 and cannot win; the one
    that finds the 0 counts), each at the compiled kernel's cost
    (``LCP_COST``, from its SASS), and 3 ops per window word for ``adj``
    (xor, leading zeros, accumulate)."""
    words, ps = args
    W, n = words.shape
    be = kw["block_elems"]
    lpos = torch.arange(n, device=ps.device) & (be - 1)
    w = u32.from_i32_bits(words)
    adj = torch.where(lpos == 0, 0, _adj_from_words(w, torch.roll(w, 1, dims=1)))
    mb, mf = adj, torch.where(lpos == be - 1, 0, torch.roll(adj, -1))
    needed = 2 * n
    for d in range(1, kw["depth"]):
        needed += int((mb > 0).sum()) + int((mf > 0).sum())
        mb = torch.minimum(mb, torch.roll(adj, d))
        mf = torch.minimum(mf, torch.where(lpos >= be - (d + 1), 0, torch.roll(adj, -(d + 1))))
    return _nbytes(words, ps, *outs), needed * LCP_COST["cost"] + 3 * W * n


def parse_work(args, kw, outs):
    """3 ops (load, compare, store) per position the walk visits."""
    (nl,) = args
    return _nbytes(nl, outs), 3 * int((outs != 0).sum())


def emit_work(args, kw, outs):
    """8 ops (extract, add) per field whose value is not 0: a zero field
    adds nothing."""
    bytep, shifted = args
    return _nbytes(bytep, shifted, outs), 8 * int((shifted != 0).sum())


def adler_work(args, kw, outs):
    """2 ops per byte: the sum and the weighted sum."""
    (flat,) = args
    return _nbytes(flat, outs), 2 * flat.numel()


def match_work(args, kw, outs):
    """Per lane and d = 1..depth with the candidate in the block (lpos >= d),
    1 op, the hash compare; per equal hash 2 more (distance, range test);
    per distance in range, 3 ops (xor, trailing zeros, add) for each window
    word up to and including the first that differs, and 1 to keep the
    longer."""
    hs, ps, words = args
    W, n = words.shape
    lpos = torch.arange(n, device=hs.device) & (kw["block_elems"] - 1)
    ops = 0
    for d in range(1, kw["depth"] + 1):
        inblock = lpos[d:] >= d
        same = inblock & (hs[d:] == hs[:-d])
        dist = ps[d:] - ps[:-d]
        inrange = same & (dist > 0) & (dist <= kw["max_dist"])
        equal_words = (words[:, d:] == words[:, :-d]).to(torch.int32).cumprod(0).sum(0)
        visited = torch.clamp(equal_words + 1, max=W)
        ops += (int(inblock.sum()) + 2 * int(same.sum())
                + int((3 * visited + 1)[inrange].sum()))
    return _nbytes(hs, ps, words, *outs), ops


NO_LIBRARY = "no one PyTorch call computes this function"

# name: (kernel, twin, source, TPU kernel it replaces, the paths at whose
# shapes it is held to its twin (the first gives its report entry), work)
KERNELS = {
    "lcp_candidates": (lcp_candidates_cuda, lcp_candidates_torch,
                       "compu_tpu_torch/csrc/lcp_candidates.cu",
                       "compu_tpu/kernels/lcp_match.py:169", ("gzip_lex",), lcp_work),
    "parse_cover": (parse_cover_cuda, parse_cover_torch,
                    "compu_tpu_torch/csrc/parse_cover.cu",
                    "compu_tpu/kernels/parse_pallas.py:39", ("gzip_lex",), parse_work),
    "emit_pack": (emit_pack_cuda, emit_pack_torch,
                  "compu_tpu_torch/csrc/emit_pack.cu",
                  "compu_tpu/kernels/emit_pallas.py:32", ("gzip_lex",), emit_work),
    "match_candidates": (match_candidates_cuda, match_candidates_torch,
                         "compu_tpu_torch/csrc/match_candidates.cu",
                         "compu_tpu/kernels/match_pallas.py:50", tuple(HASH_PATHS),
                         match_work),
    "adler_tiles": (adler32_partials_cuda, adler32_partials_torch,
                    "compu_tpu_torch/csrc/adler_tiles.cu",
                    "compu_tpu/kernels/pallas_kernels.py:31", ("adler_device",),
                    adler_work),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def split_blocks(data: bytes, bs: int = BLOCK):
    nblocks = -(-len(data) // bs)
    blocks = np.zeros((nblocks, bs), np.uint8)
    lens = np.zeros(nblocks, np.int32)
    for i in range(nblocks):
        chunk = data[i * bs:(i + 1) * bs]
        blocks[i, :len(chunk)] = np.frombuffer(chunk, np.uint8)
        lens[i] = len(chunk)
    return blocks, lens


def kernel_inputs(blocks: torch.Tensor, lens: torch.Tensor, flat: torch.Tensor):
    """The inputs each kernel receives on its path: B1-B3 and B5 for the
    (B, N) blocks as the port's stages compute them, B4 the flat bytes.
    Returns {(kernel, path): (args, kw)}."""
    B, N = blocks.shape
    ns = lens.to(torch.int64)
    *wbe, ps = sort_stage_lex(blocks, wcap=LADDER["wcap"], keys=LADDER["lex_keys"],
                              stride=LADDER["stride"])
    words = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in wbe]))
    ps32 = ps.reshape(-1).to(torch.int32)
    lcp_kw = dict(depth=LADDER["depth"], max_dist=MAX_DIST, block_elems=N // LADDER["stride"])
    bl, bd = lcp_candidates_torch(words, ps32, **lcp_kw)
    step, *_ = _post_match(blocks, ns, ps, bl.reshape(B, -1).to(torch.int64),
                           bd.reshape(B, -1).to(torch.int64), wcap=LADDER["wcap"],
                           stride=LADDER["stride"])
    nl = jump_targets(step.reshape(-1))
    is_tok, best_len, best_dist = match_and_parse_batch(blocks, ns, **LADDER)
    tok, lf, df, xl, xd = _tok_hist_from_match(blocks, ns, is_tok, best_len, best_dist)
    bytep, shifted, _, _ = _pack_inputs(tok, _build_tables(lf, df, xl, xd, ns), N)
    inputs = {
        ("lcp_candidates", "gzip_lex"): ((words, ps32), lcp_kw),
        ("parse_cover", "gzip_lex"): ((nl,), {}),
        ("emit_pack", "gzip_lex"): ((bytep, shifted), {}),
        ("adler_tiles", "adler_device"): ((flat,), {}),
    }
    for path, cfg in HASH_PATHS.items():
        hs, hps, *sw = _sort_stage(blocks, ns, wcap=cfg["wcap"])
        hwords = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in sw]))
        inputs["match_candidates", path] = (
            (hs.reshape(-1).to(torch.int32), hps.reshape(-1).to(torch.int32), hwords),
            dict(depth=cfg["depth"], max_dist=MAX_DIST, block_elems=N))
    return inputs


def device_ms(fn, args, kw, k: int, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in milliseconds: after a warm call,
    k back-to-back calls between one pair of CUDA events, divided by k; the
    median of ``reps`` such runs. A sleep kernel ahead of the start event
    keeps the device busy while the host enqueues the k calls, so the
    events see the device's work and not the host's. The calls cycle
    through copies of the inputs (``COLD_BYTES``)."""
    copies = [args] + [tuple(a.clone() for a in args)
                       for _ in range(math.ceil(COLD_BYTES / _nbytes(*args)) - 1)]
    fn(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args, **kw)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # About 2e9 cycles a second; a slower clock only sleeps longer.
    sleep_cycles = int(min(2 * k * host_s + 1e-3, 0.5) * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for i in range(k):
            fn(*copies[i % len(copies)], **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / k)
    return statistics.median(times)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def hold_to_twin(name: str, path: str, kernel, twin, work, args, kw) -> dict:
    """One kernel against its plain twin on one path's inputs, exactly
    (tolerance 0: all five are integer functions), both timed, and the
    kernel's bound from the same inputs."""
    got = as_tuple(kernel(*args, **kw))
    want = as_tuple(twin(*args, **kw))
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    shapes = [tuple(a.shape) for a in args]
    if not same:
        raise AssertionError(f"{name} ({path}): kernel and plain twin disagree "
                             f"(max abs err {err}) on inputs {shapes} {kw}")
    nbytes, ops = work(args, kw, want[0] if len(want) == 1 else want)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    ms = device_ms(kernel, args, kw, k=50)
    plain_ms = device_ms(twin, args, kw, k=20)
    res = {"path": path, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "ops": ops, "library_ms": None, "library_note": NO_LIBRARY}
    res["share_of_bound"] = res["bound_ms"] / ms
    log(f"kernel {name} ({path}): inputs {shapes} {kw} equal={same} max_abs_err={err} "
        f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"by {res['bound_by']} ({nbytes} B, {ops} ops), share {res['share_of_bound']:.3f}")
    return res


def check_kernels(blocks: torch.Tensor, lens: torch.Tensor, flat: torch.Tensor) -> list[dict]:
    """Each kernel against its plain twin on the card, at each of its paths'
    shapes. A kernel held at more than one path's shapes reports the others
    under ``other_paths``."""
    report = []
    inputs = kernel_inputs(blocks, lens, flat)
    for name, (kernel, twin, source, replaces, paths, work) in KERNELS.items():
        first, *others = [hold_to_twin(name, p, kernel, twin, work, *inputs[name, p])
                          for p in paths]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces, **first}
        if name == "lcp_candidates":
            entry["sass_per_candidate"] = dict(LCP_COST)
        if others:
            entry["other_paths"] = others
        report.append(entry)
    return report


def run_path(path: str, fn):
    """Run ``fn`` with the launch counts set to 0 just before and read just
    after; fail unless it launched every kernel of ``path``. Returns
    (fn's result, the counts)."""
    _build.reset_launch_counts()
    result = fn()
    launches = dict(_build.LAUNCHES)
    missing = [k for k in PATHS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"path {path} launched no {missing}: {launches}")
    return result, launches


def timed_encodes(enc, corpus: bytes):
    """One warm encode, then three timed; returns (last stream, index, times)."""
    enc.encode(corpus)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stream, index = enc.encode(corpus)
        times.append(time.perf_counter() - t0)
    states = [s.state for s in enc.block_statuses]
    if any(s != "ok" for s in states):
        raise AssertionError(f"block statuses not all ok: {sorted(set(states))}")
    return stream, index, times


def summary(path: str, corpus: bytes, stream: bytes, times: list, launches: dict, **extra):
    sec = statistics.median(times)
    res = {"path": path, "blocks": len(corpus) // BLOCK, "bytes": len(corpus),
           "compressed": len(stream), "ratio": len(corpus) / len(stream), "median_s": sec,
           "runs_s": times, "MBps": len(corpus) / sec / 1e6, "launches": launches,
           "runs_counted": 4, **extra}
    log("e2e " + json.dumps(res))
    return res


def gzip_lex_path(corpus: bytes) -> dict:
    """The flagship path over the whole corpus."""
    enc, fn = make_encoder("gzip_lex")
    (stream, index, times), launches = run_path("gzip_lex", lambda: timed_encodes(enc, corpus))
    if zlib.decompress(stream, wbits=31) != corpus:
        raise AssertionError("gzip stream does not decode to the corpus")
    if len(index.segment_bits) != len(corpus) // BLOCK:
        raise AssertionError("segment index missing")
    return summary("gzip_lex", corpus, stream, times, launches, last_timings=fn.last_timings)


def make_encoder(path: str):
    """The ``BlockParallelEncoder`` of an encode path, and its step."""
    if path == "gzip_lex":
        fn = make_block_encode_fn(ZlibMode.Gzip, level=LEVEL, segment_index=True,
                                  pipeline_groups=GROUPS)
        return BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip), fn
    step = _hash_zlib_step(torch.device("cuda"), HASH_PATHS[path])
    return BlockParallelEncoder(step, block_size=BLOCK, mode=ZlibMode.Zlib), step


def _hash_zlib_step(device, cfg: dict):
    """Smoke-run harness, not a package entry point: the step
    ``BlockParallelEncoder`` takes for a hash path. Each group of blocks is
    encoded on ``device`` by ``_encode_blocks_batched`` with the matcher
    settings ``cfg``, the metas fetched, then each group's compacted bytes.
    ``step.last_metas`` keeps the last call's (B, 2) int32 metas."""

    def step(blocks: np.ndarray, lens: np.ndarray):
        B = blocks.shape[0]
        gb = -(-B // GROUPS)
        lens_dev = torch.from_numpy(np.asarray(lens, np.int64)).to(device)
        parts = []
        for g in range(0, B, gb):
            dev_blocks = torch.from_numpy(np.ascontiguousarray(blocks[g:g + gb])).to(device)
            parts.append(_encode_blocks_batched(dev_blocks, lens_dev[g:g + gb],
                                                with_index=False, check="adler", **cfg))
        metas = torch.cat([p[1] for p in parts]).cpu().numpy()
        out_lens = metas[:, 0].astype(np.int64)
        flat = np.concatenate([p[0][:int(out_lens[g:g + gb].sum())].cpu().numpy()
                               for p, g in zip(parts, range(0, B, gb))])
        offsets = np.concatenate([[0], np.cumsum(out_lens)])
        step.last_metas = metas
        return ([flat[offsets[i]:offsets[i + 1]] for i in range(B)], out_lens,
                metas[:, 1].view(np.uint32))

    return step


def zlib_hash_path(path: str, corpus: bytes) -> tuple[dict, np.ndarray]:
    """A hash path's zlib stream over the whole corpus; returns the
    measurements and the last run's metas."""
    enc, step = make_encoder(path)
    (stream, _, times), launches = run_path(path, lambda: timed_encodes(enc, corpus))
    if zlib.decompress(stream) != corpus:
        raise AssertionError(f"zlib stream of {path} does not decode to the corpus")
    return summary(path, corpus, stream, times, launches, **HASH_PATHS[path]), step.last_metas


def adler_device_path(blocks: np.ndarray, lens: np.ndarray, metas: np.ndarray) -> dict:
    """adler32_device of every block: equal to zlib.adler32 and to the
    zlib_hash path's metas[:, 1] (the plain ``_block_checksum``)."""
    dev = torch.from_numpy(blocks).cuda()
    t0 = time.perf_counter()
    got, launches = run_path("adler_device", lambda: [
        adler32_device(dev[i], int(lens[i])) for i in range(len(lens))])
    sec = time.perf_counter() - t0
    want = [zlib.adler32(blocks[i, :lens[i]].tobytes()) for i in range(len(lens))]
    if got != want:
        raise AssertionError("adler32_device differs from zlib.adler32")
    if got != metas[:, 1].view(np.uint32).tolist():
        raise AssertionError("adler32_device differs from the zlib_hash path's metas")
    log(f"adler_device: {len(got)} blocks equal zlib.adler32 and the hash path's metas "
        f"({sec * 1e3:.1f} ms for all, host combine included)")
    return {"path": "adler_device", "blocks": len(got), "seconds": sec, "launches": launches,
            "runs_counted": 1}


def cpu_equals_device(blocks: np.ndarray, lens: np.ndarray, label: str, **kw) -> None:
    """The port on CPU tensors (the twins) and on the card give equal bytes."""
    t0 = time.perf_counter()
    cpu = [x.numpy() for x in encode_blocks_dyn(torch.from_numpy(blocks),
                                                torch.from_numpy(lens), **kw)]
    t_cpu = time.perf_counter() - t0
    dev = [x.cpu().numpy() for x in encode_blocks_dyn(
        torch.from_numpy(blocks).cuda(), torch.from_numpy(lens).cuda(), **kw)]
    if not np.array_equal(cpu[1], dev[1]):
        raise AssertionError(f"{label}: metas differ: cpu {cpu[1].tolist()} gpu {dev[1].tolist()}")
    for i in range(len(lens)):
        n = int(cpu[1][i, 0])
        if not np.array_equal(cpu[0][i, :n], dev[0][i, :n]):
            raise AssertionError(f"{label}: block {i}: cpu and gpu bytes differ")
    if not np.array_equal(cpu[2], dev[2]):
        raise AssertionError(f"{label}: seg_bits differ")
    log(f"{label}: cpu == gpu on {len(lens)} blocks: bytes, metas and seg_bits equal "
        f"(cpu run {t_cpu:.1f} s)")


def stream_encoder() -> None:
    """The port's Encoder state machine over its device backend."""
    data = TEXT_PATH.read_bytes()
    enc = Interface.zlib_device(ZlibOptions(mode=ZlibMode.Gzip, level=LEVEL))
    vec = ByteVec()
    enc.encode_vec_full(data, vec, EncodeOp.Finish)
    if zlib.decompress(vec.data(), wbits=31) != data:
        raise AssertionError("zlib_device stream does not decode")
    log(f"zlib_device: alice29.txt {len(data)} -> {len(vec.data())} bytes, decodes")


# The encode's stages, by the module whose globals the encode looks them up in.
STAGES = (
    (deflate_v2, "sort_stage_lex"), (deflate_v2, "_sort_stage"),
    (deflate_v2, "lcp_candidates"), (deflate_v2, "match_candidates"),
    (deflate_v2, "_post_match"), (deflate_v2, "parse_cover"),
    (deflate_v2, "_merge_seg_boundaries"), (deflate_v3, "_tok_hist_from_match"),
    (deflate_v3, "_block_checksum"), (deflate_v3, "_build_tables"), (deflate_v3, "_emit"),
)


def stage_ms(enc, corpus: bytes) -> dict:
    """One encode with each stage synchronised before and after: ms per
    stage, summed over the groups, and the whole encode's."""
    times = dict.fromkeys((name for _, name in STAGES), 0.0)

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = [(mod, name, getattr(mod, name)) for mod, name in STAGES]
    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(corpus)
        torch.cuda.synchronize()
        times["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return times


def device_profile(enc, corpus: bytes) -> dict:
    """One encode under torch.profiler. Only the CUDA device's own work is
    counted: kernels, and the copies and sets named Memcpy/Memset. The
    device-side copies of ``record_function`` spans (user annotations) are
    left out, since one spans the whole encode. The union of the work's
    intervals is the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        enc.encode(corpus)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    is_span = [getattr(e, "is_user_annotation", False)
               or getattr(e, "activity_type", None) == "gpu_user_annotation"
               for e in on_dev]
    spans = [e for e, span in zip(on_dev, is_span) if span]
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e, span in zip(on_dev, is_span) if not span)
    kernels = [(s, e) for s, e, n in dev if not n.startswith(("Memcpy", "Memset"))]
    kernel_ms = sum(e - s for s, e in kernels) / 1e3
    if not kernels or kernel_ms > wall_ms:
        raise AssertionError(f"implausible profile: {len(kernels)} kernels, {kernel_ms:.1f} ms "
                             f"of kernels in {wall_ms:.1f} ms")
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in dev:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return {"profiled_wall_ms": wall_ms, "kernels": len(kernels),
            "copies": len(dev) - len(kernels), "spans_left_out": sorted({e.name for e in spans}),
            "kernel_ms": kernel_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms}


def profile_main(corpus: bytes) -> None:
    """``--profile``: per encode path, one warm encode, one unprofiled, one
    with the stages synchronised and one under the profiler."""
    for path in ("gzip_lex", *HASH_PATHS):
        enc, _ = make_encoder(path)
        enc.encode(corpus)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(corpus)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = {"path": path, "wall_ms": wall_ms, "stages_ms": stage_ms(enc, corpus),
               **device_profile(enc, corpus)}
        log("profile " + json.dumps(res))


def main() -> None:
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs one GPU")
    if sys.argv[1:] not in ([], ["--profile"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_report().splitlines():
        if line.startswith("==") or any(w in line for w in ("Compiling entry", "Used", "spill")):
            log("ptxas " + line.strip())
    LCP_COST.update(lcp_candidate_cost(path))
    log("sass lcp_candidates per candidate " + json.dumps(LCP_COST))

    corpus = build_corpus(CORPUS_BYTES)
    if sys.argv[1:] == ["--profile"]:
        profile_main(corpus)
        return
    blocks, lens = split_blocks(corpus)
    kernels = check_kernels(torch.from_numpy(blocks[:16]).cuda(),
                            torch.from_numpy(lens[:16]).cuda(),
                            torch.from_numpy(blocks.reshape(-1)).cuda())
    runs = {"gzip_lex": gzip_lex_path(corpus)}
    metas = {}
    for p in HASH_PATHS:
        runs[p], metas[p] = zlib_hash_path(p, corpus)
    runs["adler_device"] = adler_device_path(blocks, lens, metas["zlib_hash"])
    log("e2e side by side: " + ", ".join(
        f"{p} {runs[p]['MBps']:.2f} MB/s ratio {runs[p]['ratio']:.4f}"
        for p in ("gzip_lex", *HASH_PATHS)))
    for k in kernels:
        for entry in (k, *k.get("other_paths", ())):
            run = runs[entry["path"]]
            entry["launches"] = run["launches"][k["name"]]
            entry["launches_per_encode"] = entry["launches"] / run["runs_counted"]
    cpu_equals_device(blocks[:4], lens[:4], "gzip_lex", with_index=True, check="crc", **LADDER)
    for p, cfg in HASH_PATHS.items():
        cpu_equals_device(blocks[:4], lens[:4], p, with_index=True, check="adler", **cfg)
    stream_encoder()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "compu_tpu", "bench"))
    if leaked:
        raise AssertionError(f"the JAX package or JAX was imported: {leaked[:5]}")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
