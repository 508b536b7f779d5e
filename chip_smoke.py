#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``compu_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # stage times and device idle share

Drives twelve device paths and ten host paths of the port over the 16 MB
benchmark corpus (``compu_tpu_torch.utils.corpus.build_corpus``; 64
blocks of 256 KiB, in 4 groups of 16, for the DEFLATE paths):

* **gzip_lex**, the flagship deployment: level-6 gzip with the segment
  index, through ``make_block_encode_fn`` and ``BlockParallelEncoder``;
* **gzip_decode**: that stream read back with its index through
  ``BlockParallelDecoder()``: 4 batches of 16 blocks, each one launch of
  the segment token scan (P3, ``csrc/inflate_scan.cu``), the expansion
  and the pointer doubling in PyTorch, stored blocks copied on the host;
* **gzip_foreign_decode**: the corpus compressed by stdlib ``zlib`` (level
  6, gzip framing: no index) and decoded through
  ``decoder.Interface.zlib_device(ZlibMode.Auto)``: each deflate block's
  header parsed on the host, its code tables (12-bit primaries and the
  canonical walk of longer codes) built in numpy and uploaded once, then
  one launch of the speculative 48-phase chunk scan (P4,
  ``csrc/inflate_spec.cu``) a wave of 256 chunks of 512 bits, the true
  path walked on the host, and the stream-global expansion and pointer
  doubling in PyTorch;
* **zlib_hash**: the hash matcher (wcap 32, the encode's default, depth 16)
  in zlib mode, through ``_encode_blocks_batched`` and
  ``BlockParallelEncoder(mode=Zlib)``;
* **zlib_hash_time_lex**: the same at ``scripts/time_lex.py``'s hash shape,
  wcap 16, depth 32;
* **adler_device**: ``adler32_device`` of the 64 blocks, one launch;
* **zstd_device**: the device zstd encode, ``Interface.zstd(ZstdOptions(
  device_lz=True, device_literals=True, device_sequences=True))``:
  16 tokenizer calls of 1 MiB (B1 and B2 at 2^20 lanes, depth 8, max_dist
  131,071), 128 frame blocks of 128 KiB, each with one FSE sequence scan
  (P1, ``csrc/fse_seq_scan.cu``), and the xxh64 checksum;
* **zstd_decode**: the decode of that frame back to the corpus through
  ``decoder.Interface.zstd()`` (its default ``device_literals``), the
  frame blocks' 4-stream literal sections each one launch of P2
  (``csrc/huf_lit_decode.cu``), the sequences and xxh64 on the host;
* **brotli_device**: the brotli encode, ``Interface.brotli(BrotliOptions(
  device_lz=True))`` (quality 9, window 22, Generic): 16 meta-blocks of 1 MiB, each one tokenizer
  call (B1 and B2 at 2^20 lanes, depth 8, max_dist 2^20), its commands,
  distance plan, context model, prefix codes and bits written by the
  host's Python; the stream decoded back by ``decoder.Interface.brotli()``
  (host code);
* **gzip_fixed_v2**: the fixed-Huffman v2 route, ``make_block_encode_fn(
  kernel="v2", segment_index=True)`` at level 6 through
  ``BlockParallelEncoder`` (B1 and B2 at ``match_and_parse_batch``'s
  defaults, depth 8; B3 packs the fixed-code fields), and its stream read
  back with its index through ``BlockParallelDecoder()`` (P3 on the fixed
  code's tables; the read-back is counted as ``gzip_fixed_v2_decode``);
* **mesh_encode**: ``parallel/mesh.py`` on an NCCL process group of one
  rank on the card: the sharded encode step over the 64 blocks in one
  batch (B1, B2, B3), the stream-sharded zstd literal step over the
  corpus's 128 blocks of 128 KiB x 4 streams, the lane-sharded crc32 on a
  (1, 1) ("dp", "lane") mesh, then ``entry.dryrun_multichip(1)``. One card
  runs a world of one: NCCL refuses two ranks on one card, so the
  cross-card leg is not run here;
* the host backends, which launch no kernel (checked): **zlib_host**,
  ``encoder.Interface.zlib()`` at level 6 in gzip mode, its stream decoded
  by ``decoder.Interface.zlib()``, ``zlib_native()`` and stdlib zlib;
  **zlib_native**, **zstd_native** and **brotli_native**, each encoder of
  the host runtime (``compu_tpu_torch/runtime/csrc``, built by g++) decoded
  by its own native decoder and by the port's Python decoder of the format
  (the whole stream for zlib, with stdlib zlib too, and brotli; the first
  1 MiB's frame for zstd); **gzip_decode_host**, gzip_lex's stream read
  back by ``BlockParallelDecoder(host=True)``, one call into the runtime's
  whole-block inflate a block. The zstd_device and brotli_device encodes
  run their host stages in the same runtime (``native_enc.py`` of each);
* the host routes and engines, which launch no kernel either (checked),
  each stream the JAX reference's (``HOST_ROUTE_STREAMS``: its length and
  sha256): **zstd_host**, ``Interface.zstd(ZstdOptions(level=3,
  window_log=17, device_lz=False))``, and **zstd_host_l19**, level 19 over
  the first 4 MiB (a cut, printed as such), each frame decoded by the
  native zstd decoder (the card machine has no ``zstandard``);
  **brotli_host**, ``Interface.brotli(BrotliOptions(quality=9,
  window_bits=22, device_lz=False))``, decoded by the port's decoder and
  by libbrotlidec where it loads; **zlib_host_parallel**,
  ``BlockParallelEncoder(make_host_block_encode_fn(Gzip, 6))`` over the 64
  blocks, decoded by stdlib zlib; **zstd_parallel**,
  ``parallel_zstd_compress(corpus, level=3)``, every frame decoded by the
  native decoder;
* **gzip_v1**: the v1 block step, ``make_block_encode_fn(kernel="v1")``
  (plain PyTorch on the card: the chain walk, fixed-Huffman blocks, the
  lane crc; none of the nine kernels, checked) over the 64 blocks through
  ``BlockParallelEncoder``: stdlib zlib decodes it, it is the CPU's
  stream (``V1_STREAM``: its length and sha256), one step over the
  first 16 blocks launches CUDA kernels under torch.profiler (counted),
  and the CPU's step over them gives the card's bytes; then
  ``byte_histogram`` of the corpus on the card equals ``np.bincount``.

Each path names the kernels it must launch; the launch counts are set to 0
just before a path runs and read just after. Phases, each raising on
failure:

1. report torch, CUDA and the card (name and power limit);
2. build the CUDA kernels from ``compu_tpu_torch/csrc`` and, beside them,
   the host runtime from ``compu_tpu_torch/runtime/csrc`` (the ``native``
   line: its path under ``_build/``, its build seconds, g++'s version);
3. hold each kernel to its plain twin at each of its paths' shapes (the
   first 16 blocks, for B1-B3 also as the v2 route computes them and for
   B1 also with the far tie, ``prefer_far``, under ``other_shapes``, its
   time beside the nearer rule's; for B1 and B2 also the zstd and brotli
   paths' first 1 MiB call;
   the adler tiles over the whole corpus in one launch, as adler_device
   makes it; P1 on the largest sequences section of the first MiB's zstd
   encode; P2, after phase 6, on the largest literal section of the
   zstd_device frame; B2 as the whole function, from the path's int64
   step array to the bool cover, against the jump targets, the plain cover
   and ``> 0``), exactly, and time both with CUDA events: k back-to-back
   launches between one pair of events, divided by k, the median of 5 such
   runs (see ``device_ms``; a plain twin whose check call takes 0.1 s or
   more, P1's and P2's, is timed by that call on the host clock, as
   ``SLOW_TWIN_S`` says). Each kernel's bound is the larger of the bytes
   it must move over the card's memory rate and the integer operations it
   must do over the card's INT32 rate, both counted from this run's inputs
   (B1's cost per candidate read from the built kernel's SASS,
   ``cuobjdump``; B5's instructions per candidate by pipe, from the same
   SASS, explain its time and are reported beside it). P1 is a chain of
   dependent steps: its bound is its longest channel's step count times one
   dependent shared-memory round trip, measured in this run by a chain of
   shared-memory reads (``smoke_csrc/smem_chase.cu``, a library of this
   script's own, printed as ``smem``); P2's the same with its longest lane's
   steps;
4. encode the corpus end to end on each DEFLATE encode path (one warm run,
   median of three each), check that zlib gives the corpus back, every
   block status is ok, and the path launched its kernels; decode the
   gzip_lex stream on gzip_decode (one warm run, whose first batch is
   kept, median of three) and require every decode to give the corpus
   with 4 P3 launches; a stream with one byte flipped inside a dynamic
   block to raise and mark every block failed; the first 4 blocks decoded
   on the CPU (P3's plain version) to equal the card's decode; and P3 to
   equal its plain version on the kept batch (rec, outp and bad), with the
   path's 12-bit tables at (K, RSTEPS) = (6, 26) and, as its second shape,
   with the dyn route's 15-bit tables (``inflate_dyn``) at (1, 128);
   decode the stdlib gzip stream on gzip_foreign_decode (one warm decode,
   whose waves are recorded, then three timed; each one-shot into a buffer
   of the corpus length plus 16) and require every decode to give the
   corpus with status Finished and P4 launched; the stream with one byte
   flipped in the middle of its first dynamic block not to finish; the
   stream cut in half to return NeedInput; the first 1 MiB's own gzip
   stream to decode to the same bytes on the CPU (P4's plain version) and
   the card; and P4 to equal its plain version exactly on two waves, the
   first wave of the first dynamic block and the stream's last wave, where
   lanes retire on the stream's end (its lanes' five words, and its records
   below each lane's ``nrec``: only those are defined);
5. run adler_device and require each block's adler32 to equal
   ``zlib.adler32`` and the zlib_hash path's metas;
6. encode the corpus on zstd_device (one warm run, median of three) and
   require (i) the frame to equal the frame of the host literal and
   sequence writers (``device_literals=False, device_sequences=False``),
   (ii) in every tokenizer call of the warm run, the tokens to tile the
   call's bytes and every match's bytes to equal those at its distance,
   (iii) the first 2 MiB encoded on the CPU (the plain versions) to equal
   the card's frame, and the frame to walk as 128 blocks to its checksum;
   then decode that frame on zstd_decode (one timed decode, a cut
   printed as such: ``ZSTD_DECODE_CUT``; nothing is left to warm) and
   require it to give the corpus with status Finished, the first 2 MiB's CPU frame to decode on the CPU (P2's plain
   version) to the bytes the card gives, and, after P2's check, the host
   literal route (``device_literals=False``) to give the corpus too;
7. encode the corpus on brotli_device (one warm run, median of three) and
   require (i) in every tokenizer call of the warm run, the tokens to tile
   the call's bytes and every match's bytes to equal those at its
   distance (at most 2^20), (ii) the stream to be the JAX reference's
   (``BROTLI_BYTES``, ``BROTLI_SHA256``), (iii) the first 2 MiB encoded on
   the CPU (the plain versions) to equal the card's stream, (iv) the
   port's decoder to give the corpus back (one decode, timed), (v) the
   system's libbrotlidec, where it loads through ctypes, to give it back
   too (a line says whether it was found), and (vi) the one-shot
   65,536-byte input with a repeat past WBITS=16's window to be written
   with WBITS=16 and to decode;
8. encode the corpus on gzip_fixed_v2 (one warm run, median of three) and
   require zlib to give it back, every block to be a fixed-Huffman block,
   and every read-back (one warm, three timed, 4 P3 launches each) to give
   the corpus; run mesh_encode and require (i) the total to equal the sum
   of the gathered lengths, the stream (the blocks and a final empty
   stored block) to decode through stdlib zlib and through
   ``decoder.Interface.zlib_device`` on the card, and the gathered adlers
   to combine to the corpus's adler32; (ii) every literal stream to equal
   the host writer's (``HufEncoder.encode_stream``, run meanwhile in 6
   worker processes); (iii) each block's lane-sharded registers to fold to
   its zlib.crc32; and ``dryrun_multichip(1)`` to pass;
9. encode the first 4 blocks on the CPU (the twins) and on the card, on
   each DEFLATE encode path (the first 16 on gzip_fixed_v2), and require
   equal bytes, metas and segment index;
10. encode ``tests/data/alice29.txt`` through ``Interface.zlib_device()``;
11. (after 7) run the host paths: three encodes and three native decodes
   a pair (one for ``Interface.zlib()`` and the Python decoders), every
   decode giving its input; zstd_device (iv) holds the frame to
   ``ZSTD_BYTES`` and brotli_device (ii) the stream to ``BROTLI_BYTES``,
   the sizes of the Python host stages; then **native_twins**: every
   helper of the runtime equal to its Python twin on the corpus's first
   MiB (``optimal_parse`` and ``promote_rep`` of zstd held to the data;
   their twins are held to them in the CPU tests);
12. run the host routes and engines (three encodes each, zstd_host_l19
   one) and gzip_v1 (one warm encode, three timed), with their checks.

A line before the report gives the run's seconds from start to the
report, the kernels' build included, with the card's name and power
limit, as the side-by-side line of every path's MB/s and ratio does.

The last two lines printed are the kernel report and the result, each one
JSON object. Each kernel entry carries ``ms``, ``plain_ms``, ``bound_ms``
(with the ``bytes`` and ``ops`` it counts), ``bound_by``,
``share_of_bound`` (bound_ms / ms), ``launches`` (on its path's run) and
``launches_per_encode`` (per decode for P2, P3 and P4), and
``library_ms`` null with the reason: no one PyTorch call computes any of
the nine functions. P1's, P2's and P3's entries also carry ``cycles_per_step``
(kernel ms at the SM clock of the shared-memory chase, over the longest
chain's steps; P3's steps are its longest lane's table reads),
``sass_per_step`` (one step of the main loop in the built SASS, by pipe;
P3's is one loop iteration, up to two tokens) and ``dynamic_smem_bytes``;
P3's also carries its second shape under ``other_shapes``, and so does
P4's (the last wave), whose entries carry ``cycles_per_step`` (its
longest lane's table reads) but no SASS step. B1's and B2's entries are
their gzip_lex shapes, with their zstd_device and brotli_device shapes
under ``other_paths``, each with its path's launches; B1-B3 also at
gzip_fixed_v2's shapes there. Every entry also carries
``launches_by_path``, its launches on each path that launched it.
Without a CUDA device it fails and prints no result.

``--profile`` runs none of that. It encodes the corpus on each encode path
(gzip_fixed_v2 and mesh_encode's sharded step among them, brotli_device
last), decodes the gzip_lex and gzip_fixed_v2 streams with their index,
the stdlib gzip stream (gzip_foreign_decode) and the zstd frame, once
with every stage
synchronised before and after (ms per stage; for gzip_decode and
gzip_foreign_decode also the doubling rounds; for zstd_device the
tokenizer calls, the sequences from the tokens, the literal and sequence
sections, xxh64 and the rest; for brotli_device the
tokenizer calls, the commands, the distance plan with the histograms, the
context model, the prefix codes' descriptions with the header, the body's
emission and the rest), and once under ``torch.profiler``. From the profile
it counts the CUDA kernels and copies, takes the union of their intervals
as the device's busy time, and prints the idle share of the profiled wall
time and the six kernels with the most device time, one JSON line a path.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import json
import math
import multiprocessing
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from compu_tpu_torch import BlockParallelDecoder, BlockParallelEncoder, DecodeStatus, ZlibMode
from compu_tpu_torch import ZlibOptions, _build, decoder, make_block_encode_fn
from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface
from compu_tpu_torch.formats.brotli import encode as brotli_encode_mod
from compu_tpu_torch.formats.brotli.options import BrotliOptions
from compu_tpu_torch.formats.deflate import deflate_encode
from compu_tpu_torch.formats.deflate.options import ZlibStrategy
from compu_tpu_torch.formats.deflate import device_inflate
from compu_tpu_torch.formats.zstd import decode as zstd_decode_mod
from compu_tpu_torch.formats.zstd import encode as zstd_encode_mod
from compu_tpu_torch.formats.zstd import huff as zstd_huff
from compu_tpu_torch.formats.zstd import native_enc as zstd_native_enc
from compu_tpu_torch.formats.zstd import tables as zstd_tables
from compu_tpu_torch.formats.zstd.encode import MAX_BLOCK as ZSTD_BLOCK
from compu_tpu_torch.formats.zstd.options import ZstdDecodeOptions, ZstdOptions
from compu_tpu_torch.kernels import deflate_v2, deflate_v3, inflate_dyn, inflate_lut, u32
from compu_tpu_torch.kernels import inflate as inflate_mod
from compu_tpu_torch.kernels import inflate_spec, zstd_lit_decode, zstd_seq
from compu_tpu_torch.kernels.adler_tiles import (
    adler32_device,
    adler32_partials_cuda,
    adler32_partials_torch,
)
from compu_tpu_torch.kernels.block_codec import (
    _LEVEL,
    DEV_DEPTH,
    DEV_KEYS,
    DEV_STRIDE,
    DEV_WCAP,
    _encode_blocks_batched,
)
from compu_tpu_torch.kernels.deflate_v2 import (
    _fixed_pack_inputs,
    _post_match,
    _sort_stage,
    encode_blocks_fixed_v2,
    match_and_parse_batch,
)
from compu_tpu_torch.kernels.deflate_v3 import (
    _build_tables,
    _pack_inputs,
    _tok_hist_from_match,
    encode_blocks_dyn,
)
from compu_tpu_torch.kernels.emit_pack import emit_pack_cuda, emit_pack_torch
from compu_tpu_torch.kernels.histogram import byte_histogram
from compu_tpu_torch.kernels.inflate_scan import (
    NO_TOKEN,
    SEG,
    inflate_scan_cuda,
    inflate_scan_torch,
)
from compu_tpu_torch.kernels.inflate_spec import spec_scan_wave_cuda, spec_scan_wave_torch
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
from compu_tpu_torch.kernels.parse_cover import parse_cover_cuda, parse_cover_steps_torch
from compu_tpu_torch.kernels.zstd_lit_decode import huf_decode_lanes_cuda, huf_decode_lanes_torch
from compu_tpu_torch.kernels.zstd_seq import fse_seq_scan_cuda, fse_seq_scan_torch
from compu_tpu_torch.entry import TERM, dryrun_multichip, free_port
from compu_tpu_torch.formats.zstd.huff import HufEncoder
from compu_tpu_torch.ops import checksum
from compu_tpu_torch.ops.xxhash import xxh64, xxh64_py
from compu_tpu_torch.parallel import mesh as pmesh
from compu_tpu_torch.parallel import scheduler
from compu_tpu_torch.parallel.scheduler import (
    BlockIndex,
    BlockState,
    make_host_block_encode_fn,
    parallel_zstd_compress,
)
from compu_tpu_torch.runtime import native
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
# The zstd path: the reference's device zstd encode at its defaults
# (window_log 17: max_dist 131,071; 1 MiB tokenizer calls of depth 8, wcap
# 32, two sort keys; 128 KiB frame blocks; the xxh64 checksum).
ZSTD_OPTS = dict(device_lz=True, device_literals=True, device_sequences=True)
ZSTD_SPAN = 8 * ZSTD_BLOCK
ZSTD_LCP = dict(depth=8, max_dist=(1 << 17) - 1, block_elems=ZSTD_SPAN)
ZSTD_CPU_BYTES = 2 << 20  # the head the CPU encodes for check (iii)
ZSTD_BYTES = 5_739_836  # the frame of the corpus, as the Python host stages write it
ZSTD_DECODE_CUT = ("one timed decode of the frame, not three: the host's sequence execution "
                   "takes 60-90 s a decode")
# The brotli path: Interface.brotli at its defaults (quality 9, window 22,
# Generic): one 1 MiB meta-block a tokenizer call (B1 at depth 8, wcap 32,
# two sort keys, max_dist 2^20). Its stream of the corpus is the JAX
# reference's: compu_tpu's BrotliStreamEncoder(quality=9, window_bits=22,
# device_lz=True) over build_corpus(16 << 20) in 1 MiB chunks gives these
# bytes, and so does the port's encode on the CPU
# (tests/test_torch_brotli.py holds the two equal on smaller inputs).
BROTLI_SPAN = brotli_encode_mod.TOKENIZER_SPAN
BROTLI_LCP = dict(depth=8, max_dist=1 << 20, block_elems=BROTLI_SPAN)
BROTLI_BYTES = 4_598_212
BROTLI_SHA256 = "01501c025e6581e3c9bc5be5a645ced32be48fa860e5549e1898053d33ee5358"
BROTLI_CPU_BYTES = 2 << 20  # the head the CPU encodes for check (iii)
# The v2 route: make_block_encode_fn(kernel="v2") at LEVEL matches with
# match_and_parse_batch's defaults (wcap 32, two sort keys, stride 1) at
# depth min(host ladder depth, 8), and writes fixed-Huffman blocks only.
V2_DEPTH = min(_LEVEL[LEVEL][0], 8)
V2_LCP = dict(depth=V2_DEPTH, max_dist=MAX_DIST, block_elems=BLOCK)
V2_CPU_BLOCKS = 16  # the head the CPU encodes for its bytes check
# The mesh path's zstd literal step: the corpus as 128 frame blocks of
# 128 KiB, 4 streams each, under one Huffman table from its byte counts.
LIT_BLOCK = 1 << 17

# The kernels each path must launch.
PATHS = {
    "gzip_lex": ("lcp_candidates", "parse_cover", "emit_pack"),
    **{p: ("match_candidates", "parse_cover", "emit_pack") for p in HASH_PATHS},
    "adler_device": ("adler_tiles",),
    "zstd_device": ("lcp_candidates", "parse_cover", "fse_seq_scan"),
    "zstd_decode": ("huf_decode_lanes",),
    "gzip_decode": ("inflate_scan",),
    "gzip_foreign_decode": ("inflate_spec",),
    "brotli_device": ("lcp_candidates", "parse_cover"),
    "gzip_fixed_v2": ("lcp_candidates", "parse_cover", "emit_pack"),
    "gzip_fixed_v2_decode": ("inflate_scan",),
    "mesh_encode": ("lcp_candidates", "parse_cover", "emit_pack"),
    # The host backends, routes and engines: they launch no kernel
    # (checked: every count 0).
    **{p: () for p in ("zlib_host", "zlib_native", "zstd_native", "brotli_native",
                       "gzip_decode_host", "native_twins", "zstd_host", "zstd_host_l19",
                       "brotli_host", "zlib_host_parallel", "zstd_parallel")},
    # The v1 step: plain PyTorch on the card, none of the nine kernels
    # (checked); its CUDA kernels are counted under torch.profiler.
    "gzip_v1": (),
}
HOST_PATHS = ("zlib_host", "zlib_native", "zstd_native", "brotli_native", "gzip_decode_host")
HOST_ROUTES = ("zstd_host", "zstd_host_l19", "brotli_host", "zlib_host_parallel", "zstd_parallel")
# zstd_host_l19's cut: level 19 over the corpus's first 4 MiB.
ZSTD_L19_BYTES = 4 << 20
# The host routes' streams of the corpus (of its first 4 MiB for
# zstd_host_l19) are the JAX reference's: compu_tpu's Interface.zstd(
# ZstdOptions(level=3 or 19, window_log=17)) and Interface.brotli(
# BrotliOptions(quality=9, window_bits=22)) (device_lz off, their default),
# BlockParallelEncoder(make_host_block_encode_fn(Gzip, 6), block_size=
# 256 KiB) and parallel_zstd_compress(level=3) give these bytes, and so
# does the port on the CPU (tests/test_torch_{zstd,brotli}_host.py and
# tests/test_torch_host_engines.py hold the two equal on smaller inputs).
HOST_ROUTE_STREAMS = {
    "zstd_host": (6_002_256, "c745d4b8e3da5dae5f83ea34d0288badcdc3b3dd4076ac4e3ada3f8a636147aa"),
    "zstd_host_l19": (1_269_942,
                      "8a3b95fc362b128010496a8f49bc97450c890823c68395c207a4ec4bbb0128d2"),
    "zstd_parallel": (3_817_032,
                      "bab2b446bf5fe68f7728cfa7a74f1b61f4662c6cc5014ca2f47325d262e09171"),
    "zlib_host_parallel": (5_910_375,
                           "51c8d8deda269c6f72c77209a67b322c663b4d23ca822d379fbe5414a32f0871"),
    "brotli_host": (3_934_866, "f6fd919ddca8ae441e5942dd3ab26dbc48a437f047b8ce7ca8550bc614869162"),
}
# gzip_v1's stream of the corpus: the port's v1 step on the CPU
# (make_block_encode_fn(Gzip, 6, kernel="v1", device="cpu") through
# BlockParallelEncoder at 256 KiB blocks); the reference's step raises, so
# tests/test_torch_v1.py holds the port to its blocks one by one.
V1_STREAM = (7_638_354, "220cd111eb8348b5d3314fde2dcde1d1c43f4b74c7ddba0a42f6de9269e44206")
# The first MiB of the corpus: the native_twins phase's input.
TWIN_BYTES = 1 << 20

# The card's rates the bounds are taken against: the H100 SXM's device
# memory rate (NVIDIA's data sheet), and its INT32 issue rate, 64 INT32
# lanes per SM x 132 SMs x the 1.98 GHz boost clock. All nine kernels do
# integer work outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Launches timed back to back cycle through enough copies of the inputs
# that each launch reads at least this many bytes no launch since its
# last use has touched (twice the 50 MB L2), so every launch reads its
# inputs from device memory, as the bound assumes.
COLD_BYTES = 100 << 20
# The cost of one B1 candidate in the built kernel (lcp_candidate_cost),
# and of one B5 candidate at each hash shape (match_candidate_cost), read
# from their SASS once the library is built.
LCP_COST: dict = {}
LCP_FAR_COST: dict = {}
MATCH_COST: dict = {}
# This script's own CUDA sources, built beside the package's kernels: the
# shared-memory chase that measures P1's, P2's and P3's bound unit.
SMOKE_SOURCES = sorted((pathlib.Path(__file__).resolve().parent / "smoke_csrc").glob("*.cu"))


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
        pipe = _pipe(m.group(1))
        if pipe is not None:
            counts[pipe] += 1
    if not found or not counts:
        raise AssertionError(f"no kernel {symbol} in the SASS of {lib_path.name}")
    return collections.Counter({k: v / found for k, v in counts.items()})


def lcp_candidate_cost(lib_path) -> dict:
    """What one B1 candidate costs in the compiled kernel: the instructions
    that ``lcp_kernel<16, FAR>`` has more than ``lcp_kernel<8, FAR>``, both
    unrolled, over the 64 candidates a thread weighs more (4 lanes x 2
    directions x 8 depths), so that staging, ``adj`` and the epilogue
    cancel; the nearer rule's (FAR false) and, under ``far``, the far
    tie's. ``cost`` is the time of one candidate in INT32-lane issues (64
    per SM and clock): the busiest of the ALU, the FMA pipe, the XU (at a
    quarter of the rate) and issue (at twice the rate)."""
    cost = _cost_per_candidate(lib_path, "lcp_kernelILi16ELb0E", "lcp_kernelILi8ELb0E", 64)
    cost["far"] = _cost_per_candidate(lib_path, "lcp_kernelILi16ELb1E", "lcp_kernelILi8ELb1E", 64)
    return cost


def _cost_per_candidate(lib_path, more: str, fewer: str, extra: int) -> dict:
    """Instructions by pipe that kernel ``more`` has beyond ``fewer``, over
    the ``extra`` candidates a thread weighs more; ``cost`` as in
    :func:`lcp_candidate_cost`."""
    a, b = sass_counts(lib_path, more), sass_counts(lib_path, fewer)
    per = {k: (a[k] - b[k]) / extra for k in ("alu", "fma", "xu", "mem")}
    per["cost"] = max(per["alu"], per["fma"], 4 * per["xu"], sum(per.values()) / 2)
    return per


def match_candidate_cost(lib_path) -> dict:
    """What one B5 candidate costs in the compiled kernel, per hash shape:
    ``match_kernel<32, 4>`` beyond ``<16, 4>`` over the 64 more candidates
    a thread weighs (4 lanes x 16 depths), and ``<16, 8>`` beyond ``<8, 8>``
    over 32. Both walks are unrolled and the extra depths fall in the same
    32-d chunk, so staging, the word loop for equal first words (phase B)
    and the epilogue cancel. The count includes the block-start patch of
    the extra groups (8 instructions per 16 candidates), which only threads
    within depth of a block start run."""
    return {"wcap16_depth32": _cost_per_candidate(lib_path, "match_kernelILi32ELi4E",
                                                  "match_kernelILi16ELi4E", 64),
            "wcap32_depth16": _cost_per_candidate(lib_path, "match_kernelILi16ELi8E",
                                                  "match_kernelILi8ELi8E", 32)}


def _pipe(op: str) -> str | None:
    """The pipe of a SASS opcode (as :func:`sass_counts` sorts them), or
    None for the control, special-register and uniform ones it leaves out."""
    base = op.split(".")[0]
    if base in SASS_SKIP or base.startswith("U"):
        return None
    return ("fma" if base in SASS_FMA else "xu" if base in SASS_XU
            else "mem" if base in SASS_MEM else "alu")


def sass_loops(lib_path, symbol: str) -> list[list[tuple]]:
    """The loops of kernel ``symbol`` (its first function in the library's
    ``cuobjdump -sass``): for each backward branch, the instructions
    (address, opcode, operands) from its target up to it."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ins, labels, inside = [], {}, False
    for line in text.splitlines():
        if "Function :" in line:
            if ins:
                break
            inside = symbol in line
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            labels[lab.group(1)] = len(ins)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    at = {addr: k for k, (addr, _, _) in enumerate(ins)}
    loops = []
    for k, (_, op, rest) in enumerate(ins):
        if op.split(".")[0] != "BRA":
            continue
        tgt = re.search(r"0x([0-9a-f]+)", rest)
        lab = re.search(r"(\.L_x_\d+)", rest)
        start = at.get(int(tgt.group(1), 16)) if tgt else labels.get(lab.group(1)) if lab else None
        if start is not None and start <= k:
            loops.append(ins[start:k + 1])
    if not ins:
        raise AssertionError(f"no kernel {symbol} in the SASS of {lib_path.name}")
    return loops


def sass_step_loop(lib_path, symbol: str, load: str, loads_per_step: int,
                   steps: int) -> dict:
    """One step of a chain kernel's main loop in the built library's SASS:
    the loop of kernel ``symbol`` that holds ``loads_per_step * steps``
    shared loads of opcode ``load`` (the table reads), i.e. ``steps`` steps
    an iteration (of several, the smallest of those that read no device
    memory: P2's path over staged rows); its instructions by pipe divided
    by ``steps``, and the iteration's whole count."""
    want = loads_per_step * steps
    fits = [body for body in sass_loops(lib_path, symbol)
            if sum(op == load for _, op, _ in body) == want]
    if not fits:
        raise AssertionError(f"no loop of {symbol} with {want} {load} in {lib_path.name}")
    body = min(fits, key=lambda b: (any(op.startswith("LDG") for _, op, _ in b), len(b)))
    counts = collections.Counter(_pipe(op) for _, op, _ in body)
    return {"steps_per_iteration": steps, "iteration_instructions": len(body),
            **{k: counts[k] / steps for k in ("alu", "fma", "xu", "mem")}}


# Work of each kernel on one call: (bytes, ops) from the inputs, keywords
# and outputs. Bytes count each input once and each output once; ops count
# the integer operations the function needs on these inputs, per unit:
def lcp_work(args, kw, outs):
    """Per lane and direction, the candidates until the running min of
    ``adj`` is 0 (a candidate past it has length 0 and cannot win; the one
    that finds the 0 counts), each at the compiled kernel's cost
    (``LCP_COST``, from its SASS; the far tie's under ``prefer_far``), and
    3 ops per window word for ``adj`` (xor, leading zeros, accumulate)."""
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
    cost = LCP_COST["far"] if kw.get("prefer_far") else LCP_COST
    return _nbytes(words, ps, *outs), needed * cost["cost"] + 3 * W * n


def parse_work(args, kw, outs):
    """The whole function from the int64 steps: 3 ops (clamp, add, min) a
    position for its jump target, and 3 (load, compare, store) a position
    the orbit visits. Bytes: the steps in, the bool mask out."""
    (step,) = args
    return _nbytes(step, outs), 3 * step.numel() + 3 * int(outs.sum())


def emit_work(args, kw, outs):
    """8 ops (extract, add) per field whose value is not 0: a zero field
    adds nothing."""
    bytep, shifted = args
    return _nbytes(bytep, shifted, outs), 8 * int((shifted != 0).sum())


def adler_work(args, kw, outs):
    """2 ops per byte: the sum and the weighted sum."""
    (flat,) = args
    return _nbytes(flat, outs), 2 * flat.numel()


def scan_work(args, kw, outs):
    """The longest channel's chain: nseq - 1 dependent steps for a channel
    with a table, each at least one shared-memory round trip, so the ops'
    time is the steps times that latency (``smem_round_trip``) and not the
    INT32 rate's. Bytes: the codes and tables in, the pushes and final
    states out."""
    ens = args[5]
    steps = kw["nseq"] - 1 if bool((ens > 0).any()) else 0
    smem = smem_round_trip()
    return _nbytes(*args, *outs), steps, {
        "ops_ms": steps * smem["ns"] * 1e-6, "ns_per_op": smem["ns"],
        "bound_note": f"the longest channel's dependent steps x one shared-memory read, "
                      f"{smem['cycles']:.2f} cycles ({smem['ns']:.3f} ns) each, measured in this "
                      f"run by one thread chasing i = ring[i] {smem['steps']} times through "
                      f"shared memory (smoke_csrc/smem_chase.cu)"}


def lit_decode_work(args, kw, outs):
    """The longest lane's chain: min(count, max_steps) dependent steps, each
    at least one shared-memory round trip (the table read), as
    :func:`scan_work`. Bytes: the streams, lane counts and tables in, the
    literals and flags out."""
    counts = args[2]
    steps = int(torch.clamp(counts, 0, kw["max_steps"]).max())
    smem = smem_round_trip()
    return _nbytes(*args, *outs), steps, {
        "ops_ms": steps * smem["ns"] * 1e-6, "ns_per_op": smem["ns"],
        "bound_note": f"the longest lane's dependent steps x one shared-memory read, "
                      f"{smem['cycles']:.2f} cycles ({smem['ns']:.3f} ns) each, measured in this "
                      f"run (smoke_csrc/smem_chase.cu)"}


def p3_inputs(arrays) -> dict:
    """P3's two shapes on one of the decoder's batches (its upload, on the
    card: comps, seg_bits, ns and the lit/len and distance code lengths):
    ``lut``, the 12-bit tables at (K, RSTEPS) = (6, 26), as the LUT route
    the path takes builds them, and ``dyn``, the dyn route's 15-bit tables
    (``inflate_dyn``) at (1, 128). Returns {shape: (args, kw)}."""
    comps, segs, ns, lit, dist = arrays
    return {"lut": ((comps, segs, ns, inflate_lut._lit_lut_block(lit),
                     inflate_lut._dist_lut_block(dist)),
                    dict(k=inflate_lut.K, rsteps=inflate_lut.RSTEPS)),
            "dyn": ((comps, segs, ns, inflate_lut._lit_lut_block(lit, inflate_dyn.MAXB),
                     inflate_lut._dist_lut_block(dist, inflate_dyn.MAXB)),
                    dict(k=1, rsteps=SEG))}


def inflate_scan_work(args, kw, outs):
    """The longest lane's chain of table reads: one for a literal, two for a
    match (the lit/len read, then the distance read at the offset it
    gives), each at least one shared-memory round trip, as
    :func:`scan_work`. Bytes: the spans of ``comps`` the lanes read (each
    decoded block's bytes up to its last non-zero byte, where its sync
    flush ends), the tables, ``seg_bits`` and ``ns`` in; the records,
    ``outp`` and ``bad`` out."""
    comps, seg_bits, ns, lit_lut, dist_lut = args
    rec = outs[0].to(torch.int64)
    took = rec != NO_TOKEN
    lits = (took & (((rec >> 9) & 1) == 1)).sum(1)
    reads = int((2 * took.sum(1) - lits).max())
    nonzero = comps != 0
    ends = comps.shape[1] - torch.argmax(nonzero.flip(1).to(torch.uint8), 1)
    spans = int(torch.where((ns > 0) & nonzero.any(1), ends, 0).sum())
    smem = smem_round_trip()
    return spans + _nbytes(seg_bits, ns, lit_lut, dist_lut, *outs), reads, {
        "ops_ms": reads * smem["ns"] * 1e-6, "ns_per_op": smem["ns"], "comps_span_bytes": spans,
        "bound_note": f"the longest lane's dependent table reads x one shared-memory read, "
                      f"{smem['cycles']:.2f} cycles ({smem['ns']:.3f} ns) each, measured in this "
                      f"run (smoke_csrc/smem_chase.cu)"}


def spec_defined(got, want):
    """P4's defined outputs: the lanes' five words, and each lane's record
    slots below its ``nrec`` (``want``'s, which ``got``'s must equal in the
    lanes); the slots past it are left unwritten by the kernel."""
    defined = (torch.arange(inflate_spec.RF, device=want[1].device)[:, None]
               < want[0][3][None, :])
    return (got[0], got[1][defined]), (want[0], want[1][defined])


def spec_scan_work(args, kw, outs):
    """P4's chain: the longest lane's table reads, one for a literal and for
    the EOB, two for a match (the lit/len read, then the distance read at
    the offset it gives), each at least one shared-memory round trip, as
    :func:`scan_work` (a code longer than 12 bits adds its walk, which is
    not counted). Bytes: the stream bytes the wave can read (its 256 chunks
    and the most a token step reaches past the last, up to the stream's
    end) and the block's tables in; the lanes' five words and the defined
    records (sum of ``nrec`` x 4 B) out."""
    comp, tables = args
    lanes, rec = outs
    nrec = lanes[3].to(torch.int64)
    took = torch.arange(inflate_spec.RF, device=rec.device)[:, None] < nrec[None, :]
    lits = (took & (((rec.to(torch.int64) >> 9) & 1) == 1)).sum(0)
    reads = int((2 * nrec - lits + (lanes[2] & 1)).max())
    first = kw["wave_bit0"] // 8
    last = min(-(-kw["total_bits"] // 8),
               -(-(kw["wave_bit0"] + inflate_spec.WAVE_CHUNKS * inflate_spec.C
                   + inflate_spec.MAX_PHASE + 48) // 8))
    span = max(0, last - first)
    smem = smem_round_trip()
    records = 4 * int(nrec.sum())
    return span + records + _nbytes(tables, lanes), reads, {
        "ops_ms": reads * smem["ns"] * 1e-6, "ns_per_op": smem["ns"], "stream_span_bytes": span,
        "record_bytes": records,
        "bound_note": f"the longest lane's dependent table reads x one shared-memory read, "
                      f"{smem['cycles']:.2f} cycles ({smem['ns']:.3f} ns) each, measured in this "
                      f"run (smoke_csrc/smem_chase.cu)"}


@functools.lru_cache(maxsize=1)
def smem_round_trip(steps: int = 1 << 20) -> dict:
    """One dependent shared-memory read on this card: one thread chases
    ``i = ring[i]`` through shared memory ``steps`` times
    (``smoke_csrc/smem_chase.cu``). ``ns`` from CUDA events around the
    launch, ``cycles`` from the SM's clock64 inside it, both per read."""
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib = ctypes.CDLL(str(_build.build(SMOKE_SOURCES, "libcompu_smoke")))
    lib.compu_smem_chase.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.compu_smem_chase.restype = ctypes.c_int
    if lib.compu_smem_chase(out.data_ptr(), steps, stream):
        raise RuntimeError("compu_smem_chase failed to launch")
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lib.compu_smem_chase(out.data_ptr(), steps, stream)
    end.record()
    torch.cuda.synchronize()
    res = {"ns": start.elapsed_time(end) * 1e6 / steps, "cycles": int(out[1]) / steps,
           "steps": steps}
    log("smem dependent shared-memory read " + json.dumps(res))
    return res


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


def match_phase_b(args, kw) -> dict:
    """What B5's two phases meet in these inputs: the share of in-block
    candidates that are matches (equal hash, distance in range), the share
    of matches whose first two window words are equal (B5's phase B), and
    those per lane, per thread of 4 lanes and for the busiest thread of each
    warp of 32 threads, averaged over warps."""
    hs, ps, words = args
    n = hs.shape[0]
    lpos = torch.arange(n, device=hs.device) & (kw["block_elems"] - 1)
    inblock = matches = 0
    both = torch.zeros(n, dtype=torch.int64, device=hs.device)
    for d in range(1, kw["depth"] + 1):
        dist = ps - torch.roll(ps, d)
        ok = (lpos >= d) & (hs == torch.roll(hs, d)) & (dist > 0) & (dist <= kw["max_dist"])
        inblock += int((lpos >= d).sum())
        matches += int(ok.sum())
        both += ok & (words[0] == torch.roll(words[0], d)) & (words[1] == torch.roll(words[1], d))
    thread = both.reshape(-1, 4).sum(1)
    return {"match_share": matches / inblock, "phase_b_share": int(both.sum()) / matches,
            "phase_b_per_lane": both.double().mean().item(),
            "phase_b_per_thread": thread.double().mean().item(),
            "phase_b_busiest_thread_per_warp": thread.reshape(-1, 32).max(1).values
            .double().mean().item()}


NO_LIBRARY = "no one PyTorch call computes this function"


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel of the report. ``paths`` are the paths at whose shapes it
    is held to its twin (the first gives its report entry). ``work`` gives
    (bytes, ops) of one call, and for a kernel bound by a chain of dependent
    steps rather than by the INT32 rate a third item: the ops' time
    (``ops_ms``) with its basis, which goes into the report. ``defined``,
    where set, maps (kernel outputs, twin outputs) to the parts of both
    that are defined, which are compared; else all of them are."""

    kernel: object
    twin: object
    source: str
    replaces: str
    paths: tuple
    work: object
    replaces_note: str | None = None
    defined: object = None


KERNELS = {
    "lcp_candidates": Kernel(lcp_candidates_cuda, lcp_candidates_torch,
                             "compu_tpu_torch/csrc/lcp_candidates.cu",
                             "compu_tpu/kernels/lcp_match.py:169",
                             ("gzip_lex", "zstd_device", "brotli_device", "gzip_fixed_v2"),
                             lcp_work),
    "parse_cover": Kernel(parse_cover_cuda, parse_cover_steps_torch,
                          "compu_tpu_torch/csrc/parse_cover.cu",
                          "compu_tpu/kernels/parse_pallas.py:39",
                          ("gzip_lex", "zstd_device", "brotli_device", "gzip_fixed_v2"),
                          parse_work,
                          replaces_note="with the jump targets and the > 0 around it: the whole "
                                        "of parse_cover_pallas (parse_pallas.py:64)"),
    "emit_pack": Kernel(emit_pack_cuda, emit_pack_torch,
                        "compu_tpu_torch/csrc/emit_pack.cu",
                        "compu_tpu/kernels/emit_pallas.py:32", ("gzip_lex", "gzip_fixed_v2"),
                        emit_work),
    "match_candidates": Kernel(match_candidates_cuda, match_candidates_torch,
                               "compu_tpu_torch/csrc/match_candidates.cu",
                               "compu_tpu/kernels/match_pallas.py:50", tuple(HASH_PATHS),
                               match_work),
    "adler_tiles": Kernel(adler32_partials_cuda, adler32_partials_torch,
                          "compu_tpu_torch/csrc/adler_tiles.cu",
                          "compu_tpu/kernels/pallas_kernels.py:31", ("adler_device",),
                          adler_work),
    "fse_seq_scan": Kernel(fse_seq_scan_cuda, fse_seq_scan_torch,
                           "compu_tpu_torch/csrc/fse_seq_scan.cu",
                           "compu_tpu/kernels/zstd_seq_jax.py:84", ("zstd_device",), scan_work,
                           replaces_note="a jax.lax.scan, not a TPU kernel"),
    "huf_decode_lanes": Kernel(huf_decode_lanes_cuda, huf_decode_lanes_torch,
                               "compu_tpu_torch/csrc/huf_lit_decode.cu",
                               "compu_tpu/kernels/zstd_lit_decode_jax.py:32", ("zstd_decode",),
                               lit_decode_work,
                               replaces_note="a jax.lax.fori_loop, not a TPU kernel"),
    "inflate_scan": Kernel(inflate_scan_cuda, inflate_scan_torch,
                           "compu_tpu_torch/csrc/inflate_scan.cu",
                           "compu_tpu/kernels/inflate_jax_lut.py:243", ("gzip_decode",),
                           inflate_scan_work,
                           replaces_note="the token scans of decode_blocks_indexed_lut (the "
                                         "jax.lax.while_loop at inflate_jax_lut.py:243, steps at "
                                         ":166), decode_blocks_indexed_dyn (inflate_jax_dyn.py:206"
                                         ", :153) and decode_blocks_indexed (inflate_jax.py:204, "
                                         ":138), not TPU kernels"),
    "inflate_spec": Kernel(spec_scan_wave_cuda, spec_scan_wave_torch,
                           "compu_tpu_torch/csrc/inflate_spec.cu",
                           "compu_tpu/kernels/inflate_spec.py:58", ("gzip_foreign_decode",),
                           spec_scan_work,
                           replaces_note="spec_scan_wave, a jax.lax.while_loop (inflate_spec.py"
                                         ":162) over its step (:76), not a TPU kernel",
                           defined=spec_defined),
}
# A twin whose call for the equality check takes this long or more (P1's
# and P2's, Python loops of tiny launches a step) is timed by that call on
# the host clock, synchronised; the others with device_ms.
SLOW_TWIN_S = 0.1


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


def kernel_inputs(blocks: torch.Tensor, lens: torch.Tensor, flat: torch.Tensor,
                  zstd_call: torch.Tensor, scan_args):
    """The inputs each kernel receives on its path: B1-B3 and B5 for the
    (B, N) blocks as the port's stages compute them (B1-B3 also as the v2
    route computes them, and B1 with the far tie at the gzip_lex shape,
    ``(lcp_candidates, far)``), B4 the flat bytes, B1
    and B2 for the zstd and brotli paths' (1, 2^20) tokenizer call of the
    corpus's first MiB (max_dist 131,071 and 2^20), P1 the recorded
    ``scan_args``. Returns {(kernel, path): (args, kw)}."""
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
    is_tok, best_len, best_dist = match_and_parse_batch(blocks, ns, **LADDER)
    tok, lf, df, xl, xd = _tok_hist_from_match(blocks, ns, is_tok, best_len, best_dist)
    bytep, shifted, _, _ = _pack_inputs(tok, _build_tables(lf, df, xl, xd, ns), N)
    inputs = {
        ("lcp_candidates", "gzip_lex"): ((words, ps32), lcp_kw),
        ("parse_cover", "gzip_lex"): ((step.reshape(-1),), {}),
        ("emit_pack", "gzip_lex"): ((bytep, shifted), {}),
        ("adler_tiles", "adler_device"): ((flat,), {}),
        ("fse_seq_scan", "zstd_device"): scan_args,
        ("lcp_candidates", "far"): ((words, ps32), {**lcp_kw, "prefer_far": True}),
    }
    # The v2 route's match_and_parse_batch (its defaults, depth V2_DEPTH)
    # and its fixed-code fields.
    *vbe, vps = sort_stage_lex(blocks, wcap=32, keys=2, stride=1)
    vwords = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in vbe]))
    vps32 = vps.reshape(-1).to(torch.int32)
    vbl, vbd = lcp_candidates_torch(vwords, vps32, **V2_LCP)
    vstep, *_ = _post_match(blocks, ns, vps, vbl.reshape(B, -1).to(torch.int64),
                            vbd.reshape(B, -1).to(torch.int64), wcap=32)
    vbytep, vshifted, _, _ = _fixed_pack_inputs(
        blocks, *match_and_parse_batch(blocks, ns, depth=V2_DEPTH))
    inputs["lcp_candidates", "gzip_fixed_v2"] = ((vwords, vps32), dict(V2_LCP))
    inputs["parse_cover", "gzip_fixed_v2"] = ((vstep.reshape(-1),), {})
    inputs["emit_pack", "gzip_fixed_v2"] = ((vbytep, vshifted), {})
    # The zstd tokenizer's call: match_and_parse at its defaults (wcap 32,
    # two sort keys, stride 1) over one 1 MiB block.
    *zbe, zps = sort_stage_lex(zstd_call, wcap=32, keys=2, stride=1)
    zwords = u32.to_i32_bits(torch.stack([w.reshape(-1) for w in zbe]))
    zps32 = zps.reshape(-1).to(torch.int32)
    zbl, zbd = lcp_candidates_torch(zwords, zps32, **ZSTD_LCP)
    zstep, *_ = _post_match(zstd_call, torch.tensor([ZSTD_SPAN], device=zstd_call.device), zps,
                            zbl.reshape(1, -1).to(torch.int64),
                            zbd.reshape(1, -1).to(torch.int64), wcap=32)
    inputs["lcp_candidates", "zstd_device"] = ((zwords, zps32), dict(ZSTD_LCP))
    inputs["parse_cover", "zstd_device"] = ((zstep.reshape(-1),), {})
    # The brotli tokenizer's first call: the same sort, B1 at max_dist 2^20.
    bbl, bbd = lcp_candidates_torch(zwords, zps32, **BROTLI_LCP)
    bstep, *_ = _post_match(zstd_call, torch.tensor([BROTLI_SPAN], device=zstd_call.device), zps,
                            bbl.reshape(1, -1).to(torch.int64),
                            bbd.reshape(1, -1).to(torch.int64), wcap=32)
    inputs["lcp_candidates", "brotli_device"] = ((zwords, zps32), dict(BROTLI_LCP))
    inputs["parse_cover", "brotli_device"] = ((bstep.reshape(-1),), {})
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


def hold_to_twin(name: str, path: str, spec: Kernel, args, kw) -> dict:
    """One kernel against its plain twin on one path's inputs, exactly
    (tolerance 0: all nine are integer functions; only the defined outputs,
    ``Kernel.defined``), both timed, and the kernel's bound from the same
    inputs."""
    kernel, twin = spec.kernel, spec.twin
    got = as_tuple(kernel(*args, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = as_tuple(twin(*args, **kw))
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    held = spec.defined(got, want) if spec.defined else (got, want)
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(*held))
    same = all(torch.equal(g, w) for g, w in zip(*held))
    shapes = [tuple(a.shape) for a in args]
    if not same:
        raise AssertionError(f"{name} ({path}): kernel and plain twin disagree "
                             f"(max abs err {err}) on inputs {shapes} {kw}")
    nbytes, ops, *chain = spec.work(args, kw, want[0] if len(want) == 1 else want)
    chain = dict(chain[0]) if chain else {}
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = chain.pop("ops_ms", ops / INT32_OPS_PER_S * 1e3)
    ms = device_ms(kernel, args, kw, k=50)
    plain_ms = twin_s * 1e3 if twin_s >= SLOW_TWIN_S else device_ms(twin, args, kw, k=20)
    res = {"path": path, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "ops": ops, "library_ms": None, "library_note": NO_LIBRARY,
           **chain}
    res["share_of_bound"] = res["bound_ms"] / ms
    log(f"kernel {name} ({path}): inputs {shapes} {kw} equal={same} max_abs_err={err} "
        f"kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"by {res['bound_by']} ({nbytes} B, {ops} ops), share {res['share_of_bound']:.3f}")
    return res


def _lanes_smem(args, kw) -> int:
    """P2's dynamic shared memory: a section's rows (lanes x scap bytes)
    when they fit in 196 KiB (csrc/huf_lit_decode.cu), else none."""
    rows = args[0].shape[0] // args[5].shape[0] * args[0].shape[1]
    return rows if rows <= 196 << 10 else 0


# The chain kernels: per kernel, the SASS symbol of its kernel, the opcode
# of its table reads and their number a step, its steps an iteration of
# the main loop and the dynamic shared memory a block asks for, both for
# the inputs (args, kw). P1 walks 8 steps an iteration; P2 64 // max_bits
# (16 at most; its max_bits is args[5]); P3 one iteration of its loop
# for lanes whose reads all lie in the staged span: the three shared reads
# of its 64-bit window and its two table reads (a match, or up to two
# literals), at the 12-bit tables the path gives it, which sit in dynamic
# shared memory with the staged rows and span.
CHAIN_KERNELS = {
    "fse_seq_scan": ("fse_seq_scan_kernel", "LDS.U16", 1, lambda args, kw: 8,
                     lambda args, kw: _build.lib().compu_fse_seq_scan_smem()),
    "huf_decode_lanes": ("huf_decode_lanes_kernel", "LDS.U8", 2,
                         lambda args, kw: min(64 // max(int(args[5].max()), 1), 16),
                         _lanes_smem),
    "inflate_scan": ("inflate_scan_kernelILi12EE", "LDS", 5, lambda args, kw: 1,
                     lambda args, kw: _build.lib().compu_inflate_scan_smem(
                         args[3].shape[1].bit_length() - 1, kw["k"], kw["rsteps"])),
}


def chain_report(name: str, res: dict, args, kw) -> dict:
    """What a chain kernel's time is made of: its cycles a step (kernel ms
    x the SM clock of this run's shared-memory chase / the longest chain's
    steps), one step of its main loop in the SASS by pipe, and the dynamic
    shared memory it asks for."""
    symbol, load, loads, steps, smem = CHAIN_KERNELS[name]
    chase = smem_round_trip()
    per = sass_step_loop(_build.build(), symbol, load, loads, steps(args, kw))
    out = {"cycles_per_step": res["ms"] * 1e6 / res["ops"] * chase["cycles"] / chase["ns"],
           "sass_per_step": per, "dynamic_smem_bytes": smem(args, kw)}
    log(f"sass {name} per step " + json.dumps(per))
    return out


def check_kernels(inputs: dict, names) -> list[dict]:
    """Each kernel of ``names`` against its plain twin on the card, at each
    of its paths' shapes (``inputs[kernel, path]``). A kernel held at more
    than one path's shapes reports the others under ``other_paths``."""
    report = []
    for name in names:
        spec = KERNELS[name]
        first, *others = [hold_to_twin(name, p, spec, *inputs[name, p]) for p in spec.paths]
        if name == "match_candidates":
            for res in (first, *others):
                res["phase_b"] = match_phase_b(*inputs[name, res["path"]])
                log(f"match_candidates ({res['path']}) phase B " + json.dumps(res["phase_b"]))
        entry = {"name": name, "route": "cuda", "source": spec.source,
                 "replaces": spec.replaces, **first}
        if spec.replaces_note:
            entry["replaces_note"] = spec.replaces_note
        if name == "lcp_candidates":
            entry["sass_per_candidate"] = dict(LCP_COST)
            far = hold_to_twin(name, "gzip_lex", spec, *inputs[name, "far"])
            far.update(shape="prefer_far=True, the far tie (the reference's COMPU_LCP_TIE=far), "
                             "at the gzip_lex shape; no path sets it, so it launches on none",
                       launches=0)
            log(f"lcp_candidates (gzip_lex): far tie {far['ms']:.4f} ms, share "
                f"{far['share_of_bound']:.3f}, beside the nearer rule's {first['ms']:.4f} ms, "
                f"share {first['share_of_bound']:.3f}")
            entry["other_shapes"] = [far]
        if name == "match_candidates":
            entry["sass_per_candidate"] = dict(MATCH_COST)
        if name in CHAIN_KERNELS:
            entry.update(chain_report(name, first, *inputs[name, first["path"]]))
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


def gzip_lex_path(corpus: bytes):
    """The flagship path over the whole corpus; returns the measurements,
    the last stream and its index."""
    enc, fn = make_encoder("gzip_lex")
    (stream, index, times), launches = run_path("gzip_lex", lambda: timed_encodes(enc, corpus))
    if zlib.decompress(stream, wbits=31) != corpus:
        raise AssertionError("gzip stream does not decode to the corpus")
    if len(index.segment_bits) != len(corpus) // BLOCK:
        raise AssertionError("segment index missing")
    return (summary("gzip_lex", corpus, stream, times, launches, last_timings=fn.last_timings),
            stream, index)


def block_kinds(stream: bytes, index) -> collections.Counter:
    """The stream's blocks by kind, as the decoder routes them: stored
    (copied on the host), fixed and dynamic (on the card)."""
    kinds = collections.Counter()
    for b, off in enumerate(index.compressed_offsets):
        kind = inflate_dyn.parse_block_tables(stream[off:off + 4096])[0]
        stored = kind == 0 or int(index.segment_bits[b][0]) < 0
        kinds["stored" if stored else ("fixed", "dynamic")[kind - 1]] += 1
    return kinds


def corrupt_dynamic_block(stream: bytes, index) -> tuple[bytes, int]:
    """``stream`` with the middle byte of its first dynamic block flipped;
    returns it and the block's number."""
    b = next(i for i, off in enumerate(index.compressed_offsets)
             if inflate_dyn.parse_block_tables(stream[off:off + 4096])[0] == 2)
    bad = bytearray(stream)
    bad[index.compressed_offsets[b] + index.compressed_lengths[b] // 2] ^= 0xFF
    return bytes(bad), b


@contextlib.contextmanager
def first_upload():
    """While open, ``BlockParallelDecoder`` uploads as usual, and the list
    it yields gets copies of the first batch uploaded (comps, seg_bits, ns,
    lit/len and distance code lengths, on the card)."""
    kept = []
    upload = scheduler._upload

    def recording(arrays, device):
        out = upload(arrays, device)
        if not kept:
            kept.extend(t.clone() for t in out)
        return out

    scheduler._upload = recording
    try:
        yield kept
    finally:
        scheduler._upload = upload


def gzip_decode_path(corpus: bytes, stream: bytes, index):
    """The gzip_lex stream decoded on the card with its index: one warm
    decode, whose first batch is kept for the kernel report, then three
    timed; each must give the corpus, with 4 P3 launches a decode. Then a
    corrupted stream must raise and mark every block failed, the first 4
    blocks must decode to the same bytes on the CPU and the card, and P3 is
    held to its plain version on the kept batch at both of its shapes
    (:func:`p3_inputs`). Returns the measurements and P3's kernel report
    entry."""
    dec = BlockParallelDecoder(block_size=BLOCK)
    kept = []

    def decodes():
        with first_upload() as first:
            outs = [dec.decode(stream, index)]
        kept.extend(first)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(dec.decode(stream, index))
            times.append(time.perf_counter() - t0)
        return outs, times

    (outs, times), launches = run_path("gzip_decode", decodes)
    if any(out != corpus for out in outs):
        raise AssertionError("a decode of the gzip_lex stream differs from the corpus")
    batches = -(-len(index.raw_lengths) // BlockParallelDecoder.DEVICE_DECODE_BATCH)
    if launches["inflate_scan"] != batches * len(outs):
        raise AssertionError(f"{launches['inflate_scan']} P3 launches in {len(outs)} decodes of "
                             f"{batches} batches")
    if any(st.state != BlockState.Ok for st in dec.block_statuses):
        raise AssertionError("a block of the gzip_lex stream did not decode ok")
    kinds = block_kinds(stream, index)
    log(f"gzip_decode: 4 card decodes give the corpus; blocks {dict(kinds)}; "
        f"{launches['inflate_scan']} P3 launches ({batches} a decode)")

    bad, b = corrupt_dynamic_block(stream, index)
    failing = BlockParallelDecoder(block_size=BLOCK)
    try:
        failing.decode(bad, index)
    except ValueError as exc:
        error = str(exc)
    else:
        raise AssertionError(f"a stream with a byte flipped in block {b} decoded")
    if any(st.state != BlockState.Failed for st in failing.block_statuses):
        raise AssertionError("the corrupted stream's blocks are not all marked failed")
    log(f"gzip_decode: a byte flipped in dynamic block {b} raises ({error}); every block failed")

    head = BlockIndex(index.raw_lengths[:4], index.compressed_offsets[:4],
                      index.compressed_lengths[:4], index.segment_bits[:4])
    t0 = time.perf_counter()
    cpu = BlockParallelDecoder(block_size=BLOCK, device="cpu").decode(stream, head)
    t_cpu = time.perf_counter() - t0
    if cpu != corpus[:4 * BLOCK] or BlockParallelDecoder(block_size=BLOCK).decode(stream,
                                                                                  head) != cpu:
        raise AssertionError("the first 4 blocks decode to other bytes on the CPU and the card")
    log(f"gzip_decode: cpu == gpu decode of the first 4 blocks (cpu run {t_cpu:.1f} s)")
    shapes = p3_inputs(kept)
    kernel = check_kernels({("inflate_scan", "gzip_decode"): shapes["lut"]}, ["inflate_scan"])
    dyn = hold_to_twin("inflate_scan", "gzip_decode", KERNELS["inflate_scan"], *shapes["dyn"])
    chase = smem_round_trip()
    dyn.update(shape="dyn: 15-bit tables (inflate_dyn) at k 1, rsteps 128, on the same batch; "
                     "the path's streams need none, so it launches none",
               cycles_per_step=dyn["ms"] * 1e6 / dyn["ops"] * chase["cycles"] / chase["ns"],
               dynamic_smem_bytes=CHAIN_KERNELS["inflate_scan"][4](*shapes["dyn"]))
    kernel[0]["other_shapes"] = [dyn]
    sec = statistics.median(times)
    res = {"path": "gzip_decode", "bytes": len(corpus), "compressed": len(stream),
           "ratio": len(corpus) / len(stream), "median_s": sec, "runs_s": times,
           "MBps": len(corpus) / sec / 1e6, "blocks": dict(kinds),
           "p3_launches_per_decode": batches, "launches": launches, "runs_counted": len(outs)}
    log("e2e " + json.dumps(res))
    return res, kernel


def gzip_fixed_v2_path(corpus: bytes) -> tuple[dict, dict]:
    """The v2 route over the whole corpus: ``make_block_encode_fn(kernel=
    "v2", segment_index=True)`` through ``BlockParallelEncoder`` (one warm
    encode, three timed), stdlib zlib gives the corpus back; then the
    stream read back with its index by ``BlockParallelDecoder()`` (one warm
    decode, three timed; P3 on the fixed code's tables), each decode giving
    the corpus. Returns the encode's and the read-back's measurements."""
    enc, fn = make_encoder("gzip_fixed_v2")
    (stream, index, times), launches = run_path("gzip_fixed_v2",
                                                lambda: timed_encodes(enc, corpus))
    if zlib.decompress(stream, wbits=31) != corpus:
        raise AssertionError("the v2 gzip stream does not decode to the corpus")
    kinds = block_kinds(stream, index)
    if set(kinds) != {"fixed"}:
        raise AssertionError(f"the v2 stream holds other blocks than fixed ones: {dict(kinds)}")
    dec = BlockParallelDecoder(block_size=BLOCK)

    def decodes():
        outs = [dec.decode(stream, index)]
        dtimes = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(dec.decode(stream, index))
            dtimes.append(time.perf_counter() - t0)
        return outs, dtimes

    (outs, dtimes), dlaunches = run_path("gzip_fixed_v2_decode", decodes)
    if any(out != corpus for out in outs):
        raise AssertionError("a read-back of the v2 stream differs from the corpus")
    batches = -(-len(index.raw_lengths) // BlockParallelDecoder.DEVICE_DECODE_BATCH)
    if dlaunches["inflate_scan"] != batches * len(outs):
        raise AssertionError(f"{dlaunches['inflate_scan']} P3 launches in {len(outs)} "
                             f"read-backs of {batches} batches")
    dsec = statistics.median(dtimes)
    back = {"path": "gzip_fixed_v2_decode", "bytes": len(corpus), "compressed": len(stream),
            "ratio": len(corpus) / len(stream), "median_s": dsec, "runs_s": dtimes, "MBps": len(corpus) / dsec / 1e6,
            "launches": dlaunches, "runs_counted": len(outs)}
    log(f"gzip_fixed_v2: {len(index.raw_lengths)} fixed blocks; 4 read-backs give the corpus, "
        f"{dlaunches['inflate_scan']} P3 launches ({batches} a decode)")
    log("e2e " + json.dumps(back))
    return (summary("gzip_fixed_v2", corpus, stream, times, launches, depth=V2_DEPTH,
                    read_back_MBps=back["MBps"], last_timings=fn.last_timings), back)


@contextlib.contextmanager
def nccl_world():
    """A process group of one rank on this card (NCCL, nothing else), left
    on exit."""
    pmesh.init_world(rank=0, world_size=1, init_method=f"tcp://127.0.0.1:{free_port()}")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def mesh_encode_once(step, blocks: np.ndarray, lens: np.ndarray):
    """One sharded encode step of the blocks, the stream (each block's
    bytes, then a final empty stored block) assembled on the host."""
    outs, out_lens, adlers, total = step(torch.from_numpy(blocks), torch.from_numpy(lens))
    out_lens = out_lens.cpu().numpy()
    flat = outs.cpu().numpy()
    stream = b"".join(flat[i, :out_lens[i]].tobytes() for i in range(len(lens))) + TERM
    return stream, out_lens, adlers.cpu().numpy().view(np.uint32), int(total)


def _host_huf_streams(freqs: np.ndarray, chunks: list) -> list:
    """The host writer's streams (``HufEncoder.encode_stream``), for a
    worker process."""
    enc = HufEncoder(freqs)
    return [enc.encode_stream(c) for c in chunks]


def literal_inputs(corpus: bytes):
    """The literal step's inputs: 4 streams of each 128 KiB frame block
    (``LIT_BLOCK``), padded into one (L, P) matrix, and the table from the
    corpus's byte counts (each count plus 1)."""
    freqs = np.bincount(np.frombuffer(corpus, np.uint8), minlength=256) + 1
    per = LIT_BLOCK // 4
    chunks = [corpus[i:i + per] for i in range(0, len(corpus), per)]
    mat = np.zeros((len(chunks), per), np.uint8)
    counts = np.array([len(c) for c in chunks], np.int32)
    for i, c in enumerate(chunks):
        mat[i, :len(c)] = np.frombuffer(c, np.uint8)
    return freqs, chunks, mat, counts, per + per // 2 + 64


def mesh_encode_path(corpus: bytes, blocks: np.ndarray, lens: np.ndarray) -> dict:
    """``parallel/mesh.py`` on an NCCL world of one rank on the card, and
    then ``dryrun_multichip(1)``: (i) the sharded encode step over the 64
    blocks (one warm step, three timed, each with its fetch and the host's
    stream assembly): the total equals the sum of the gathered lengths,
    the stream decodes through stdlib zlib and through
    ``decoder.Interface.zlib_device`` on the card, and the gathered adlers
    combine to the corpus's adler32; (ii) the stream-sharded literal step
    over the corpus's 128 frame blocks x 4 streams, each stream equal to
    the host writer's (``HufEncoder.encode_stream``, run in worker
    processes meanwhile); (iii) the lane-sharded crc32 on a (1, 1) ("dp",
    "lane") mesh, each block's registers folding to its zlib.crc32."""
    def run():
        with nccl_world():
            mesh = pmesh.default_mesh()
            step = pmesh.make_sharded_encode_step(mesh)
            mesh_encode_once(step, blocks, lens)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stream, out_lens, adlers, total = mesh_encode_once(step, blocks, lens)
                times.append(time.perf_counter() - t0)
            if total != int(out_lens.astype(np.int64).sum()):
                raise AssertionError(f"(i) total {total} != the sum of the gathered lengths")
            if zlib.decompress(stream, wbits=-15) != corpus:
                raise AssertionError("(i) stdlib zlib does not decode the mesh stream")
            t0 = time.perf_counter()
            out = bytearray(len(corpus) + 16)
            res = decoder.Interface.zlib_device(ZlibMode.Deflate).decode(stream, out)
            t_dec = time.perf_counter() - t0
            if res.status is not DecodeStatus.Finished or bytes(out[:len(corpus)]) != corpus:
                raise AssertionError(f"(i) zlib_device does not decode the mesh stream "
                                     f"({res.status})")
            combined = 1
            for i in range(len(lens)):
                combined = checksum.adler32_combine(combined, int(adlers[i]), int(lens[i]))
            if combined != zlib.adler32(corpus):
                raise AssertionError("(i) the gathered adlers do not combine to the corpus's")
            log(f"mesh_encode (i): {len(lens)} blocks, {total} bytes; zlib and zlib_device "
                f"({t_dec:.2f} s) give the corpus; the adlers combine to zlib.adler32")

            freqs, chunks, mat, counts, cap = literal_inputs(corpus)
            ctx = multiprocessing.get_context("spawn")
            with concurrent.futures.ProcessPoolExecutor(6, mp_context=ctx) as pool:
                host = [pool.submit(_host_huf_streams, freqs, chunks[i:i + 4])
                        for i in range(0, len(chunks), 4)]
                enc = HufEncoder(freqs)
                code = np.zeros(256, np.int64)
                nbits = np.zeros(256, np.int64)
                code[:enc.max_symbol + 1] = enc.code
                nbits[:enc.max_symbol + 1] = enc.nbits
                lit_step = pmesh.make_stream_sharded_literal_step(mesh, cap=cap)
                got, nb = (x.cpu().numpy() for x in lit_step(mat, counts, code, nbits))
                want = [b for f in host for b in f.result()]
            if any(got[i, :nb[i]].tobytes() != w for i, w in enumerate(want)):
                raise AssertionError("(ii) a literal stream differs from the host writer's")
            log(f"mesh_encode (ii): {len(want)} literal streams ({len(want) // 4} blocks x 4) "
                "equal the host writer's")

            mesh2 = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dp", "lane"))
            crc_step = pmesh.make_lane_sharded_crc(mesh2)
            N = blocks.shape[1]
            for i in range(len(lens)):
                regs = crc_step(torch.from_numpy(blocks[i:i + 1]))[0].cpu().numpy()
                reg = checksum.fold_lane_registers(regs, N // len(regs))
                crc = checksum.crc_unshift(reg, N - int(lens[i])) ^ 0xFFFFFFFF
                if crc != zlib.crc32(blocks[i, :lens[i]].tobytes()):
                    raise AssertionError(f"(iii) block {i}: the lane-sharded crc32 differs")
            log(f"mesh_encode (iii): {len(lens)} blocks' lane-sharded registers fold to "
                "zlib.crc32")
        dryrun_multichip(1)
        return stream, times

    (stream, times), launches = run_path("mesh_encode", run)
    # Five encode steps launch the path's kernels: the warm one, the three
    # timed, and the dry run's.
    return summary("mesh_encode", corpus, stream, times, launches, world=1, backend="nccl",
                   runs_counted=5)


# The gzip decode's stages, by the module whose globals the decode looks
# them up in: the host's header parse, the upload, the table build, P3,
# the expansion, the doubling rounds, the fetches, the stored copies.
DECODE_STAGES = (
    (inflate_dyn, "parse_block_tables"), (scheduler, "_upload"),
    (inflate_lut, "_lit_lut_block"), (inflate_lut, "_dist_lut_block"),
    (inflate_mod, "inflate_scan"), (inflate_mod, "_expand"), (inflate_mod, "_resolve"),
    (scheduler, "_fetch"), (scheduler, "_stored_copy"),
)


def gzip_decode_stage_ms(stream: bytes, index) -> dict:
    """One gzip_decode with each stage synchronised before and after: ms
    per stage, the rest of the decode, and the doubling rounds' count
    (whole-map and compacted)."""
    times = dict.fromkeys((name for _, name in DECODE_STAGES), 0.0)
    rounds = collections.Counter()

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    def counted(name, fn):
        def wrapper(*args, **kw):
            rounds[name] += 1
            return fn(*args, **kw)
        return wrapper

    saved = [(mod, name, getattr(mod, name)) for mod, name in DECODE_STAGES]
    saved += [(inflate_mod, name, getattr(inflate_mod, name)) for name in ("_double", "_double_sub")]
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn) if name.startswith("_double") else timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        BlockParallelDecoder(block_size=BLOCK).decode(stream, index)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    times["rest"] = total - sum(times.values())
    times["total"] = total
    times["doubling_rounds"] = dict(rounds)
    return times


def gzip_stream(data: bytes) -> bytes:
    """``data`` as stdlib zlib writes a level-6 gzip stream: no index."""
    co = zlib.compressobj(6, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def foreign_decode(stream: bytes, size: int, device=None):
    """One-shot ``decoder.Interface.zlib_device(ZlibMode.Auto)`` decode of
    ``stream`` into a buffer of ``size`` + 16 bytes; returns (the Decode
    result, the bytes it wrote)."""
    out = bytearray(size + 16)
    res = decoder.Interface.zlib_device(ZlibMode.Auto, device=device).decode(stream, out)
    return res, bytes(out[:len(out) - res.output_remain])


@contextlib.contextmanager
def recorded_waves():
    """While open, the foreign decode runs as usual, and the dict it yields
    gets its block headers (``blocks``: (bit, kind, body bit) each; ``lens``:
    their code lengths), its wave count, the first wave of the first dynamic
    block and the last wave (``first``, ``last``: (args, kw) of P4's call,
    copies; ``first_lens``, ``last_lens``: their blocks' code lengths)."""
    kept = {"blocks": [], "lens": [], "waves": 0}
    parse, scan = device_inflate.parse_block_header_at, device_inflate.spec_scan_wave

    def parsing(data, bit):
        out = parse(data, bit)
        kept["blocks"].append((bit, out[0], out[3]))
        kept["lens"].append((out[1], out[2]))
        return out

    def scanning(comp, tables, wave_bit0, total_bits):
        kept["waves"] += 1
        call = ((comp, tables.clone()), dict(wave_bit0=wave_bit0, total_bits=total_bits))
        kind, body_bit = kept["blocks"][-1][1:]
        if "first" not in kept and kind == 2 and wave_bit0 == body_bit:
            kept["first"], kept["first_lens"] = call, kept["lens"][-1]
        kept["last"], kept["last_lens"] = call, kept["lens"][-1]
        return scan(comp, tables, wave_bit0, total_bits)

    device_inflate.parse_block_header_at = parsing
    device_inflate.spec_scan_wave = scanning
    try:
        yield kept
    finally:
        device_inflate.parse_block_header_at = parse
        device_inflate.spec_scan_wave = scan


@contextlib.contextmanager
def counted_rounds():
    """While open, the dict it yields counts the resolve's doubling rounds."""
    rounds = {"rounds": 0}
    double = inflate_spec._double

    def counting(root):
        rounds["rounds"] += 1
        return double(root)

    inflate_spec._double = counting
    try:
        yield rounds
    finally:
        inflate_spec._double = double


def gzip_foreign_decode_path(corpus: bytes):
    """The corpus's stdlib gzip stream decoded on the card through
    ``zlib_device``: one warm decode, whose waves are recorded, then three
    timed; each must give the corpus with status Finished. Then the stream
    with a byte flipped inside its first dynamic block must not finish, the
    stream cut in half must return NeedInput, the first 1 MiB's own stream
    must decode to the same bytes on the CPU and the card, and P4 is held
    to its plain version on the first wave of the first dynamic block and on
    the stream's last wave. Returns the measurements and P4's kernel report
    entry."""
    stream = gzip_stream(corpus)
    log(f"gzip_foreign_decode: stdlib gzip level 6 of the corpus, {len(stream)} bytes")
    dev = torch.device("cuda")

    def decodes():
        with recorded_waves() as kept, counted_rounds() as rounds:
            runs = [foreign_decode(stream, len(corpus))]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(foreign_decode(stream, len(corpus)))
            times.append(time.perf_counter() - t0)
        return runs, times, kept, rounds["rounds"]

    (runs, times, kept, rounds), launches = run_path("gzip_foreign_decode", decodes)
    for res, out in runs:
        if (res.status is not DecodeStatus.Finished or res.input_remain or out != corpus):
            raise AssertionError(f"a foreign decode of the corpus's gzip stream failed: {res}")
    kinds = collections.Counter(("stored", "fixed", "dynamic")[k] for _, k, _ in kept["blocks"])
    if launches["inflate_spec"] != kept["waves"] * len(runs):
        raise AssertionError(f"{launches['inflate_spec']} P4 launches in {len(runs)} decodes "
                             f"of {kept['waves']} waves")
    log(f"gzip_foreign_decode: 4 card decodes give the corpus; blocks {dict(kinds)}; "
        f"{kept['waves']} P4 launches a decode; {rounds} doubling rounds")

    bits = [b for b, _, _ in kept["blocks"]]
    i = next(i for i, (_, kind, _) in enumerate(kept["blocks"]) if kind == 2)
    flip = (kept["blocks"][i][2] + bits[i + 1]) // 16
    bad = bytearray(stream)
    bad[flip] ^= 0xFF
    res, _ = foreign_decode(bytes(bad), len(corpus))
    if res.status is DecodeStatus.Finished:
        raise AssertionError(f"a byte flipped at {flip}, in dynamic block {i}, still finished")
    log(f"gzip_foreign_decode: a byte flipped at {flip} (dynamic block {i}) gives {res.status}")
    res, _ = foreign_decode(stream[:len(stream) // 2], len(corpus))
    if res.status is not DecodeStatus.NeedInput or res.input_remain:
        raise AssertionError(f"the stream cut in half gave {res}, not NeedInput")
    head = corpus[:1 << 20]
    head_stream = gzip_stream(head)
    t0 = time.perf_counter()
    cpu = foreign_decode(head_stream, len(head), "cpu")
    t_cpu = time.perf_counter() - t0
    if cpu[1] != head or foreign_decode(head_stream, len(head), dev) != cpu:
        raise AssertionError("the first 1 MiB's gzip stream decodes to other bytes on the CPU "
                             "and the card")
    log(f"gzip_foreign_decode: cpu == gpu decode of the first 1 MiB's stream "
        f"(cpu run {t_cpu:.1f} s)")
    kernel = check_kernels({("inflate_spec", "gzip_foreign_decode"): kept["first"]},
                           ["inflate_spec"])
    last = hold_to_twin("inflate_spec", "gzip_foreign_decode", KERNELS["inflate_spec"],
                        *kept["last"])
    chase = smem_round_trip()
    for entry in (kernel[0], last):
        entry["cycles_per_step"] = entry["ms"] * 1e6 / entry["ops"] * chase["cycles"] / chase["ns"]
    kernel[0]["shape"] = "the first wave of the first dynamic block"
    last["shape"] = "the stream's last wave: lanes past the stream's end start retired"
    kernel[0]["other_shapes"] = [last]
    sec = statistics.median(times)
    res = {"path": "gzip_foreign_decode", "bytes": len(corpus), "compressed": len(stream),
           "ratio": len(corpus) / len(stream), "median_s": sec, "runs_s": times,
           "MBps": len(corpus) / sec / 1e6, "blocks": dict(kinds),
           "p4_launches_per_decode": kept["waves"], "doubling_rounds": rounds,
           "cpu_head_decode_s": t_cpu, "launches": launches, "runs_counted": len(runs)}
    log("e2e " + json.dumps(res))
    return res, kernel


# The foreign decode's stages, by their names in device_inflate: the host's
# header parse, the table build (in numpy, with its upload), the wave
# launches, the host walk, the fetches, the resolve, the trailer check.
FOREIGN_STAGES = ("parse_block_header_at", "build_foreign_tables", "spec_scan_wave",
                  "_walk_wave", "_fetch", "resolve_foreign", "_check_trailer")


def foreign_decode_stage_ms(stream: bytes, size: int) -> dict:
    """One gzip_foreign_decode with each stage synchronised before and
    after: ms per stage, the rest of the decode, and the doubling rounds."""
    times = dict.fromkeys(FOREIGN_STAGES, 0.0)
    saved = {name: getattr(device_inflate, name) for name in FOREIGN_STAGES}

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    for name, fn in saved.items():
        setattr(device_inflate, name, timed(name, fn))
    try:
        with counted_rounds() as rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = foreign_decode(stream, size)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
    finally:
        for name, fn in saved.items():
            setattr(device_inflate, name, fn)
    if res.status is not DecodeStatus.Finished:
        raise AssertionError(f"the profiled foreign decode did not finish: {res}")
    times["rest"] = total - sum(times.values())
    times["total"] = total
    times["doubling_rounds"] = rounds["rounds"]
    return times


def make_encoder(path: str):
    """The ``BlockParallelEncoder`` of an encode path, and its step."""
    if path in ("gzip_lex", "gzip_fixed_v2"):
        fn = make_block_encode_fn(ZlibMode.Gzip, level=LEVEL, segment_index=True,
                                  pipeline_groups=GROUPS,
                                  kernel="v2" if path == "gzip_fixed_v2" else "v3")
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
    """adler32_device of the (64, N) block batch, one launch and one fetch:
    each block's value equal to zlib.adler32 and to the zlib_hash path's
    metas[:, 1] (the plain ``_block_checksum``)."""
    dev = torch.from_numpy(blocks).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, launches = run_path("adler_device", lambda: adler32_device(dev, lens))
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


def cpu_equals_device(blocks: np.ndarray, lens: np.ndarray, label: str,
                      encode=encode_blocks_dyn, **kw) -> None:
    """The port's ``encode`` on CPU tensors (the twins) and on the card give
    equal bytes."""
    t0 = time.perf_counter()
    cpu = [x.numpy() for x in encode(torch.from_numpy(blocks), torch.from_numpy(lens), **kw)]
    t_cpu = time.perf_counter() - t0
    dev = [x.cpu().numpy() for x in encode(
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


def zstd_frame(data: bytes, device, tokenizer_hook=None, **flags) -> bytes:
    """One zstd frame of ``data`` through ``Interface.zstd`` on ``device``
    (``ZSTD_OPTS`` with ``flags`` over them). ``tokenizer_hook(tokenizer)``
    may replace the encoder's tokenizer by a wrapper (harness only)."""
    enc = Interface.zstd(ZstdOptions(**{**ZSTD_OPTS, **flags}), device=device)
    if tokenizer_hook is not None:
        stream = enc._backend._stream
        stream.tokenizer = tokenizer_hook(stream.tokenizer)
    vec = ByteVec()
    enc.encode_vec_full(data, vec, EncodeOp.Finish)
    return vec.data()


def record_scan_inputs(data: bytes):
    """Encode ``data`` on the card and keep P1's arguments from its
    largest sequences section: the (args, kw) the main path gives P1."""
    kept = {}
    scan = zstd_seq.fse_seq_scan

    def recording(*args):
        if args[-1] > kept.get("nseq", 0):
            kept.update(nseq=args[-1], args=tuple(a.clone() for a in args[:-1]))
        return scan(*args)

    zstd_seq.fse_seq_scan = recording
    try:
        zstd_frame(data, torch.device("cuda"))
    finally:
        zstd_seq.fse_seq_scan = scan
    log(f"fse_seq_scan inputs: the largest of the first MiB's sections, {kept['nseq']} sequences")
    return kept["args"], {"nseq": kept["nseq"]}


def check_token_cover(data: bytes, tokens, max_dist: int) -> tuple[int, int]:
    """Check (ii) for one tokenizer call, vectorised: the tokens tile
    [0, n) in position order, and every match (3..258 bytes, distance in
    1..min(pos, max_dist)) copies bytes equal to those at its distance.
    Returns (tokens, matches)."""
    pos, ln, dist = (np.asarray(t, np.int64) for t in tokens)
    arr = np.frombuffer(data, np.uint8)
    span = np.where(ln > 0, ln, 1)
    if not (len(pos) and pos[0] == 0 and np.array_equal(pos[1:], (pos + span)[:-1])
            and pos[-1] + span[-1] == len(arr)):
        raise AssertionError("the tokens do not tile the tokenizer call's bytes")
    m = ln > 0
    mp, ml, md = pos[m], ln[m], dist[m]
    if not ((ml >= 3).all() and (ml <= 258).all() and (md >= 1).all()
            and (md <= mp).all() and (md <= max_dist).all()):
        raise AssertionError("a match's length or distance is out of range")
    at = np.repeat(mp, ml) + np.arange(int(ml.sum())) - np.repeat(np.cumsum(ml) - ml, ml)
    if not np.array_equal(arr[at], arr[at - np.repeat(md, ml)]):
        raise AssertionError("a match's bytes differ from the bytes at its distance")
    return len(pos), int(m.sum())


def walk_frame(frame: bytes, data: bytes) -> int:
    """The frame's structure: magic, header, blocks of at most 128 KiB up
    to the one marked last, then the xxh64 checksum of ``data``. Returns
    the block count."""
    if frame[:4] != (0xFD2FB528).to_bytes(4, "little") or frame[4] != 0x04:
        raise AssertionError("bad zstd frame header")
    at, blocks = 6, 0
    while True:
        h = int.from_bytes(frame[at:at + 3], "little")
        last, btype, size = h & 1, (h >> 1) & 3, h >> 3
        at += 3 + (1 if btype == 1 else size)
        blocks += 1
        if btype == 3 or size > ZSTD_BLOCK:
            raise AssertionError(f"bad block header at {at}")
        if last:
            break
    if frame[at:] != (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little"):
        raise AssertionError("zstd frame checksum differs from xxh64 of the input")
    return blocks


def zstd_device_path(corpus: bytes):
    """The device zstd encode of the corpus: one warm encode, whose
    tokenizer calls are kept for check (ii), then three timed; then checks
    (i) and (iii) and the frame's structure. Returns the measurements, the
    frame and the CPU's frame of the first 2 MiB."""
    dev = torch.device("cuda")
    calls = []

    def keep_calls(tokenizer):
        def call(data):
            out = tokenizer(data)
            calls.append((data, out))
            return out
        return call

    def encodes():
        warm = zstd_frame(corpus, dev, tokenizer_hook=keep_calls)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame = zstd_frame(corpus, dev)
            times.append(time.perf_counter() - t0)
        return warm, frame, times

    (warm, frame, times), launches = run_path("zstd_device", encodes)
    if warm != frame:
        raise AssertionError("two encodes of the corpus gave different frames")
    max_dist = ZSTD_LCP["max_dist"]
    counts = [check_token_cover(d, t, max_dist) for d, t in calls]
    if sum(len(d) for d, _ in calls) != len(corpus):
        raise AssertionError("the tokenizer calls do not cover the corpus")
    log(f"zstd_device (ii): {len(calls)} tokenizer calls tile their bytes, "
        f"{sum(c[1] for c in counts)} matches of {sum(c[0] for c in counts)} tokens "
        "copy equal bytes")
    t0 = time.perf_counter()
    host = zstd_frame(corpus, dev, device_literals=False, device_sequences=False)
    if host != frame:
        raise AssertionError("(i) the device entropy stages' frame differs from the host writers'")
    log(f"zstd_device (i): frame equals the host writers' frame ({time.perf_counter() - t0:.1f} s)")
    head = corpus[:ZSTD_CPU_BYTES]
    t0 = time.perf_counter()
    cpu = zstd_frame(head, "cpu")
    t_cpu = time.perf_counter() - t0
    if cpu != zstd_frame(head, dev):
        raise AssertionError("(iii) the CPU's frame of the first 2 MiB differs from the card's")
    log(f"zstd_device (iii): cpu == gpu frame of the first {len(head)} bytes (cpu run {t_cpu:.1f} s)")
    blocks = walk_frame(frame, corpus)
    if blocks != -(-len(corpus) // ZSTD_BLOCK):
        raise AssertionError(f"{blocks} frame blocks for {len(corpus)} bytes")
    if len(frame) != ZSTD_BYTES:
        raise AssertionError(f"(iv) the frame is {len(frame)} bytes, not {ZSTD_BYTES}")
    log(f"zstd_device (iv): the frame is {len(frame)} bytes, as with the Python host stages")
    sec = statistics.median(times)
    res = {"path": "zstd_device", "bytes": len(corpus), "frame_blocks": blocks,
           "tokenizer_calls": len(calls), "compressed": len(frame),
           "ratio": len(corpus) / len(frame), "median_s": sec, "runs_s": times,
           "MBps": len(corpus) / sec / 1e6, "launches": launches, "runs_counted": 4}
    log("e2e " + json.dumps(res))
    return res, frame, cpu


def zstd_decode(frame: bytes, device, device_literals: bool = True) -> bytes:
    """One frame through ``decoder.Interface.zstd`` on ``device``; raises
    unless the decode finishes with the whole frame consumed."""
    dec = decoder.Interface.zstd(ZstdDecodeOptions(device_literals=device_literals),
                                 device=device)
    vec = ByteVec()
    res = dec.decode_vec_full(frame, vec)
    if res.is_error or res.status is not DecodeStatus.Finished or res.input_remain:
        raise AssertionError(f"zstd decode did not finish: {res}")
    return vec.data()


def record_lane_inputs(fn):
    """Run ``fn()`` with P2's calls recorded; returns its result and what
    was kept: the calls (``sections``), the steps of their longest lanes
    (``steps``), and the arguments of the call with the most steps (the
    largest literal section: ``args``, ``max_steps``)."""
    kept = {"sections": 0, "steps": 0}
    lanes = zstd_lit_decode.huf_decode_lanes

    def recording(*args):
        kept["sections"] += 1
        kept["steps"] += args[-1]
        if args[-1] > kept.get("max_steps", 0):
            kept.update(max_steps=args[-1], args=tuple(a.clone() for a in args[:-1]))
        return lanes(*args)

    zstd_lit_decode.huf_decode_lanes = recording
    try:
        return fn(), kept
    finally:
        zstd_lit_decode.huf_decode_lanes = lanes


def zstd_decode_path(corpus: bytes, frame: bytes, head_frame: bytes):
    """The zstd_device frame decoded on the card once, timed (P2 is built
    before; the decode keeps its largest literal section's P2 arguments for
    the kernel report); it must give the corpus. One run, not three
    (``ZSTD_DECODE_CUT``): the host's sequence execution takes 60-90 s a
    decode, and three of them took a third of the run. Then the
    first 2 MiB's CPU frame decodes on the CPU (P2's plain version) to the
    bytes the card gives, P2 is held to its twin on the kept section, and
    last the host literal route gives the corpus, so that nothing else runs
    on the host while a time is taken. Returns the measurements and P2's
    kernel report entry."""
    dev = torch.device("cuda")

    def timed_decode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = zstd_decode(frame, dev)
        return out, time.perf_counter() - t0

    def decodes():
        first, kept = record_lane_inputs(timed_decode)
        return [first], kept

    (runs, kept), launches = run_path("zstd_decode", decodes)
    if any(out != corpus for out, _ in runs):
        raise AssertionError("a decode of the zstd_device frame differs from the corpus")
    times = [t for _, t in runs]
    log(f"huf_decode_lanes inputs: the frame's largest literal section, "
        f"{kept['max_steps']} steps a lane, scap {kept['args'][0].shape[1]}; the frame's "
        f"{kept['sections']} sections take {kept['steps']} steps of their longest lanes")
    head = corpus[:ZSTD_CPU_BYTES]
    t0 = time.perf_counter()
    cpu = zstd_decode(head_frame, "cpu")
    t_cpu = time.perf_counter() - t0
    if cpu != head or zstd_decode(head_frame, dev) != cpu:
        raise AssertionError("the first 2 MiB's frame decodes to other bytes on the CPU "
                             "and the card")
    kernel = check_kernels({("huf_decode_lanes", "zstd_decode"): (
        kept["args"], {"max_steps": kept["max_steps"]})}, ["huf_decode_lanes"])
    t0 = time.perf_counter()
    if zstd_decode(frame, "cpu", device_literals=False) != corpus:
        raise AssertionError("the host literal route's decode differs from the corpus")
    t_host = time.perf_counter() - t0
    log(f"zstd_decode: the card's decode gives the corpus; the host literal route too "
        f"({t_host:.1f} s); cpu == gpu decode of the first {len(head)} bytes "
        f"(cpu run {t_cpu:.1f} s)")
    sec = statistics.median(times)
    res = {"path": "zstd_decode", "bytes": len(corpus), "compressed": len(frame),
           "ratio": len(corpus) / len(frame), "median_s": sec, "runs_s": times,
           "MBps": len(corpus) / sec / 1e6, "host_literals_s": t_host,
           "p2_sections": kept["sections"], "p2_longest_lane_steps": kept["steps"],
           "launches": launches, "runs_counted": 1, "cut": ZSTD_DECODE_CUT}
    log("e2e " + json.dumps(res))
    return res, kernel


def zstd_decode_stage_ms(frame: bytes) -> dict:
    """One zstd_decode with each stage synchronised before and after: ms in
    the literal sections (P2 inside), the sequence execution, xxh64, and the
    rest of the decode."""
    times = {"_decode_literals": 0.0, "_execute_sequences": 0.0, "xxh64": 0.0}
    cls = zstd_decode_mod.ZstdFrameDecoder
    saved = {"_decode_literals": cls._decode_literals,
             "_execute_sequences": cls._execute_sequences, "xxh64": zstd_decode_mod.xxh64}

    def timed(name):
        fn = saved[name]

        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    cls._decode_literals = timed("_decode_literals")
    cls._execute_sequences = timed("_execute_sequences")
    zstd_decode_mod.xxh64 = timed("xxh64")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zstd_decode(frame, torch.device("cuda"))
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        cls._decode_literals = saved["_decode_literals"]
        cls._execute_sequences = saved["_execute_sequences"]
        zstd_decode_mod.xxh64 = saved["xxh64"]
    times["rest"] = total - sum(times.values())
    times["total"] = total
    return times


def zstd_stage_ms(corpus: bytes) -> dict:
    """One zstd_device encode with each stage synchronised before and
    after: ms in the tokenizer calls, the sequences from the tokens, the
    literal sections, the sequence sections (device stages inside), xxh64,
    and the rest of the encode."""
    times = {"tokenizer": 0.0, "_sequences_from_tokens": 0.0, "_literals_section": 0.0,
             "_sequences_section": 0.0, "xxh64": 0.0}

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    names = ("_sequences_from_tokens", "_literals_section", "_sequences_section", "xxh64")
    saved = {n: getattr(zstd_encode_mod, n) for n in names}
    for n in names:
        setattr(zstd_encode_mod, n, timed(n, saved[n]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zstd_frame(corpus, torch.device("cuda"),
                   tokenizer_hook=lambda tok: timed("tokenizer", tok))
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for n in names:
            setattr(zstd_encode_mod, n, saved[n])
    times["rest"] = total - sum(times.values())
    times["total"] = total
    return times


def brotli_stream(data: bytes, device) -> bytes:
    """One brotli stream of ``data`` through ``Interface.brotli()`` (quality
    9, window 22, Generic, ``device_lz``) on ``device``."""
    vec = ByteVec()
    res = Interface.brotli(BrotliOptions(device_lz=True), device=device).encode_vec_full(
        data, vec, EncodeOp.Finish)
    if res.status.name != "Finished":
        raise AssertionError(f"brotli encode did not finish: {res}")
    return vec.data()


@contextlib.contextmanager
def brotli_tokenizers(call):
    """While open, the brotli encoder makes its tokenizers from a subclass
    whose calls go through ``call(tokenizer, data)`` (harness only)."""
    made = brotli_encode_mod.DeviceTokenizer

    class Wrapped(made):
        def __call__(self, data):
            return call(super().__call__, self, data)

    brotli_encode_mod.DeviceTokenizer = Wrapped
    try:
        yield
    finally:
        brotli_encode_mod.DeviceTokenizer = made


def brotli_decode(stream: bytes) -> bytes:
    """One stream through the port's ``decoder.Interface.brotli()`` (host
    code); raises unless it finishes with the whole stream consumed."""
    vec = ByteVec()
    res = decoder.Interface.brotli().decode_vec_full(stream, vec)
    if res.is_error or res.status is not DecodeStatus.Finished or res.input_remain:
        raise AssertionError(f"brotli decode did not finish: {res}")
    return vec.data()


def libbrotlidec():
    """The system's libbrotli decoder through ctypes, or None where the
    machine has none: it is an independent check of the stream, not a
    part of the port."""
    for name in ("libbrotlidec.so.1", "libbrotlidec.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.BrotliDecoderDecompress.restype = ctypes.c_int
        lib.BrotliDecoderDecompress.argtypes = [
            ctypes.c_size_t, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
        return lib
    return None


def libbrotli_decompress(lib, stream: bytes, size: int) -> bytes:
    out_size = ctypes.c_size_t(size + 64)
    out = ctypes.create_string_buffer(out_size.value)
    if lib.BrotliDecoderDecompress(len(stream), stream, ctypes.byref(out_size), out) != 1:
        raise AssertionError("libbrotlidec refuses the stream")
    return out.raw[:out_size.value]


def brotli_window_case() -> bytes:
    """65,536 bytes of noise with b"QWERTY" at 0 and at 65,530: a one-shot
    input written with WBITS=16, whose window (65,520) the repeat lies
    past."""
    data = bytearray(np.random.default_rng(5).integers(0, 256, 65_536, dtype=np.uint8).tobytes())
    data[0:6] = data[65_530:65_536] = b"QWERTY"
    return bytes(data)


def brotli_device_path(corpus: bytes) -> dict:
    """The brotli encode of the corpus on the card: one warm encode, whose
    tokenizer calls are kept for check (i), then three timed; then (ii)
    the stream is the reference's (length and sha256), (iii) the CPU's
    stream of the first 2 MiB equals the card's, (iv) the port's decoder
    gives the corpus back (one decode, timed), (v) so does the system's
    libbrotlidec where it loads, and (vi) the WBITS=16 case decodes."""
    dev = torch.device("cuda")
    calls = []

    def keep(tokenize, tokenizer, data):
        out = tokenize(data)
        calls.append((data, out, tokenizer.max_dist))
        return out

    def encodes():
        with brotli_tokenizers(keep):
            warm = brotli_stream(corpus, dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream = brotli_stream(corpus, dev)
            times.append(time.perf_counter() - t0)
        return warm, stream, times

    (warm, stream, times), launches = run_path("brotli_device", encodes)
    if warm != stream:
        raise AssertionError("two encodes of the corpus gave different brotli streams")
    if {m for _, _, m in calls} != {BROTLI_LCP["max_dist"]}:
        raise AssertionError(f"tokenizers of max_dist {sorted({m for _, _, m in calls})}")
    counts = [check_token_cover(d, t, m) for d, t, m in calls]
    if sum(len(d) for d, _, _ in calls) != len(corpus):
        raise AssertionError("the tokenizer calls do not cover the corpus")
    log(f"brotli_device (i): {len(calls)} tokenizer calls tile their bytes, "
        f"{sum(c[1] for c in counts)} matches of {sum(c[0] for c in counts)} tokens "
        "copy equal bytes")
    sha = hashlib.sha256(stream).hexdigest()
    if (len(stream), sha) != (BROTLI_BYTES, BROTLI_SHA256):
        raise AssertionError(f"(ii) the stream ({len(stream)} bytes, sha256 {sha}) is not the "
                             f"reference's ({BROTLI_BYTES} bytes, sha256 {BROTLI_SHA256})")
    log(f"brotli_device (ii): the stream is the reference's, {len(stream)} bytes, sha256 {sha}")
    head = corpus[:BROTLI_CPU_BYTES]
    t0 = time.perf_counter()
    cpu = brotli_stream(head, "cpu")
    t_cpu = time.perf_counter() - t0
    if cpu != brotli_stream(head, dev):
        raise AssertionError("(iii) the CPU's stream of the first 2 MiB differs from the card's")
    log(f"brotli_device (iii): cpu == gpu stream of the first {len(head)} bytes "
        f"(cpu run {t_cpu:.1f} s)")
    t0 = time.perf_counter()
    back = brotli_decode(stream)
    t_dec = time.perf_counter() - t0
    if back != corpus:
        raise AssertionError("(iv) the port's decoder does not give the corpus back")
    log(f"brotli_device (iv): the port's decoder gives the corpus back ({t_dec:.3f} s)")
    lib = libbrotlidec()
    log(f"brotli_device (v): libbrotlidec {'found' if lib else 'not found'} on this machine")
    if lib and libbrotli_decompress(lib, stream, len(corpus)) != corpus:
        raise AssertionError("(v) libbrotlidec decodes the stream to other bytes")
    small = brotli_window_case()
    blob = brotli_stream(small, dev)
    if blob[0] & 1 or brotli_decode(blob) != small or (
            lib and libbrotli_decompress(lib, blob, len(small)) != small):
        raise AssertionError("(vi) the WBITS=16 stream does not decode to its input")
    log(f"brotli_device (vi): the one-shot 65,536-byte input is written with WBITS=16 and "
        f"decodes{' (libbrotlidec too)' if lib else ''}")
    sec = statistics.median(times)
    res = {"path": "brotli_device", "bytes": len(corpus), "tokenizer_calls": len(calls),
           "compressed": len(stream), "ratio": len(corpus) / len(stream), "sha256": sha,
           "median_s": sec, "runs_s": times, "MBps": len(corpus) / sec / 1e6,
           "decode_s": t_dec, "decode_MBps": len(corpus) / t_dec / 1e6,
           "libbrotlidec": bool(lib), "launches": launches, "runs_counted": 4}
    log("e2e " + json.dumps(res))
    return res


# The brotli encode's host stages, by name in formats/brotli/encode.py.
BROTLI_STAGES = ("_commands_from_tokens", "_plan_commands", "_context_model",
                 "_write_meta_block_header", "_emit_body")


def brotli_stage_ms(corpus: bytes) -> dict:
    """One brotli_device encode with each stage synchronised before and
    after: ms in the tokenizer calls, the commands, the distance plan with
    the histograms, the context model, the prefix codes' descriptions with
    the meta-block header, the body's emission, and the rest."""
    times = dict.fromkeys(("tokenizer", *BROTLI_STAGES), 0.0)

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = {n: getattr(brotli_encode_mod, n) for n in BROTLI_STAGES}
    for n in BROTLI_STAGES:
        setattr(brotli_encode_mod, n, timed(n, saved[n]))
    try:
        with brotli_tokenizers(lambda tokenize, _, data: timed("tokenizer", tokenize)(data)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            brotli_stream(corpus, torch.device("cuda"))
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
    finally:
        for n in BROTLI_STAGES:
            setattr(brotli_encode_mod, n, saved[n])
    times["rest"] = total - sum(times.values())
    times["total"] = total
    return times


# The encode's stages, by the module whose globals the encode looks them up in.
STAGES = (
    (deflate_v2, "sort_stage_lex"), (deflate_v2, "_sort_stage"),
    (deflate_v2, "lcp_candidates"), (deflate_v2, "match_candidates"),
    (deflate_v2, "_post_match"), (deflate_v2, "parse_cover"),
    (deflate_v2, "_merge_seg_boundaries"), (deflate_v3, "_tok_hist_from_match"),
    (deflate_v3, "_block_checksum"), (deflate_v3, "_build_tables"), (deflate_v3, "_emit"),
)
# The v2 encode's stages: the LZ stage's, the fixed fields with their
# offsets, B3, the rows' placement, the checksum and the overflow index.
V2_STAGES = (
    (deflate_v2, "sort_stage_lex"), (deflate_v2, "lcp_candidates"),
    (deflate_v2, "_post_match"), (deflate_v2, "parse_cover"),
    (deflate_v2, "_merge_seg_boundaries"), (deflate_v2, "_fixed_pack_inputs"),
    (deflate_v2, "emit_pack"), (deflate_v2, "_place_rows"), (deflate_v2, "_block_checksum"),
    (deflate_v2, "cover_overflow"),
)


def stage_ms(encode, stages=STAGES) -> dict:
    """One ``encode()`` with each stage of ``stages`` synchronised before
    and after: ms per stage, summed over the groups, and the whole
    encode's."""
    times = dict.fromkeys((name for _, name in stages), 0.0)

    def timed(name, fn):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = [(mod, name, getattr(mod, name)) for mod, name in stages]
    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        times["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return times


def device_profile(encode) -> dict:
    """One ``encode()`` under torch.profiler. Only the CUDA device's own work is
    counted: kernels, and the copies and sets named Memcpy/Memset. The
    device-side copies of ``record_function`` spans (user annotations) are
    left out, since one spans the whole encode. The union of the work's
    intervals is the device's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
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
    by_name = collections.Counter()
    for start, end, name in dev:
        if not name.startswith(("Memcpy", "Memset")):
            by_name[name] += (end - start) / 1e3
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
            "idle_share": 1 - busy_us / 1e3 / wall_ms,
            "top_kernels_ms": {n[:60]: t for n, t in by_name.most_common(6)}}


def profile_main(corpus: bytes) -> None:
    """``--profile``: per encode path, and for each decode, one warm run,
    one unprofiled, one with the stages synchronised and one under the
    profiler."""
    for path in ("gzip_lex", *HASH_PATHS, "gzip_fixed_v2"):
        enc, _ = make_encoder(path)
        encode = functools.partial(enc.encode, corpus)
        encode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        stages = V2_STAGES if path == "gzip_fixed_v2" else STAGES
        res = {"path": path, "wall_ms": wall_ms, "stages_ms": stage_ms(encode, stages),
               **device_profile(encode)}
        log("profile " + json.dumps(res))
    blocks, lens = split_blocks(corpus)
    with nccl_world():
        encode = functools.partial(mesh_encode_once,
                                   pmesh.make_sharded_encode_step(pmesh.default_mesh()),
                                   blocks, lens)
        encode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = {"path": "mesh_encode", "wall_ms": wall_ms, "stages_ms": stage_ms(encode),
               **device_profile(encode)}
    log("profile " + json.dumps(res))
    for enc_path, path in (("gzip_lex", "gzip_decode"), ("gzip_fixed_v2", "gzip_fixed_v2_decode")):
        enc, _ = make_encoder(enc_path)
        stream, index = enc.encode(corpus)
        decode = functools.partial(BlockParallelDecoder(block_size=BLOCK).decode, stream, index)
        decode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = {"path": path, "wall_ms": wall_ms,
               "stages_ms": gzip_decode_stage_ms(stream, index), **device_profile(decode)}
        log("profile " + json.dumps(res))
    stream = gzip_stream(corpus)
    decode = functools.partial(foreign_decode, stream, len(corpus))
    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    res = {"path": "gzip_foreign_decode", "wall_ms": wall_ms,
           "stages_ms": foreign_decode_stage_ms(stream, len(corpus)), **device_profile(decode)}
    log("profile " + json.dumps(res))
    encode = functools.partial(zstd_frame, corpus, torch.device("cuda"))
    encode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode()
    wall_ms = (time.perf_counter() - t0) * 1e3
    res = {"path": "zstd_device", "wall_ms": wall_ms, "stages_ms": zstd_stage_ms(corpus),
           **device_profile(encode)}
    log("profile " + json.dumps(res))
    frame = encode()
    decode = functools.partial(zstd_decode, frame, torch.device("cuda"))
    decode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    wall_ms = (time.perf_counter() - t0) * 1e3
    res = {"path": "zstd_decode", "wall_ms": wall_ms, "stages_ms": zstd_decode_stage_ms(frame),
           **device_profile(decode)}
    log("profile " + json.dumps(res))
    encode = functools.partial(brotli_stream, corpus, torch.device("cuda"))
    encode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode()
    wall_ms = (time.perf_counter() - t0) * 1e3
    res = {"path": "brotli_device", "wall_ms": wall_ms, "stages_ms": brotli_stage_ms(corpus),
           **device_profile(encode)}
    log("profile " + json.dumps(res))


def host_run(path: str, fn):
    """``run_path`` for a host backend: it must launch no kernel at all."""
    result, launches = run_path(path, fn)
    if any(launches.values()):
        raise AssertionError(f"host path {path} launched kernels: {launches}")
    return result, launches


def host_encode(make, data: bytes, runs: int = 1) -> tuple[bytes, list]:
    """``runs`` one-shot encodes of ``data`` through a fresh ``make()``
    each; every stream must be the same. Returns the stream and the
    seconds of each."""
    streams, times = [], []
    for _ in range(runs):
        vec = ByteVec()
        t0 = time.perf_counter()
        res = make().encode_vec_full(data, vec, EncodeOp.Finish)
        times.append(time.perf_counter() - t0)
        if res.status.name != "Finished":
            raise AssertionError(f"encode did not finish: {res}")
        streams.append(vec.data())
    if any(s != streams[0] for s in streams):
        raise AssertionError("two encodes gave different streams")
    return streams[0], times


def host_decode(make, stream: bytes, want: bytes, runs: int = 1) -> list:
    """``runs`` one-shot decodes of ``stream`` through a fresh ``make()``
    each; every one must finish with the whole stream consumed and give
    ``want``. Returns the seconds of each."""
    times = []
    for _ in range(runs):
        vec = ByteVec()
        t0 = time.perf_counter()
        res = make().decode_vec_full(stream, vec)
        times.append(time.perf_counter() - t0)
        if res.is_error or res.status is not DecodeStatus.Finished or res.input_remain:
            raise AssertionError(f"decode did not finish: {res}")
        if vec.data() != want:
            raise AssertionError("a decode gave other bytes than the input")
    return times


def timed_stdlib(stream: bytes, want: bytes, wbits: int) -> float:
    t0 = time.perf_counter()
    if zlib.decompress(stream, wbits=wbits) != want:
        raise AssertionError("stdlib zlib decodes the stream to other bytes")
    return time.perf_counter() - t0


def mbps(n: int, times: list) -> float:
    return n / statistics.median(times) / 1e6


def host_pairs(corpus: bytes) -> dict:
    """The host backends over the corpus, none of which launches a kernel:

    * zlib_host: ``Interface.zlib()`` at level 6, gzip; its stream decoded
      by ``decoder.Interface.zlib()`` (the Python ``Inflate``),
      ``zlib_native()`` and stdlib zlib;
    * zlib_native, zstd_native, brotli_native: each encoder (3 encodes)
      decoded by its own native decoder (3 decodes), and by the port's
      Python decoder of the format (once): the whole stream for zlib and
      brotli, the first 1 MiB's stream for zstd (its Python sequence
      execution runs at ~0.2 MB/s); the zlib stream by stdlib zlib too.

    Returns each path's measurements: encode and decode MB/s, the ratio."""
    gzip6 = ZlibOptions(mode=ZlibMode.Gzip, level=LEVEL)
    runs = {}

    def zlib_host():
        stream, enc_s = host_encode(lambda: Interface.zlib(gzip6), corpus)
        return stream, enc_s, {
            "zlib": host_decode(decoder.Interface.zlib, stream, corpus),
            "zlib_native": host_decode(decoder.Interface.zlib_native, stream, corpus, 3),
            "stdlib": [timed_stdlib(stream, corpus, 31) for _ in range(3)]}

    def zlib_native():
        stream, enc_s = host_encode(lambda: Interface.zlib_native(gzip6), corpus, 3)
        return stream, enc_s, {
            "zlib_native": host_decode(decoder.Interface.zlib_native, stream, corpus, 3),
            "zlib": host_decode(decoder.Interface.zlib, stream, corpus),
            "stdlib": [timed_stdlib(stream, corpus, 31) for _ in range(3)]}

    def zstd_native():
        stream, enc_s = host_encode(Interface.zstd_native, corpus, 3)
        head = corpus[:1 << 20]
        head_stream, _ = host_encode(Interface.zstd_native, head)
        python = lambda: decoder.Interface.zstd(  # noqa: E731
            ZstdDecodeOptions(device_literals=False), device="cpu")
        return stream, enc_s, {
            "zstd_native": host_decode(decoder.Interface.zstd_native, stream, corpus, 3),
            "zstd_first_MiB": host_decode(python, head_stream, head)}

    def brotli_native():
        stream, enc_s = host_encode(Interface.brotli_native, corpus, 3)
        return stream, enc_s, {
            "brotli_native": host_decode(decoder.Interface.brotli_native, stream, corpus, 3),
            "brotli": host_decode(decoder.Interface.brotli, stream, corpus)}

    for path, fn in (("zlib_host", zlib_host), ("zlib_native", zlib_native),
                     ("zstd_native", zstd_native), ("brotli_native", brotli_native)):
        (stream, enc_s, dec_s), launches = host_run(path, fn)
        res = {"path": path, "bytes": len(corpus), "compressed": len(stream),
               "ratio": len(corpus) / len(stream), "median_s": statistics.median(enc_s),
               "runs_s": enc_s, "MBps": mbps(len(corpus), enc_s),
               "decode_MBps": {k: mbps(1 << 20 if k == "zstd_first_MiB" else len(corpus), v)
                               for k, v in dec_s.items()},
               "decode_runs_s": dec_s, "launches": launches, "runs_counted": len(enc_s)}
        log("e2e " + json.dumps(res))
        runs[path] = res
    return runs


def gzip_decode_host_path(corpus: bytes, stream: bytes, index) -> dict:
    """gzip_lex's stream read back with its index by
    ``BlockParallelDecoder(host=True)``: each block one call into the host
    runtime's whole-block inflate, in a thread pool; one warm decode, then
    three timed, each must give the corpus."""
    dec = BlockParallelDecoder(block_size=BLOCK, host=True)

    def decodes():
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            if dec.decode(stream, index) != corpus:
                raise AssertionError("gzip_decode_host does not give the corpus")
            times.append(time.perf_counter() - t0)
        return times[1:]

    times, launches = host_run("gzip_decode_host", decodes)
    sec = statistics.median(times)
    res = {"path": "gzip_decode_host", "bytes": len(corpus), "compressed": len(stream),
           "ratio": len(corpus) / len(stream), "median_s": sec, "runs_s": times,
           "MBps": len(corpus) / sec / 1e6, "launches": launches, "runs_counted": 3}
    log("e2e " + json.dumps(res))
    return res


def zstd_native_frames(stream: bytes, want: bytes) -> float:
    """A stream of one or more zstd frames through the port's native
    decoder, frame by frame (Finished fires at each frame's end; the
    decoder is reset for the next): raises unless every frame finishes
    and together they give ``want``. Returns the seconds."""
    t0 = time.perf_counter()
    dec, out, rest, frames = decoder.Interface.zstd_native(), bytearray(), stream, 0
    while rest:
        vec = ByteVec()
        res = dec.decode_vec_full(rest, vec)
        if res.is_error or res.status is not DecodeStatus.Finished:
            raise AssertionError(f"zstd frame {frames} did not finish: {res}")
        out += vec.data()
        rest = rest[len(rest) - res.input_remain:]
        frames += 1
        dec.reset()
    if out != want:
        raise AssertionError(f"the {frames} zstd frames give other bytes than the input")
    return time.perf_counter() - t0


def held_to_reference(path: str, stream: bytes) -> str:
    """Raise unless ``stream`` is the JAX reference's stream of the same
    input and options (``HOST_ROUTE_STREAMS``: its length and sha256)."""
    sha = hashlib.sha256(stream).hexdigest()
    if (len(stream), sha) != HOST_ROUTE_STREAMS[path]:
        raise AssertionError(f"{path}: the stream ({len(stream)} bytes, sha256 {sha}) is not "
                             f"the reference's {HOST_ROUTE_STREAMS[path]}")
    return sha


def host_routes(corpus: bytes) -> dict:
    """The zstd and brotli host routes and the scheduler's host engines
    over the corpus, none of which launches a kernel (checked), each
    stream held to the reference's (``HOST_ROUTE_STREAMS``):

    * zstd_host: ``Interface.zstd(ZstdOptions(level=3, window_log=17,
      device_lz=False))``, 3 encodes, decoded by the native decoder (the
      card machine has no ``zstandard``);
    * zstd_host_l19: level 19 over the first ``ZSTD_L19_BYTES`` (a cut:
      the cost-model parse runs at ~1 MB/s on the host), once, decoded;
    * brotli_host: ``Interface.brotli(BrotliOptions(quality=9,
      window_bits=22, device_lz=False))``, 3 encodes, decoded by the
      port's decoder and by libbrotlidec where it loads;
    * zlib_host_parallel: ``BlockParallelEncoder(make_host_block_encode_fn(
      Gzip, 6), block_size=256 KiB)``, 3 encodes, stdlib zlib decodes;
    * zstd_parallel: ``parallel_zstd_compress(corpus, level=3)``, 3
      encodes, every frame decoded by the native decoder.

    Returns each path's measurements."""
    runs = {}
    l19_head = corpus[:ZSTD_L19_BYTES]

    def zstd_host():
        opts = ZstdOptions(level=3, window_log=17, device_lz=False)
        stream, enc_s = host_encode(lambda: Interface.zstd(opts), corpus, 3)
        return stream, enc_s, {"zstd_native": host_decode(decoder.Interface.zstd_native,
                                                          stream, corpus)}

    def zstd_host_l19():
        opts = ZstdOptions(level=19, window_log=17, device_lz=False)
        stream, enc_s = host_encode(lambda: Interface.zstd(opts), l19_head)
        return stream, enc_s, {"zstd_native": host_decode(decoder.Interface.zstd_native,
                                                          stream, l19_head)}

    def brotli_host():
        opts = BrotliOptions(quality=9, window_bits=22, device_lz=False)
        stream, enc_s = host_encode(lambda: Interface.brotli(opts), corpus, 3)
        dec_s = {"brotli": host_decode(decoder.Interface.brotli, stream, corpus)}
        lib = libbrotlidec()
        log(f"brotli_host: libbrotlidec {'found' if lib else 'not found'} on this machine")
        if lib:
            t0 = time.perf_counter()
            if libbrotli_decompress(lib, stream, len(corpus)) != corpus:
                raise AssertionError("brotli_host: libbrotlidec decodes to other bytes")
            dec_s["libbrotlidec"] = [time.perf_counter() - t0]
        return stream, enc_s, dec_s

    def engine_runs(encode, decode):
        streams, enc_s = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            streams.append(encode())
            enc_s.append(time.perf_counter() - t0)
        if any(x != streams[0] for x in streams):
            raise AssertionError("two encodes gave different streams")
        return streams[0], enc_s, decode(streams[0])

    def zlib_host_parallel():
        enc = BlockParallelEncoder(make_host_block_encode_fn(ZlibMode.Gzip, LEVEL),
                                   block_size=BLOCK, mode=ZlibMode.Gzip)
        out = engine_runs(lambda: enc.encode(corpus)[0],
                          lambda s: {"stdlib": [timed_stdlib(s, corpus, 31) for _ in range(3)]})
        if any(st.state != "ok" for st in enc.block_statuses):
            raise AssertionError("zlib_host_parallel: a block status is not ok")
        return out

    def zstd_parallel():
        return engine_runs(lambda: parallel_zstd_compress(corpus, level=3),
                           lambda s: {"zstd_native": [zstd_native_frames(s, corpus)]})

    for path, fn, data in (("zstd_host", zstd_host, corpus),
                           ("zstd_host_l19", zstd_host_l19, l19_head),
                           ("brotli_host", brotli_host, corpus),
                           ("zlib_host_parallel", zlib_host_parallel, corpus),
                           ("zstd_parallel", zstd_parallel, corpus)):
        (stream, enc_s, dec_s), launches = host_run(path, fn)
        sha = held_to_reference(path, stream)
        res = {"path": path, "bytes": len(data), "compressed": len(stream),
               "ratio": len(data) / len(stream), "sha256": sha,
               "median_s": statistics.median(enc_s), "runs_s": enc_s,
               "MBps": mbps(len(data), enc_s),
               "decode_MBps": {k: mbps(len(data), v) for k, v in dec_s.items()},
               "decode_runs_s": dec_s, "launches": launches, "runs_counted": len(enc_s)}
        if data is l19_head:
            res["cut"] = (f"the first {len(data)} bytes of the corpus: level 19's parse runs "
                          "at ~1 MB/s on the host")
        log("e2e " + json.dumps(res))
        runs[path] = res
    return runs


def gzip_v1_path(corpus: bytes, blocks: np.ndarray, lens: np.ndarray) -> dict:
    """The v1 block step on the card (``make_block_encode_fn(kernel="v1")``,
    plain PyTorch: the chain walk, fixed-Huffman blocks, the lane crc) over
    the corpus's 64 blocks through ``BlockParallelEncoder``: one warm
    encode, three timed; stdlib zlib gives the corpus back; one step over
    the first group runs under torch.profiler and must launch CUDA kernels
    (the step ran on the card; none of the nine hand kernels is on its
    path); the CPU's step over the first group gives the card's bytes,
    lengths and checks. Then ``byte_histogram`` of the corpus on the card
    equals ``np.bincount``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = make_block_encode_fn(ZlibMode.Gzip, LEVEL, kernel="v1")
    enc = BlockParallelEncoder(fn, block_size=BLOCK, mode=ZlibMode.Gzip)
    (stream, _, times), launches = host_run("gzip_v1", lambda: timed_encodes(enc, corpus))
    if zlib.decompress(stream, wbits=31) != corpus:
        raise AssertionError("gzip_v1: the stream does not decode to the corpus")
    sha = hashlib.sha256(stream).hexdigest()
    if (len(stream), sha) != V1_STREAM:
        raise AssertionError(f"gzip_v1: the stream ({len(stream)} bytes, sha256 {sha}) is not "
                             f"the CPU's {V1_STREAM}")
    g = len(lens) // GROUPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dev = fn(blocks[:g], lens[:g])
        torch.cuda.synchronize()
    cuda_kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                       and not e.name.startswith(("Memcpy", "Memset")))
    if cuda_kernels == 0:
        raise AssertionError("gzip_v1: the step launched no CUDA kernel")
    t0 = time.perf_counter()
    cpu = make_block_encode_fn(ZlibMode.Gzip, LEVEL, kernel="v1", device="cpu")(blocks[:g],
                                                                               lens[:g])
    t_cpu = time.perf_counter() - t0
    if not (np.array_equal(cpu[1], dev[1]) and np.array_equal(cpu[2], dev[2])
            and all(a.tobytes() == b.tobytes() for a, b in zip(cpu[0], dev[0]))):
        raise AssertionError("gzip_v1: the CPU's step and the card's differ on the first group")
    log(f"gzip_v1: the stream is the CPU's, {len(stream)} bytes, sha256 {sha}; "
        f"{cuda_kernels} CUDA kernels in one step over {g} blocks; cpu == gpu bytes, lengths "
        f"and crc32s of those blocks (cpu run {t_cpu:.1f} s)")
    hist = byte_histogram(torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).cuda())
    if not np.array_equal(hist.cpu().numpy(), np.bincount(np.frombuffer(corpus, np.uint8),
                                                          minlength=256)):
        raise AssertionError("byte_histogram on the card differs from np.bincount")
    log(f"byte_histogram: the corpus's {len(corpus)} bytes on the card equal np.bincount")
    return summary("gzip_v1", corpus, stream, times, launches, cuda_kernels=cuda_kernels,
                   last_timings=fn.last_timings)


def execute_sequences(lits: bytes, seqs) -> bytes:
    """The bytes of (literal length, distance, match length) sequences
    over ``lits``, each match copied a byte at a time where it overlaps,
    and the literals left after the last."""
    out = bytearray()
    at = 0
    for ll, dist, ml in np.asarray(seqs).tolist():
        out += lits[at: at + ll]
        at += ll
        if dist >= ml:
            out += out[len(out) - dist: len(out) - dist + ml]
        else:
            for _ in range(ml):
                out.append(out[-dist])
    return bytes(out + lits[at:])


def native_twins(corpus: bytes) -> dict:
    """Each helper of the host runtime against its Python twin on the
    corpus's first MiB, on this machine's build: the checksums, the DEFLATE
    match finders, cover and squeeze, the zstd sequences, repeat offsets,
    sequences bitstream, Huffman stream and FSE weight stream, the brotli
    commands, distance plan and body. ``optimal_parse`` and ``promote_rep``
    of zstd (no twin in the port yet) are held to the data: their tokens
    tile the input and every match or promoted offset copies equal bytes.
    Returns each helper's seconds, native and twin."""
    data = corpus[:TWIN_BYTES]
    arr = np.frombuffer(data, np.uint8)
    report = {}

    def check(name, got_fn, twin_fn, same=lambda a, b: a == b):
        t0 = time.perf_counter()
        got = got_fn()
        t1 = time.perf_counter()
        twin = twin_fn()
        t2 = time.perf_counter()
        if not same(got, twin):
            raise AssertionError(f"native_twins: {name} differs from its twin")
        report[name] = {"native_s": t1 - t0, "twin_s": t2 - t1}
        return got

    arrays_equal = lambda a, b: all(np.array_equal(np.asarray(x), np.asarray(y))  # noqa: E731
                                    for x, y in zip(a, b))
    check("crc32", lambda: checksum.crc32(data, 7), lambda: checksum.crc32_lanes(data, 7))
    if checksum.crc32(data) != zlib.crc32(data) or checksum.adler32(data) != zlib.adler32(data):
        raise AssertionError("native_twins: the checksums differ from stdlib zlib's")
    check("adler32", lambda: checksum.adler32(data, 7), lambda: checksum.adler32_lanes(data, 7))
    check("xxh64", lambda: xxh64(data, 3), lambda: xxh64_py(data, 3))
    lens, dists = check("find_matches",
                        lambda: deflate_encode.find_matches(arr, LEVEL, ZlibStrategy.Default),
                        lambda: deflate_encode.find_matches_py(arr, LEVEL, ZlibStrategy.Default),
                        arrays_equal)
    check("find_matches_k",
          lambda: deflate_encode.find_matches_k(arr, 9, 1 << 17, K=3, depth=24),
          lambda: deflate_encode.find_matches_k_py(arr, 9, 1 << 17, K=3, depth=24),
          arrays_equal)
    nxt = np.arange(len(arr)) + np.where(lens >= 3, lens, 1)
    check("greedy_cover", lambda: deflate_encode.greedy_cover(nxt),
          lambda: deflate_encode.greedy_cover_py(nxt), np.array_equal)
    check("optimal_parse", lambda: deflate_encode._optimal_parse(arr, lens, dists),
          lambda: deflate_encode._optimal_parse(arr, lens, dists,
                                                squeeze=deflate_encode._squeeze_py),
          arrays_equal)

    # zstd: the sections of the first MiB as one block of tokens at the
    # zstd path's window.
    tok = deflate_encode.tokenize(arr, LEVEL, ZlibStrategy.Default,
                                  max_dist=ZSTD_LCP["max_dist"])
    lits, seqs = check("seq_from_tokens",
                       lambda: zstd_native_enc.seq_from_tokens(data, *tok),
                       lambda: zstd_encode_mod._sequences_from_tokens_py(arr, *tok),
                       lambda a, b: a[0] == b[0] and np.array_equal(np.stack(a[1], 1), b[1]))
    seqs = np.stack(seqs, 1).astype(np.int64)
    rep_in = [5, 9, 2]
    of_values, _ = check(
        "resolve_offsets", lambda: zstd_native_enc.resolve_offsets(seqs[:, 0], seqs[:, 1], rep_in),
        lambda: zstd_encode_mod._resolve_offset_values(seqs.tolist(), rep_in),
        lambda a, b: a[0].tolist() == list(b[0]) and a[1] == list(b[1]))
    T = zstd_tables
    llc = np.asarray([T.ll_code(int(v)) for v in seqs[:, 0]])
    mlc = np.asarray([T.ml_code(int(v)) for v in seqs[:, 2]])
    ofc = np.asarray([int(v).bit_length() - 1 for v in of_values])
    tabs = [zstd_encode_mod._SeqTable(c, *a) for c, a in (
        (llc, (T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG, T.MAX_LL_SYMBOL, T.MAX_LL_LOG)),
        (mlc, (T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG, T.MAX_ML_SYMBOL, T.MAX_ML_LOG)),
        (ofc, (T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG, T.MAX_OF_SYMBOL, T.MAX_OF_LOG)))]
    check("seq_bitstream",
          lambda: zstd_native_enc.seq_bitstream(
              llc, mlc, ofc, seqs[:, 0] - T.LL_BASE[llc], T.LL_BITS[llc],
              seqs[:, 2] - T.ML_BASE[mlc], T.ML_BITS[mlc], of_values - (1 << ofc), ofc,
              *(t.enc for t in tabs)),
          lambda: zstd_encode_mod._sequences_bitstream_py(seqs, llc, mlc, ofc, of_values, *tabs))
    huf = zstd_huff.HufEncoder(np.bincount(np.frombuffer(lits, np.uint8), minlength=256))
    check("huf_stream", lambda: zstd_native_enc.huf_stream(lits, huf.code, huf.nbits),
          lambda: huf.encode_stream_py(lits))
    weights = [int(w) for w in huf.nbits[huf.nbits > 0]][:120]
    freqs = np.bincount(np.asarray(weights), minlength=2)
    norm, log_ = zstd_huff.normalize_counts(freqs, len(weights), 6)
    fse = zstd_huff.FseEncodeTable(norm, log_)
    check("fse_pair_stream", lambda: zstd_native_enc.fse_pair_stream(weights, fse),
          lambda: zstd_huff.fse_pair_stream_py(weights, fse))
    # The host route's parse helpers, held to the data.
    lk, dk = deflate_encode.find_matches_k(arr, 9, ZSTD_LCP["max_dist"], K=3, depth=24,
                                           deflate_heuristics=False)
    n = len(arr)
    lk = np.minimum(lk, (n - np.arange(n))[:, None])
    lk[lk < 3] = 0
    t0 = time.perf_counter()
    ptok = zstd_native_enc.optimal_parse(
        data, 0, n, lk, dk, np.full(256, 8.0), np.full(256, 6.0),
        np.log2(np.maximum(dk, 1) + 3) + 4.0, 3.0, [3, 4, 5, 6, 8, 16, 32, 64], 1)
    report["zstd_optimal_parse"] = {"native_s": time.perf_counter() - t0, "twin_s": None}
    ends = ptok[0] + np.maximum(ptok[1], 1)
    if ptok[0][0] != 0 or not np.array_equal(ptok[0][1:], ends[:-1]) or ends[-1] != n:
        raise AssertionError("native_twins: zstd optimal_parse's tokens do not tile the input")
    plits, pseqs = zstd_encode_mod._sequences_from_tokens(arr, *ptok)
    t0 = time.perf_counter()
    promoted = zstd_native_enc.promote_rep(data, 0, pseqs, rep_in)
    report["zstd_promote_rep"] = {"native_s": time.perf_counter() - t0, "twin_s": None}
    for name, rows in (("optimal_parse", pseqs), ("promote_rep", promoted)):
        if execute_sequences(plits, rows) != data:
            raise AssertionError(f"native_twins: zstd {name}'s sequences give other bytes")
    # brotli: one meta-block of the first MiB at its window.
    btok = deflate_encode.tokenize(arr, LEVEL, ZlibStrategy.Default,
                                   max_dist=BROTLI_LCP["max_dist"])
    commands = check("commands_from_tokens",
                     lambda: brotli_encode_mod._commands_from_tokens(*btok),
                     lambda: brotli_encode_mod._commands_from_tokens_py(*btok), arrays_equal)
    ring = [4, 11, 15, 16]
    plan = check("plan_distances",
                 lambda: brotli_encode_mod._plan_commands(*commands, ring, True),
                 lambda: brotli_encode_mod._plan_commands(*commands, ring, False), arrays_equal)
    start_a, ins_a = commands[:2]
    tot = int(ins_a.sum())
    cum = np.concatenate([[0], np.cumsum(ins_a)[:-1]])
    lit_pos = np.repeat(start_a, ins_a) + np.arange(tot) - np.repeat(cum, ins_a)
    cmap, lit_codes, cid_of_pos = brotli_encode_mod._context_model(
        arr, lit_pos, arr[lit_pos], enabled=True, tail=b"")

    def body(use_native):
        sink = brotli_encode_mod.BitSink()
        cmd_code, dist_code = brotli_encode_mod._write_meta_block_header(
            sink, len(data), cmap, lit_codes, plan[6], plan[7])
        brotli_encode_mod._emit_body(sink, data, b"\0\0", commands, plan[:6], cmd_code,
                                     dist_code, lit_codes, cmap, cid_of_pos, use_native)
        return bytes(sink.out), sink.acc, sink.nbits

    check("emit_commands", lambda: body(True), lambda: body(False))
    log("native_twins: " + json.dumps(report))
    return report


def host_cpu() -> str:
    """The host CPU's model (from /proc/cpuinfo, else ``lscpu``, else the
    platform module) and the cores this process may use: the host paths'
    numbers are the CPU's."""
    import platform

    model = ""
    with contextlib.suppress(OSError):
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            if key.strip().lower() in ("model name", "cpu model") and value.strip():
                model = value.strip()
                break
    if not model:
        with contextlib.suppress(OSError, subprocess.SubprocessError):
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
            model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                          if line.lower().startswith("model name")), "")
    model = model or platform.processor() or "model not reported"
    return f"{model} ({platform.machine()}), {len(os.sched_getaffinity(0))} cores available"


def timed_call(fn):
    """``fn()`` and the seconds it took."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main() -> None:
    t_run = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the smoke run needs one GPU")
    if sys.argv[1:] not in ([], ["--profile"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--profile]")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"host cpu: {host_cpu()}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        smoke = pool.submit(_build.build, SMOKE_SOURCES, "libcompu_smoke")
        host = pool.submit(timed_call, native.build)
        path = _build.build()
        smoke.result()
        host_path, host_s = host.result()
    _build.lib()
    native.lib()
    log(f"built {path.name} and this script's library in {time.perf_counter() - t0:.1f} s")
    log(f"native {host_path} built in {host_s:.1f} s "
        f"({'its own g++ per source, all at once, beside nvcc' if host_s > 0.5 else 'already built'}), "
        f"{native.compiler_version()}")
    for line in _build.ptxas_report().splitlines():
        if line.startswith("==") or any(w in line for w in ("Compiling entry", "Used", "spill")):
            log("ptxas " + line.strip())
    LCP_COST.update(lcp_candidate_cost(path))
    log("sass lcp_candidates per candidate " + json.dumps(LCP_COST))
    MATCH_COST.update(match_candidate_cost(path))
    log("sass match_candidates per candidate " + json.dumps(MATCH_COST))

    corpus = build_corpus(CORPUS_BYTES)
    if sys.argv[1:] == ["--profile"]:
        profile_main(corpus)
        return
    blocks, lens = split_blocks(corpus)
    scan_args = record_scan_inputs(corpus[:ZSTD_SPAN])
    zstd_call = torch.from_numpy(np.frombuffer(corpus[:ZSTD_SPAN], np.uint8).copy()[None]).cuda()
    kernels = check_kernels(
        kernel_inputs(torch.from_numpy(blocks[:16]).cuda(), torch.from_numpy(lens[:16]).cuda(),
                      torch.from_numpy(blocks.reshape(-1)).cuda(), zstd_call, scan_args),
        [name for name in KERNELS
         if name not in ("huf_decode_lanes", "inflate_scan", "inflate_spec")])
    runs = {}
    runs["gzip_lex"], gz_stream, gz_index = gzip_lex_path(corpus)
    runs["gzip_decode"], p3_entry = gzip_decode_path(corpus, gz_stream, gz_index)
    runs["gzip_foreign_decode"], p4_entry = gzip_foreign_decode_path(corpus)
    runs["gzip_fixed_v2"], runs["gzip_fixed_v2_decode"] = gzip_fixed_v2_path(corpus)
    metas = {}
    for p in HASH_PATHS:
        runs[p], metas[p] = zlib_hash_path(p, corpus)
    runs["adler_device"] = adler_device_path(blocks, lens, metas["zlib_hash"])
    runs["mesh_encode"] = mesh_encode_path(corpus, blocks, lens)
    runs["zstd_device"], frame, head_frame = zstd_device_path(corpus)
    runs["zstd_decode"], p2_entry = zstd_decode_path(corpus, frame, head_frame)
    runs["brotli_device"] = brotli_device_path(corpus)
    runs.update(host_pairs(corpus))
    runs["gzip_decode_host"] = gzip_decode_host_path(corpus, gz_stream, gz_index)
    native_twins(corpus)
    runs.update(host_routes(corpus))
    runs["gzip_v1"] = gzip_v1_path(corpus, blocks, lens)
    kernels += p2_entry + p3_entry + p4_entry
    log(f"e2e side by side ({smi.splitlines()[0]}): " + ", ".join(
        f"{p} {runs[p]['MBps']:.2f} MB/s ratio {runs[p]['ratio']:.4f}"
        for p in ("gzip_lex", "gzip_decode", "gzip_foreign_decode", "gzip_fixed_v2",
                  "gzip_fixed_v2_decode", *HASH_PATHS, "mesh_encode", "zstd_device",
                  "zstd_decode", "brotli_device", *HOST_PATHS, *HOST_ROUTES, "gzip_v1")))
    for k in kernels:
        for entry in (k, *k.get("other_paths", ())):
            run = runs[entry["path"]]
            entry["launches"] = run["launches"][k["name"]]
            entry["launches_per_encode"] = entry["launches"] / run["runs_counted"]
        k["launches_by_path"] = {p: r["launches"][k["name"]] for p, r in runs.items()
                                 if r["launches"].get(k["name"])}
    cpu_equals_device(blocks[:4], lens[:4], "gzip_lex", with_index=True, check="crc", **LADDER)
    for p, cfg in HASH_PATHS.items():
        cpu_equals_device(blocks[:4], lens[:4], p, with_index=True, check="adler", **cfg)
    cpu_equals_device(blocks[:V2_CPU_BLOCKS], lens[:V2_CPU_BLOCKS], "gzip_fixed_v2",
                      encode=encode_blocks_fixed_v2, with_index=True, check="crc",
                      depth=V2_DEPTH)
    stream_encoder()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "compu_tpu", "bench"))
    if leaked:
        raise AssertionError(f"the JAX package or JAX was imported: {leaked[:5]}")

    log(f"run: {time.perf_counter() - t_run:.1f} s from start to the report, the kernels' "
        f"build included ({smi.splitlines()[0]})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
