#!/usr/bin/env python3
"""End-to-end paths of two trees of the port on one card, in turns.

    python3 scripts/ab_paths.py PARENT_DIR

``PARENT_DIR`` holds another tree of the repository (a ``git archive``
unpacked, e.g. the parent commit). Worker processes run the same paths
from each tree in turns, parent, this tree, this tree, parent, twice, each with
its tree's ``compu_tpu_torch`` first on ``sys.path`` (and its kernels
built into its own ``_build/``), so that two versions of the package are
compared on the same card and host within one run. Each worker encodes
or decodes the 16 MB benchmark corpus (``utils/corpus.build_corpus``) on
the paths of ``chip_smoke.py`` whose code both trees share, with the API
both trees take:

* gzip_lex: ``make_block_encode_fn(Gzip, 6, segment_index=True,
  pipeline_groups=4)`` through ``BlockParallelEncoder`` at 256 KiB blocks;
* gzip_decode: that stream back with its index, ``BlockParallelDecoder()``;
* zstd_device: ``Interface.zstd(ZstdOptions(device_literals=True,
  device_sequences=True))`` (the device LZ stage in both trees);
* brotli_device: ``Interface.brotli()`` (quality 9, window 22);

each one warm run and three timed (host clock after a synchronise), the
median and the runs printed as one JSON line a worker, then each path's
MB/s by worker on one line beside the card's name and power limit. The
gzip stream must decode through stdlib zlib, the decode path must give
the corpus back, and the streams' sizes must agree across the trees.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def worker() -> None:
    import zlib

    import torch

    from compu_tpu_torch import BlockParallelDecoder, BlockParallelEncoder, ZlibMode
    from compu_tpu_torch import make_block_encode_fn
    from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface
    from compu_tpu_torch.formats.zstd.options import ZstdOptions
    from compu_tpu_torch.utils.corpus import build_corpus

    corpus = build_corpus(16 << 20)

    def timed(fn):
        fn()
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        return out, runs

    def one_shot(make):
        vec = ByteVec()
        make().encode_vec_full(corpus, vec, EncodeOp.Finish)
        return vec.data()

    res = {}
    fn = make_block_encode_fn(ZlibMode.Gzip, 6, segment_index=True, pipeline_groups=4)
    enc = BlockParallelEncoder(fn, block_size=1 << 18, mode=ZlibMode.Gzip)
    (stream, index), res["gzip_lex"] = timed(lambda: enc.encode(corpus))
    if zlib.decompress(stream, wbits=31) != corpus:
        raise AssertionError("gzip_lex does not decode")
    dec = BlockParallelDecoder(block_size=1 << 18)
    back, res["gzip_decode"] = timed(lambda: dec.decode(stream, index))
    if back != corpus:
        raise AssertionError("gzip_decode does not give the corpus")
    frame, res["zstd_device"] = timed(lambda: one_shot(lambda: Interface.zstd(
        ZstdOptions(device_literals=True, device_sequences=True))))
    brotli, res["brotli_device"] = timed(lambda: one_shot(Interface.brotli))
    sizes = {"gzip_lex": len(stream), "zstd_device": len(frame), "brotli_device": len(brotli)}
    print(json.dumps({"tree": os.environ["AB_TREE"], "sizes": sizes,
                      "MBps": {k: len(corpus) / statistics.median(v) / 1e6
                               for k, v in res.items()},
                      "runs_s": res}), flush=True)


def main() -> None:
    if sys.argv[1:] == ["--worker"]:
        worker()
        return
    if len(sys.argv) != 2:
        raise SystemExit(f"usage: {sys.argv[0]} PARENT_DIR")
    parent = pathlib.Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lines = []
    turns = (("parent", parent), ("this", HERE), ("this", HERE), ("parent", parent)) * 2
    for name, root in turns:
        env = dict(os.environ, PYTHONPATH=str(root), AB_TREE=name)
        out = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--worker"], cwd=root, env=env, capture_output=True, text=True,
                             timeout=1200)
        if out.returncode:
            raise SystemExit(f"the {name} worker failed:\n{out.stderr[-4000:]}")
        lines.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    if len({json.dumps(x["sizes"], sort_keys=True) for x in lines}) != 1:
        raise AssertionError("the trees' streams differ in size")
    for path in lines[0]["MBps"]:
        print(f"{path} ({smi}): " + ", ".join(f"{x['tree']} {x['MBps'][path]:.2f}"
                                             for x in lines) + " MB/s", flush=True)


if __name__ == "__main__":
    main()
