#!/usr/bin/env python3
"""Stage profiles of the v3 encodes of two trees of the port on one card,
in turns.

    python3 scripts/ab_profile.py PARENT_DIR

``PARENT_DIR`` holds another tree of the repository (a ``git archive``
unpacked, e.g. the parent commit). Worker processes run, from each tree in
turns (parent, this tree, this tree, parent), each with its tree's
``compu_tpu_torch`` and ``chip_smoke.py`` first on ``sys.path`` (and its
kernels built into its own ``_build/``), what ``chip_smoke.py --profile``
runs for the four encodes that take the v3 table stage, over the 16 MB
benchmark corpus: gzip_lex, zlib_hash, zlib_hash_time_lex (a warm encode,
an unprofiled one, one with every stage synchronised, one under
torch.profiler) and mesh_encode's sharded step on an NCCL world of one
rank (the same). Each worker prints one JSON line a path: the wall ms,
the stage ms (``stages_ms``; ``_build_tables`` among them), the CUDA
kernels and copies, the kernel and busy ms and the idle share. Then one
line a path and measure, each tree's values by turn, beside the card's
name and power limit.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
PATHS = ("gzip_lex", "zlib_hash", "zlib_hash_time_lex", "mesh_encode")


def worker() -> None:
    import functools

    import torch

    import chip_smoke as cs
    from compu_tpu_torch.parallel import mesh as pmesh

    corpus = cs.build_corpus(cs.CORPUS_BYTES)
    blocks, lens = cs.split_blocks(corpus)

    def profile(path, encode):
        encode()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        res = {"tree": os.environ["AB_TREE"], "path": path, "wall_ms": wall_ms,
               "stages_ms": cs.stage_ms(encode), **cs.device_profile(encode)}
        print(json.dumps(res), flush=True)

    for path in PATHS[:3]:
        enc, _ = cs.make_encoder(path)
        profile(path, functools.partial(enc.encode, corpus))
    with cs.nccl_world():
        step = pmesh.make_sharded_encode_step(pmesh.default_mesh())
        profile("mesh_encode", functools.partial(cs.mesh_encode_once, step, blocks, lens))


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
    rows = []
    for name, root in (("parent", parent), ("this", HERE), ("this", HERE), ("parent", parent)):
        env = dict(os.environ, PYTHONPATH=str(root), AB_TREE=name)
        out = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                              "--worker"], cwd=root, env=env, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise SystemExit(f"the {name} worker failed:\n{out.stderr[-4000:]}")
        for line in out.stdout.strip().splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))
                print(line, flush=True)
    for path in PATHS:
        mine = [r for r in rows if r["path"] == path]
        for key in ("wall_ms", "build_tables_ms", "total_ms", "kernels", "idle_share"):
            vals = [r["stages_ms"]["_build_tables" if key == "build_tables_ms" else "total"]
                    if key in ("build_tables_ms", "total_ms") else r[key] for r in mine]
            print(f"{path} {key} ({smi}): " + ", ".join(
                f"{r['tree']} {v:.4f}" if isinstance(v, float) else f"{r['tree']} {v}"
                for r, v in zip(mine, vals)), flush=True)


if __name__ == "__main__":
    main()
