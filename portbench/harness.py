"""One run of one cell: set-up, a closed-loop window of requests, the
judgement of every answer, and the result line.

``python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` (from the root of a checkout). The cell's configuration,
traffic and per-layer metrics are files found by their names in
``BENCHMARK.json``; the configuration's ``entry`` names the module under
``portbench/entries/`` that builds the system under test.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import pathlib
import platform
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(__file__).resolve().parent
#: Top-level modules that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "compu_tpu", "bench")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def prepare_env() -> None:
    """Before torch is imported: kernel and build caches inside the
    checkout at fixed paths, one thread for the process's own pools, and
    no JAX loaded on the port's behalf."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files.
    Raises on a key or value of the traffic or the configuration that the
    generator or the entry does not implement."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{work['traffic']}.json").read_text())
    from . import generate

    generate.check(traffic)
    importlib.import_module(f"portbench.entries.{config['entry']}").check(config)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return Cell(work, config, traffic, e2e, layer)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``compu_tpu_torch`` is not ``compu_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Request:
    k: int             # which input of the pool
    out: object        # the entry's output, None if it raised
    seconds: float
    times: dict        # host layer times the entry reported
    error: str | None = None


def closed_loop(sut, pool, seconds: float, clock=time.perf_counter):
    """One client: each request is sent when the last one returns, the
    inputs in turn, until ``seconds`` have passed. Returns (window start,
    window end, requests); the window ends when its last request does."""
    import torch

    reqs = []
    t0 = clock()
    end = t0
    while end - t0 < seconds:
        k = len(reqs) % len(pool)
        start = clock()
        with torch.profiler.record_function("portbench/request"):
            try:
                out, times = sut(pool[k])
                err = None
            except Exception:  # a failed request is counted, the window goes on
                out, times, err = None, {}, traceback.format_exc(limit=3)
        end = clock()
        reqs.append(Request(k, out, end - start, times, err))
    return t0, end, reqs


def p95(values: list[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def end_to_end(pool, t0: float, t1: float, reqs, sut, setup_s: float) -> dict:
    """``MBps``: input bytes (10^6) of the requests completed in the window
    over its seconds; ``p95_ms``: of every request's latency; ``ratio``:
    input over stream bytes of the completed requests; ``setup_s``."""
    done = [r for r in reqs if r.out is not None]
    raw = sum(len(pool[r.k]) for r in done)
    packed = sum(sut.out_bytes(r.out) for r in done)
    vals = {"MBps": (raw / 1e6 / (t1 - t0), "MB/s"),
            "p95_ms": (1e3 * p95([r.seconds for r in reqs]), "ms"),
            "setup_s": (setup_s, "s")}
    if packed:
        vals["ratio"] = (raw / packed, "x")
    return {k: {"value": v, "unit": u} for k, (v, u) in vals.items()}


def judge_window(sut, pool, reqs, log, seed: int) -> dict:
    """Judge every answer of the window: each distinct output of an input
    in full by the reference, the others by equality with it; the
    reference's sample of each output's blocks is drawn from ``seed``.
    Returns the compared numbers, each ``{"value", "limit"}``."""
    import numpy as np

    from . import reference

    counts = dict.fromkeys(reference.COUNTS, 0)
    raised = sum(r.out is None for r in reqs)
    distinct: dict[int, list] = {}
    bad_requests = 0
    for r in reqs:
        if r.out is None:
            continue
        seen = distinct.setdefault(r.k, [])
        for out, verdict in seen:
            if sut.same(out, r.out):
                bad_requests += any(verdict.values())
                break
        else:
            rng = np.random.default_rng([seed % (1 << 64), r.k, len(seen), 1])
            verdict = sut.judge(pool[r.k], r.out, rng)
            log(f"judged input {r.k}: {verdict}")
            seen.append((r.out, verdict))
            for key, v in verdict.items():
                counts[key] += v
            bad_requests += any(verdict.values())
    checks = {key: counts[key] for key in reference.COUNTS}
    checks["raised"] = raised
    return {"checks": {k: {"value": v, "limit": 0} for k, v in checks.items()},
            "failed": raised + bad_requests}


def host_facts() -> dict:
    facts = {"python": platform.python_version(), "cpus": os.cpu_count()}
    try:
        for line in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                facts["cpu_model"] = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        facts["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        facts["nvidia_smi"] = None
    return facts


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader is given."""
    trace: object
    requests: list     # host layer times of each completed request
    inputs: list       # the input of each request of the window
    device_kind: str
    block_size: int
    matcher: dict
    program_kernels: set


def per_layer(cell: Cell, trace, reqs, pool, device_kind: str) -> dict:
    from . import trace as tr

    csrc = ROOT / "compu_tpu_torch" / "csrc"
    ctx = Context(trace, [r.times for r in reqs if r.out is not None], [pool[r.k] for r in reqs],
                  device_kind, int(cell.config["block_size"]), cell.config["matcher"],
                  tr.kernel_names_in(sorted(csrc.glob("*.cu"))))
    out = {}
    for m in cell.per_layer:
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", clock=time.perf_counter, wrap_step=None, log=None):
    """Set up, run the window and judge it. Returns the result dict (the
    keys of the last line)."""
    import torch

    from . import generate

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    pool = generate.make_pool(cell.traffic, seed)
    entry = importlib.import_module(f"portbench.entries.{cell.config['entry']}")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sut = entry.build(cell.config, device, wrap_step)
    sut(pool[0])  # the cell's one shape, warm: builds and loads every kernel
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    setup_s = clock() - t_start
    t0, t1, reqs = closed_loop(sut, pool, seconds, clock)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else platform.processor() or "cpu"
    for r in reqs:
        if r.error:
            log(f"request {r.k} raised:\n{r.error}")
            break
    lat = [round(1e3 * r.seconds, 3) for r in reqs]
    log(f"window: {len(reqs)} requests in {t1 - t0:.6f} s; set-up {setup_s:.6f} s; "
        f"ms first {lat[:4]}, median {statistics.median(lat)}, max {max(lat)}")
    log(f"latencies ms: {[round(x, 1) for x in lat]}")
    result = {"correct": False, "attempted": len(reqs), "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                         "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}}
    if trace:
        from .trace import Trace

        t_read = time.perf_counter()
        tr = Trace(prof.profiler.kineto_results.events())
        result["metrics"] = per_layer(cell, tr, reqs, pool, kind)
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
        log(f"trace: {tr.n_requests} requests, {len(tr.names)} device events, "
            f"read in {time.perf_counter() - t_read:.1f} s")
    else:
        result["metrics"] = end_to_end(pool, t0, t1, reqs, sut, setup_s)
    del prof
    verdict = judge_window(sut, pool, reqs, log, seed)
    result["failed"] = verdict["failed"]
    result["correct"] = all(c["value"] <= c["limit"] for c in verdict["checks"].values())
    result["checks"] = verdict["checks"]
    return result


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    print(json.dumps({"host": host_facts(), "workload": args.workload, "seed": args.seed}),
          flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
