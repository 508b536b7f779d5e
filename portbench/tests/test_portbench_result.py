"""The result line: its keys in order, numbers as measured, the compared
numbers last; and no result where the run cannot be a run of the cell."""

import json
import shutil
import subprocess
import sys
import time

import pytest
from _small import small_cell

from portbench import harness


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    cell = small_cell()
    r = harness.run_cell(cell, 2**31 + 77, 0.5, trace, t_start=time.perf_counter(),
                         device="cpu", log=lambda m: None)
    line = json.loads(json.dumps(r))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # The CPU has no device trace: only host-clock metrics can be read there.
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and m["unit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"framing_ms", "dispatch_ms", "fetch_ms"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"MBps", "p95_ms", "ratio", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "gzip-l6.mixed-16m", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def _no_result(out):
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_no_card_no_result(cuda_absent):
    _no_result(_run(harness.ROOT))


def test_benchmark_alone_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
