"""Nothing the benchmark runs loads JAX or the JAX package; top-level
module names are compared whole, since the port's name begins with the
JAX package's."""

import ast
import subprocess
import sys
import types

from portbench import harness


def test_top_level_names_compared_whole(monkeypatch):
    clean = dict.fromkeys(["torch", "compu_tpu_torch", "compu_tpu_torch.kernels", "benchmarks",
                           "jaxtyping", "portbench.harness"])
    monkeypatch.setattr(harness, "sys", types.SimpleNamespace(modules=clean))
    assert harness.forbidden_modules() == []
    dirty = dict(clean, **dict.fromkeys(["compu_tpu.kernels.lcp_match", "jaxlib.xla_client",
                                         "bench"]))
    monkeypatch.setattr(harness, "sys", types.SimpleNamespace(modules=dirty))
    assert harness.forbidden_modules() == ["bench", "compu_tpu", "jaxlib"]


def test_no_source_imports_them():
    for path in harness.PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(harness.FORBIDDEN), (path, tops)


def test_a_run_loads_none_of_them():
    """A whole run of a small cell on the CPU, in a fresh interpreter."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.PKG / 'tests')!r}]\n"
        "from _small import small_cell\n"
        "from portbench import harness\n"
        "r = harness.run_cell(small_cell(), 3, 0.3, False, t_start=time.perf_counter(),"
        " device='cpu', log=lambda m: None)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
