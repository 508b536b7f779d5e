"""Build, load and count the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``_build/`` under a name that hashes the sources and the
flags, so an edited source rebuilds and an unchanged one is reused. The
build runs at the first kernel launch of a process, never at import.
ptxas's report of each kernel's registers, shared memory and spills is
kept beside the library (``ptxas_report``).

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per kernel name since the last reset_launch_counts().
LAUNCHES = {"lcp_candidates": 0, "parse_cover": 0, "emit_pack": 0,
            "match_candidates": 0, "adler_tiles": 0, "fse_seq_scan": 0,
            "huf_decode_lanes": 0, "inflate_scan": 0, "inflate_spec": 0, "build_tables": 0,
            "inflate_expand": 0, "inflate_resolve": 0}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "compu_lcp_candidates": (_P, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _P),
    "compu_parse_cover": (_P, _P, _LL, _P),
    "compu_emit_pack": (_P, _P, _P, _LL, _I, _P),
    "compu_match_candidates": (_P, _P, _P, _I, _P, _P, _LL, _LL, _I, _I, _P),
    "compu_adler_tiles": (_P, _P, _LL, _P),
    "compu_fse_seq_scan": (_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "compu_fse_seq_scan_smem": (),
    "compu_huf_decode_lanes": (_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _P, _P),
    "compu_inflate_scan": (_P, _LL, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "compu_inflate_scan_smem": (_I, _I, _I),
    "compu_inflate_spec": (_P, _LL, _P, _LL, _LL, _P, _P, _P),
    "compu_build_tables": (_P,) * 16 + (_LL, _P),
    "compu_inflate_resolve_max_grid": (),
    "compu_inflate_resolve_ctr_words": (),
    "compu_inflate_resolve_tile": (),
    "compu_inflate_expand_indexed": (_P, _LL, _I, _LL, _P, _P, _P),
    "compu_inflate_expand_foreign": (_P, _P, _P, _LL, _P, _P, _LL, _P, _P),
    "compu_inflate_resolve": (_P, _LL, _LL, _P, _P, _I, _LL, _P, _P, _P, _P, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(srcs=None, stem: str = "libcompu_kernels") -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() if srcs is None else srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(srcs=None, stem: str = "libcompu_kernels") -> pathlib.Path:
    """Compile the kernels (or the given ``srcs`` into a library named by
    ``stem``) unless this exact build exists; return its path. Each source
    compiles in its own nvcc, all started together, and one more links
    them. The library is written in a temporary directory and renamed into
    place, so a process building at the same time never loads a
    half-written file."""
    srcs = sources() if srcs is None else list(srcs)
    out = library_path(srcs, stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in srcs]
        procs = [(src, subprocess.Popen(
                     [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                 for src, obj in zip(srcs, objs)]
        failed, logs = [], []
        for src, proc in procs:
            log = proc.communicate()[0]
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode:
                failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("\n".join(failed))
        out.with_suffix(".ptxas.txt").write_text("".join(logs))
        lib_tmp = pathlib.Path(tmp) / out.name
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(lib_tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(lib_tmp, out)
    return out


def ptxas_report() -> str:
    """ptxas's output for the current build (registers, shared memory and
    spills of every kernel), per source file."""
    return build().with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=1)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return handle


def check_launch(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error; else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an integer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, *, ndim: int,
            dtype: torch.dtype = torch.int32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given rank and
    dtype — what every kernel wrapper takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
