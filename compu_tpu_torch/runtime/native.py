"""Build, load and call the port's host runtime.

The ten C++ files under ``csrc/`` are compiled by ``g++ -O3 -fPIC`` and
linked with ``-shared`` into one library in the package's ``_build/``,
under a name that hashes the compiler, the flags and the sources: an
edited source rebuilds and an unchanged one is reused, and no file's
modification time is ever compared. The build runs at the first call of a
process, never at import. Processes that reach it together (pytest's
workers) take a file lock beside the library: one builds, in a temporary
directory whose library is renamed into place, and the others wait and
load that file. Each source compiles in its own g++, all started
together, and one more links them.

A build that fails raises, with the compiler's output. Nothing falls back
to the Python twins of these helpers: they stay as the plain versions the
tests hold the library against, and are called by name.

The library is loaded with ``ctypes.CDLL``, whose calls release the GIL,
so threads that call it run in parallel. ``lib()`` gives the loaded
library with every entry point's signature set; the wrappers below are
the calls the checksums and the DEFLATE encoder make.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC")
LDFLAGS = ("-shared",)
STEM = "libcompu_runtime"

_P, _I, _LL, _SZ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t
_U8P, _SZP, _CP = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p
_CHANNEL = [_I, _P, _P, _P, _I]  # has, state table, delta nbits, delta find, table log

#: name -> (restype, argtypes) of every entry point the port calls.
_SIGNATURES = {
    "compu_crc32": (ctypes.c_uint32, [_CP, _SZ, ctypes.c_uint32]),
    "compu_adler32": (ctypes.c_uint32, [_CP, _SZ, ctypes.c_uint32]),
    "compu_xxh64": (ctypes.c_uint64, [_CP, _SZ, ctypes.c_uint64]),
    "compu_malloc": (_P, [_SZ]),
    "compu_free": (None, [_P]),
    "compu_alloc_size": (_SZ, [_P]),
    "compu_deflate_new": (_P, [_I]),
    "compu_deflate_free": (None, [_P]),
    "compu_deflate_reset": (None, [_P]),
    "compu_deflate_set_hash_bits": (None, [_P, _I]),
    "compu_deflate_run": (_SZ, [_P, _CP, _SZ, _P, _SZ, _I, _I]),
    "compu_optimal_parse": (ctypes.c_int64, [_CP, ctypes.c_int64, _P, _P, _P, _P, _P, _P,
                                             ctypes.c_int32, _P, _P, _P]),
    "compu_zstd_new": (_P, [_I]),
    "compu_zstd_free": (None, [_P]),
    "compu_zstd_reset": (None, [_P]),
    "compu_zstd_run": (_I, [_P, _U8P, _SZ, _P, _SZ, _SZP, _SZP]),
    "compu_brotli_new": (_P, []),
    "compu_brotli_free": (None, [_P]),
    "compu_brotli_reset": (None, [_P]),
    "compu_brotli_set_tables": (None, [_CP, _SZ, _CP, _SZ, _CP, _SZ]),
    "compu_brotli_run": (_I, [_P, _U8P, _SZ, _I, _P, _SZ, _SZP, _SZP]),
    "compu_zstd_seq_from_tokens": (_LL, [_CP, _LL, _P, _P, _P, _P, _P, _P, _P,
                                         ctypes.POINTER(_LL)]),
    "compu_zstd_resolve_offsets": (None, [_P, _P, _LL, _P, _P]),
    "compu_zstd_seq_bitstream": (_LL, [_LL] + [_P] * 9 + _CHANNEL * 3 + [_P, _LL]),
    "compu_huf_encode_stream": (_LL, [_CP, _LL, _P, _P, _P, _LL]),
    "compu_fse_pair_stream": (_LL, [_CP, _LL, _P, _P, _P, _I, _P, _LL]),
    "compu_zstd_optimal_parse": (_LL, [_CP, _LL, _LL, _P, _P, _I, _P, _P, _P, ctypes.c_double,
                                       _P, _I, _LL, _P, _P, _P]),
    "compu_zstd_promote_rep": (None, [_CP, _LL, _LL, _P, _P, _P, _LL, _P]),
    "compu_find_matches_k": (_LL, [_CP, _LL, _LL, _I, _I, _I, _I, _I, _P, _P]),
    "compu_greedy_cover": (_LL, [_P, _LL, _P]),
    "compu_find_matches": (None, [_CP, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P]),
    "compu_brotli_commands_from_tokens": (_LL, [_LL, _P, _P, _P, _LL, _P, _P, _P, _P]),
    "compu_brotli_plan_distances": (_LL, [_LL, _P, _P, _P, _P, _P, _P, _P]),
    "compu_brotli_emit_commands": (_LL, [_CP, _LL, _CP, _LL] + [_P] * 14
                                   + [_I, _P, _P, _P, _P, _P, ctypes.c_uint64, _I,
                                      _P, _LL, _P, _P]),
    "compu_inflate_new": (_P, []),
    "compu_inflate_free": (None, [_P]),
    "compu_inflate_reset": (None, [_P]),
    "compu_inflate_run": (_I, [_P, _U8P, _SZ, _P, _SZ, _SZP, _SZP]),
    "compu_inflate_set_check": (None, [_P, _I]),
    "compu_inflate_get_check": (ctypes.c_uint32, [_P]),
    "compu_zstd2_new": (_P, [_I, _I, _I]),
    "compu_zstd2_free": (None, [_P]),
    "compu_zstd2_reset": (None, [_P]),
    "compu_zstd2_run": (_LL, [_P, _CP, _SZ, _P, _SZ, _I]),
    "compu_brenc2_new": (_P, [_I, _I]),
    "compu_brenc2_free": (None, [_P]),
    "compu_brenc2_reset": (None, [_P]),
    "compu_brenc2_run": (_LL, [_P, _CP, _SZ, _P, _SZ, _I]),
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cpp"))


def library_path(srcs=None, cxx: str = CXX, build_dir=BUILD_DIR) -> pathlib.Path:
    """Where the library of these sources, this compiler and the flags lives."""
    h = hashlib.sha256(" ".join((cxx, *CXXFLAGS, *LDFLAGS)).encode())
    for src in sources() if srcs is None else srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return pathlib.Path(build_dir) / f"{STEM}_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.Popen:
    try:
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        raise RuntimeError(f"the host runtime cannot be built: {cmd[0]}: {exc}") from exc


def build(srcs=None, cxx: str = CXX, build_dir=BUILD_DIR) -> pathlib.Path:
    """Compile ``srcs`` (the package's sources by default) unless this exact
    build exists; return the library's path. Raises ``RuntimeError`` with
    the compiler's output when a compile or the link fails."""
    srcs = sources() if srcs is None else [pathlib.Path(s) for s in srcs]
    out = library_path(srcs, cxx, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{STEM}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            objs = [pathlib.Path(tmp) / f"{src.stem}.o" for src in srcs]
            procs = [(src, _run([cxx, *CXXFLAGS, "-c", "-o", str(obj), str(src)]))
                     for src, obj in zip(srcs, objs)]
            failed = []
            for src, proc in procs:
                log = proc.communicate()[0]
                if proc.returncode:
                    failed.append(f"{src.name}: {cxx} failed ({proc.returncode}):\n{log}")
            if failed:
                raise RuntimeError("\n".join(failed))
            lib_tmp = pathlib.Path(tmp) / out.name
            link = _run([cxx, *LDFLAGS, "-o", str(lib_tmp), *map(str, objs)])
            log = link.communicate()[0]
            if link.returncode:
                raise RuntimeError(f"{cxx} link failed ({link.returncode}):\n{log}")
            os.replace(lib_tmp, out)
    return out


def compiler_version(cxx: str = CXX) -> str:
    """The first line of ``cxx --version``."""
    return subprocess.run([cxx, "--version"], capture_output=True, text=True,
                          check=True).stdout.splitlines()[0]


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use, every signature set."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = handle
    return _lib


def crc32(data, value: int = 0) -> int:
    return int(lib().compu_crc32(bytes(data), len(data), value & 0xFFFFFFFF))


def adler32(data, value: int = 1) -> int:
    return int(lib().compu_adler32(bytes(data), len(data), value & 0xFFFFFFFF))


def xxh64(data, seed: int = 0) -> int:
    return int(lib().compu_xxh64(bytes(data), len(data), seed))


def find_matches_k(data, max_dist, K, depth, nice, deflate_heuristics, hash_bits):
    """The pareto-candidate chain matcher: (lens_k, dists_k) int64 (n, K)
    arrays, equal to ``deflate_encode.find_matches_k_py``'s."""
    n = len(data)
    lens_k = np.zeros((n, K), dtype=np.int64)
    dists_k = np.zeros((n, K), dtype=np.int64)
    lib().compu_find_matches_k(
        bytes(data), n, max_dist, K, depth, nice, 1 if deflate_heuristics else 0, hash_bits,
        lens_k.ctypes.data, dists_k.ctypes.data)
    return lens_k, dists_k


def find_matches(data, max_dist, depth, nice, hash_bits, patience, hash6_depth, filtered):
    """The best-match chain walk: (lens, dists) int64 arrays, equal to
    ``deflate_encode.find_matches_py``'s."""
    n = len(data)
    lens = np.zeros(n, dtype=np.int64)
    dists = np.zeros(n, dtype=np.int64)
    lib().compu_find_matches(
        bytes(data), n, max_dist, depth, nice, hash_bits, patience, hash6_depth,
        1 if filtered else 0, lens.ctypes.data, dists.ctypes.data)
    return lens, dists


def greedy_cover(nxt) -> np.ndarray:
    """The token starts of the path 0 -> nxt[0] -> ... -> n, equal to
    ``deflate_encode.greedy_cover_py``'s."""
    nxt64 = np.ascontiguousarray(nxt, dtype=np.int64)
    out = np.empty(len(nxt64), dtype=np.int64)
    t = lib().compu_greedy_cover(nxt64.ctypes.data, len(nxt64), out.ctypes.data)
    return out[:t]


def optimal_parse(data, lens, dists, litcost, lcost, dcost, cands):
    """One round of the squeeze DP (the backward cost recurrence and the
    cover it picks): (tok_pos, tok_len, tok_dist) int64 arrays, len 0 a
    literal, equal to ``deflate_encode._squeeze_py``'s."""
    n = len(data)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    dists64 = np.ascontiguousarray(dists, dtype=np.int64)
    litc = np.ascontiguousarray(litcost, dtype=np.float64)
    lc = np.ascontiguousarray(lcost, dtype=np.float64)
    dc = np.ascontiguousarray(dcost, dtype=np.float64)
    cands32 = np.ascontiguousarray(cands, dtype=np.int32)
    if litc.size != 256 or lc.size != 256 or dc.size != n:
        raise ValueError("optimal_parse: litcost and lcost take 256 entries, dcost one a byte")
    tp = np.empty(n, dtype=np.int32)
    tl = np.empty(n, dtype=np.int32)
    td = np.empty(n, dtype=np.int32)
    t = lib().compu_optimal_parse(
        bytes(data), n, lens64.ctypes.data, dists64.ctypes.data,
        litc.ctypes.data, lc.ctypes.data, dc.ctypes.data, cands32.ctypes.data, len(cands32),
        tp.ctypes.data, tl.ctypes.data, td.ctypes.data)
    if t < 0:
        raise MemoryError("compu_optimal_parse could not allocate its tables")
    return tp[:t].astype(np.int64), tl[:t].astype(np.int64), td[:t].astype(np.int64)
