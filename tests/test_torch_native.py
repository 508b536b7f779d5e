"""The port's host runtime (``compu_tpu_torch/runtime/native.py``): how it
is built and loaded, and every helper it gives against its Python twin and
against the reference's function, on inputs made from a numpy seed. Every
comparison is exact.

The build lands in ``compu_tpu_torch/_build/`` under a name that hashes
the sources and flags; processes that reach it together build it once;
a compiler that fails raises with its output and nothing falls back.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import zlib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch.formats.brotli import encode as benc  # noqa: E402
from compu_tpu_torch.formats.deflate import deflate_encode as de  # noqa: E402
from compu_tpu_torch.formats.deflate.options import ZlibStrategy  # noqa: E402
from compu_tpu_torch.formats.zstd import encode as zenc  # noqa: E402
from compu_tpu_torch.formats.zstd import huff as zhuff  # noqa: E402
from compu_tpu_torch.formats.zstd import native_enc as znative  # noqa: E402
from compu_tpu_torch.formats.zstd import tables as T  # noqa: E402
from compu_tpu_torch.ops import checksum, xxhash  # noqa: E402
from compu_tpu_torch.runtime import native  # noqa: E402

ALICE = (ROOT / "tests" / "data" / "alice29.txt").read_bytes()


def corpus(n: int, seed: int) -> np.ndarray:
    """``n`` bytes from a numpy seed: runs of text cut from alice29 at
    random offsets, runs of one byte, repeats of earlier bytes at random
    distances and stretches of noise."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        kind = int(rng.integers(0, 4))
        k = int(rng.integers(8, 600))
        if kind == 0:
            at = int(rng.integers(0, len(ALICE) - k))
            out += ALICE[at:at + k]
        elif kind == 1:
            out += bytes([int(rng.integers(0, 256))]) * k
        elif kind == 2 and len(out) > 16:
            d = int(rng.integers(1, min(len(out), 40_000) + 1))
            for _ in range(k):
                out.append(out[-d])
        else:
            out += rng.integers(0, 256, k // 4, dtype=np.uint8).tobytes()
    return np.frombuffer(bytes(out[:n]), dtype=np.uint8)


# -- the build ----------------------------------------------------------------
def mapped_path(line: str) -> str:
    """The pathname of one ``/proc/<pid>/maps`` line: the text from its
    sixth field on (a path may hold spaces), less the ` (deleted)` that the
    kernel appends when the mapped file has been replaced or removed."""
    fields = line.split(maxsplit=5)
    return fields[5].removesuffix(" (deleted)") if len(fields) == 6 else ""


@pytest.mark.parametrize("line, path", [
    ("7f1c2a000000-7f1c2a010000 r-xp 00000000 08:01 1234  /a/b/libcompu_runtime_0f.so",
     "/a/b/libcompu_runtime_0f.so"),
    ("7f1c2a000000-7f1c2a010000 r--p 00010000 08:01 1234  /a/csrc/libcompu_runtime.so (deleted)",
     "/a/csrc/libcompu_runtime.so"),
    ("7f1c2a000000-7f1c2a010000 rw-p 00000000 08:01 99 /my dir/x y/libcompu_runtime.so",
     "/my dir/x y/libcompu_runtime.so"),
    ("7f1c2a000000-7f1c2a010000 rw-p 00000000 08:01 99 /my dir/libcompu_runtime.so (deleted)",
     "/my dir/libcompu_runtime.so"),
    ("7ffd5c1e0000-7ffd5c201000 rw-p 00000000 00:00 0                          [stack]",
     "[stack]"),
    ("7f1c2a000000-7f1c2a010000 rw-p 00000000 00:00 0 ", ""),
])
def test_mapped_path_reads_the_whole_pathname(line, path):
    assert mapped_path(line) == path


def test_library_builds_from_the_port_into_its_build_dir():
    """Ten sources under the port's runtime/csrc, the library under the
    port's _build with a name that hashes them, loaded from there."""
    srcs = native.sources()
    assert [s.name for s in srcs] == sorted(p.name for p in (ROOT / "csrc").glob("*.cpp"))
    assert len(srcs) == 10
    assert all(s.parent == ROOT / "compu_tpu_torch" / "runtime" / "csrc" for s in srcs)
    path = native.build()
    assert path.parent == ROOT / "compu_tpu_torch" / "_build"
    assert path == native.library_path() and path.name.startswith("libcompu_runtime_")
    native.lib()
    maps = pathlib.Path("/proc/self/maps")
    if maps.exists():
        loaded = {mapped_path(line) for line in maps.read_text().splitlines()
                  if "libcompu_runtime" in line}
        assert loaded <= {str(path), str(ROOT / "csrc" / "libcompu_runtime.so")}
        assert str(path) in loaded


def test_library_name_follows_the_sources(tmp_path):
    """An edited source gives another library name; an unchanged one the
    same name: no modification time is compared."""
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    a = native.library_path([src], build_dir=tmp_path)
    os.utime(src, (1, 1))
    assert native.library_path([src], build_dir=tmp_path) == a
    src.write_text('extern "C" int f() { return 2; }\n')
    assert native.library_path([src], build_dir=tmp_path) != a
    assert native.library_path([src], cxx="c++", build_dir=tmp_path) != native.library_path(
        [src], build_dir=tmp_path)


@pytest.mark.parametrize("fault", ["compiler_exits_1", "source_does_not_compile",
                                   "compiler_missing"])
def test_failed_build_raises(tmp_path, fault):
    """A compiler that exits non-zero, a source g++ refuses, or no compiler
    at all: the build raises with the compiler's output, and leaves no
    library behind."""
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    cxx = native.CXX
    if fault == "compiler_exits_1":
        fake = tmp_path / "fake-cxx"
        fake.write_text("#!/bin/sh\necho 'fake compiler refuses' >&2\nexit 1\n")
        fake.chmod(0o755)
        cxx, want = str(fake), "fake compiler refuses"
    elif fault == "source_does_not_compile":
        src.write_text('extern "C" int f() { return not_declared; }\n')
        want = "not_declared"
    else:
        cxx, want = str(tmp_path / "no-such-compiler"), "cannot be built"
    with pytest.raises(RuntimeError, match=want):
        native.build([src], cxx=cxx, build_dir=tmp_path / "b")
    assert not list((tmp_path / "b").glob("*.so"))


def test_concurrent_first_builds_make_one_library(tmp_path):
    """Four processes reach an empty build directory at once: every one
    loads the same library, built once, with no temporary left over."""
    src = ROOT / "compu_tpu_torch" / "runtime" / "csrc" / "compu_parse.cpp"
    build_dir = tmp_path / "b"
    code = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(ROOT)!r})
        from compu_tpu_torch.runtime import native
        path = native.build([{str(src)!r}], build_dir={str(build_dir)!r})
        ctypes.CDLL(str(path)).compu_optimal_parse
        print(path)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in build_dir.iterdir() if not p.name.endswith(".lock")] == [
        pathlib.Path(paths.pop()).name]


def test_import_builds_nothing(tmp_path):
    """Importing every module of the runtime and the host backends starts no
    compiler: the build runs at the first call."""
    code = textwrap.dedent(f"""
        import subprocess, sys
        sys.path.insert(0, {str(ROOT)!r})
        calls = []
        real = subprocess.Popen
        subprocess.Popen = lambda *a, **k: calls.append(a) or real(*a, **k)
        import compu_tpu_torch.runtime.native as native
        import compu_tpu_torch.formats.deflate.pipeline, compu_tpu_torch.formats.zstd.pipeline
        import compu_tpu_torch.formats.brotli.pipeline
        import compu_tpu_torch.formats.deflate.native_inflate
        import compu_tpu_torch.formats.zstd.native_decode, compu_tpu_torch.formats.brotli.native_decode
        assert native._lib is None and not calls, calls
        print("lazy-ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "lazy-ok" in proc.stdout


# -- checksums ------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 7, 4095, 16_384, 100_003])
def test_checksums_equal_their_twins(n):
    from compu_tpu.ops import checksum as ref_checksum
    from compu_tpu.ops import xxhash as ref_xxhash

    data = corpus(n, n).tobytes() if n else b""
    for value in (0, 1, 0x12345678):
        want = zlib.crc32(data, value)
        assert checksum.crc32(data, value) == native.crc32(data, value) == want
        assert checksum.crc32_lanes(data, value) == ref_checksum.crc32_lanes(data, value) == want
        want = zlib.adler32(data, value or 1)
        assert checksum.adler32(data, value or 1) == want
        assert checksum.adler32_lanes(data, value or 1) == ref_checksum.adler32_lanes(
            data, value or 1) == want
    for seed in (0, 1, 2 ** 64 - 1):
        want = ref_xxhash.xxh64_py(data, seed)
        assert xxhash.xxh64(data, seed) == xxhash.xxh64_py(data, seed) == want


# -- the DEFLATE encoder's helpers ------------------------------------------------
MATCH_CASES = [
    # (level, strategy, max_dist, depth, hash_bits, patience, hash6_depth)
    (1, ZlibStrategy.Default, 32768, 0, 16, 0, 0),
    (6, ZlibStrategy.Default, 32768, 0, 16, 0, 0),
    (6, ZlibStrategy.Default, 32768, 0, 12, 0, 0),
    (9, ZlibStrategy.Filtered, 32768, 0, 16, 0, 0),
    (9, ZlibStrategy.Default, 1 << 20, 32, 16, 24, 64),
]


@pytest.mark.parametrize("case", MATCH_CASES, ids=lambda c: f"L{c[0]}-{c[1].name}-d{c[3]}-p{c[5]}")
def test_find_matches_equals_twin_and_reference(case):
    from compu_tpu.formats.deflate import deflate_encode as ref_de
    from compu_tpu.formats.deflate.options import ZlibStrategy as RefStrategy

    level, strategy, max_dist, depth, hash_bits, patience, h6 = case
    data = corpus(60_000, level + patience)
    kw = dict(depth=depth, hash_bits=hash_bits, patience=patience, hash6_depth=h6)
    got = de.find_matches(data, level, strategy, max_dist, **kw)
    twin = de.find_matches_py(data, level, strategy, max_dist, **kw)
    ref = ref_de.find_matches(data, level, RefStrategy(strategy.value), max_dist, **kw)
    for a, b, c in zip(got, twin, ref):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert int((got[0] > 0).sum()) > 1000


@pytest.mark.parametrize("K,heur", [(3, True), (4, False)])
def test_find_matches_k_equals_twin_and_reference(K, heur):
    from compu_tpu.formats.deflate import deflate_encode as ref_de

    data = corpus(40_000, K)
    got = de.find_matches_k(data, 9, 1 << 17, K=K, depth=24, deflate_heuristics=heur)
    twin = de.find_matches_k_py(data, 9, 1 << 17, K=K, depth=24, deflate_heuristics=heur)
    ref = ref_de.find_matches_k(data, 9, 1 << 17, K=K, depth=24, deflate_heuristics=heur)
    for a, b, c in zip(got, twin, ref):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_greedy_cover_and_squeeze_equal_their_twins():
    """The cover of the path and the optimal parse's DP: the host runtime,
    the twin and the reference give the same tokens; level 9's tokenize
    (two squeeze rounds) equals the reference's."""
    from compu_tpu.formats.deflate import deflate_encode as ref_de
    from compu_tpu.formats.deflate.options import ZlibStrategy as RefStrategy

    data = corpus(20_000, 9)
    lens, dists = de.find_matches(data, 9, ZlibStrategy.Default)
    take = lens >= 3
    nxt = np.arange(len(data)) + np.where(take, lens, 1)
    assert np.array_equal(de.greedy_cover(nxt), de.greedy_cover_py(nxt))
    assert np.array_equal(de.greedy_cover(nxt), ref_de.greedy_cover(nxt))
    got = de._optimal_parse(data, lens, dists)
    twin = de._optimal_parse(data, lens, dists, squeeze=de._squeeze_py)
    ref = ref_de.tokenize(data, 9, RefStrategy.Default)
    for a, b, c in zip(got, twin, ref):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert np.array_equal(de.tokenize(data, 9, ZlibStrategy.Default)[0], got[0])


# -- the zstd encoder's helpers ----------------------------------------------------
def _zstd_block_inputs(seed: int):
    """A block's token cover (lazy level 6 parse, 128 KiB window) and its
    literals and sequences, from the twins."""
    data = corpus(90_000, seed)
    tok = de.tokenize(data, 6, ZlibStrategy.Default, max_dist=(1 << 17) - 1)
    lits, seqs = zenc._sequences_from_tokens_py(data, *tok)
    return data, tok, lits, seqs


@pytest.mark.parametrize("seed", [1, 2])
def test_zstd_sequence_helpers_equal_twins(seed):
    """``seq_from_tokens``, ``resolve_offsets`` and ``seq_bitstream``
    against ``_sequences_from_tokens_py``, ``_resolve_offset_values`` and
    ``_sequences_bitstream_py`` (and the reference's twins), and the
    section the encoder writes against the reference's."""
    from compu_tpu.formats.zstd import encode as ref_zenc

    data, tok, lits, seqs = _zstd_block_inputs(seed)
    assert len(tok[0]) > 512 and len(seqs) > 64
    nlits, nseqs = zenc._sequences_from_tokens(data, *tok)
    assert nlits == lits and np.array_equal(nseqs, np.asarray(seqs, dtype=np.int64))
    ref_lits, ref_seqs = ref_zenc._sequences_from_tokens(data, *tok)
    assert ref_lits == lits and np.array_equal(np.asarray(ref_seqs), nseqs)
    rep_in = [7, 3, 11] if seed == 2 else None
    sa = np.asarray(seqs, dtype=np.int64)
    of_values, rep_out = znative.resolve_offsets(sa[:, 0], sa[:, 1], rep_in)
    twin_values, twin_rep = zenc._resolve_offset_values(seqs, rep_in)
    assert of_values.tolist() == list(twin_values) and rep_out == list(twin_rep)

    ll_codes = [T.ll_code(ll) for ll, _, _ in seqs]
    ml_codes = [T.ml_code(ml) for _, _, ml in seqs]
    of_codes = [zenc._offset_code(v) for v in twin_values]
    tabs = [zenc._SeqTable(c, *args) for c, args in (
        (ll_codes, (T.LL_DEFAULT_DIST, T.LL_DEFAULT_LOG, T.MAX_LL_SYMBOL, T.MAX_LL_LOG)),
        (ml_codes, (T.ML_DEFAULT_DIST, T.ML_DEFAULT_LOG, T.MAX_ML_SYMBOL, T.MAX_ML_LOG)),
        (of_codes, (T.OF_DEFAULT_DIST, T.OF_DEFAULT_LOG, T.MAX_OF_SYMBOL, T.MAX_OF_LOG)))]
    ll_t, ml_t, of_t = tabs
    twin = zenc._sequences_bitstream_py(seqs, ll_codes, ml_codes, of_codes, twin_values,
                                        ll_t, ml_t, of_t)
    llc, mlc, ofc = (np.asarray(c) for c in (ll_codes, ml_codes, of_codes))
    got = znative.seq_bitstream(
        llc, mlc, ofc, sa[:, 0] - T.LL_BASE[llc], T.LL_BITS[llc],
        sa[:, 2] - T.ML_BASE[mlc], T.ML_BITS[mlc], of_values - (1 << ofc), ofc,
        ll_t.enc, ml_t.enc, of_t.enc)
    assert got == twin
    reuse = {"rep": rep_in} if rep_in else {}
    section = zenc._sequences_section(nseqs, dict(reuse))
    assert section == zenc._sequences_section(seqs, dict(reuse))
    assert section == ref_zenc._sequences_section(seqs, dict(reuse))


@pytest.mark.parametrize("n", [65, 1000, 40_000])
def test_zstd_huffman_helpers_equal_twins(n):
    """``huf_stream`` and ``fse_pair_stream`` against
    ``HufEncoder.encode_stream_py`` and ``fse_pair_stream_py``, and the
    literal sections against the reference's."""
    from compu_tpu.formats.zstd import encode as ref_zenc

    data = corpus(n, n).tobytes()
    enc = zhuff.HufEncoder(np.bincount(np.frombuffer(data, np.uint8), minlength=256))
    assert enc.encode_stream(data) == enc.encode_stream_py(data)
    assert znative.huf_stream(data, enc.code, enc.nbits) == enc.encode_stream_py(data)
    weights = [int(w) for w in np.random.default_rng(n).integers(0, 7, 60)]
    freqs = np.bincount(np.asarray(weights), minlength=2)
    norm, log = zhuff.normalize_counts(freqs, len(weights), 6)
    fse = zhuff.FseEncodeTable(norm, log)
    assert znative.fse_pair_stream(weights, fse) == zhuff.fse_pair_stream_py(weights, fse)
    assert znative.fse_pair_stream(weights[:1], fse) is zhuff.fse_pair_stream_py(weights[:1], fse)
    from compu_tpu.formats.zstd import huff as ref_huff

    freqs = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    assert enc.describe() == ref_huff.HufEncoder(freqs).describe()
    assert zenc._literals_section(data) == ref_zenc._literals_section(data)


def test_zstd_optimal_parse_and_promote_rep_drop_in(monkeypatch):
    """The host route's parse helpers, whose callers come later: with the
    port's ``optimal_parse``, ``promote_rep``, ``resolve_offsets`` and
    ``seq_from_tokens`` in place of the reference's, the reference's
    optimal parse gives the tokens its Python twins give."""
    from compu_tpu.formats.zstd import encode as ref_zenc
    from compu_tpu.formats.zstd import native_enc as ref_native_enc
    from compu_tpu.runtime import native as ref_native

    full = corpus(14_000, 5)
    ref_zenc._zstd_optimal_tokens(full, 0, 19, 1 << 17)  # the reference's library is built
    for name in ("optimal_parse", "promote_rep", "resolve_offsets", "seq_from_tokens"):
        monkeypatch.setattr(ref_native_enc, name, getattr(znative, name))
    hist = 3000
    got = ref_zenc._zstd_optimal_tokens(full, hist, 19, 1 << 17, rep_in=[5, 9, 2])
    lits, seqs = ref_zenc._sequences_from_tokens(full[hist:], *got)
    promoted = znative.promote_rep(full.tobytes(), hist, seqs, [5, 9, 2])
    monkeypatch.setattr(ref_native, "_load", lambda: None)
    twin = ref_zenc._zstd_optimal_tokens(full, hist, 19, 1 << 17, rep_in=[5, 9, 2])
    for a, b in zip(got, twin):
        assert np.array_equal(a, b)
    assert len(seqs) > 64
    assert np.array_equal(promoted, np.asarray(
        ref_zenc._promote_rep_offsets(full, hist, [tuple(s) for s in seqs], [5, 9, 2])))


# -- the brotli encoder's helpers ----------------------------------------------------
@pytest.mark.parametrize("ctx", [False, True])
def test_brotli_helpers_equal_twins(ctx):
    """``commands_from_tokens``, ``plan_distances`` and ``emit_commands``
    against ``_commands_from_tokens_py``, ``_distance_plan_py`` and
    ``_emit_body_py`` on one meta-block's tokens (with and without the
    literal context model), the bits after a carried partial byte."""
    data = corpus(80_000, 7 + ctx).tobytes()
    arr = np.frombuffer(data, np.uint8)
    tok = de.tokenize(arr, 6, ZlibStrategy.Default, max_dist=(1 << 20) - 16)
    assert len(tok[0]) > benc.NATIVE_MIN_TOKENS
    commands = benc._commands_from_tokens(*tok)
    twin = benc._commands_from_tokens_py(*tok)
    assert all(np.array_equal(a, b) for a, b in zip(commands, twin))
    ring = [4, 11, 15, 16]
    plan_n = benc._plan_commands(*commands, ring, True)
    plan_p = benc._plan_commands(*commands, ring, False)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(plan_n, plan_p))
    *plan, cmd_freq, dist_freq, _ = plan_n
    start_a, ins_a = commands[:2]
    tot = int(ins_a.sum())
    cum = np.concatenate([[0], np.cumsum(ins_a)[:-1]])
    lit_pos = np.repeat(start_a, ins_a) + np.arange(tot) - np.repeat(cum, ins_a)
    tail = b"xy"
    cmap, lit_codes, cid_of_pos = benc._context_model(arr, lit_pos, arr[lit_pos],
                                                      enabled=ctx, tail=tail)
    assert (len(lit_codes) > 1) == ctx
    sinks = []
    for use_native in (True, False):
        sink = benc.BitSink()
        sink.push(0b101, 3)
        cmd_code, dist_code = benc._write_meta_block_header(sink, len(data), cmap, lit_codes,
                                                            cmd_freq, dist_freq)
        benc._emit_body(sink, data, tail, commands, plan, cmd_code, dist_code, lit_codes, cmap,
                        cid_of_pos, use_native)
        sinks.append((bytes(sink.out), sink.acc, sink.nbits))
    assert sinks[0] == sinks[1]
    d = np.asarray(plan_n[3])
    assert (d == -1).any() and (d >= 16).any() and ((d >= 0) & (d < 16)).any()


def test_brotli_distance_plan_refuses_what_it_cannot_code():
    """A distance past 24 extra bits is refused by both plans."""
    from compu_tpu_torch.formats.base import CodecFailure

    commands = (np.array([0]), np.array([1]), np.array([4]), np.array([1 << 27]))
    for use_native in (True, False):
        with pytest.raises(CodecFailure):
            benc._plan_commands(*commands, [4, 11, 15, 16], use_native)
