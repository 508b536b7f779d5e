"""The port stands alone: it imports nothing of the JAX package, of JAX or
of ``bench``, and its copies of the reference's host pieces (the corpus
builder, the checksum algebra, the block index) give the reference's
values on the CPU.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from compu_tpu_torch.ops import checksum  # noqa: E402
from compu_tpu_torch.parallel.scheduler import BlockIndex  # noqa: E402
from compu_tpu_torch.utils.corpus import build_corpus  # noqa: E402

FORBIDDEN = ("compu_tpu", "jax", "jaxlib", "bench")


def test_port_and_smoke_imports_stand_alone(tmp_path):
    """Every module of compu_tpu_torch (``parallel/mesh.py`` and ``entry.py``
    among them), and chip_smoke's imports (the module without its main), in
    a fresh interpreter started outside the repository: none of the
    forbidden packages is loaded, and the imports start no process group,
    no child process and no CUDA context."""
    code = (
        "import importlib, multiprocessing, pkgutil, sys\n"
        "import torch\n"
        "import compu_tpu_torch\n"
        "for m in pkgutil.walk_packages(compu_tpu_torch.__path__, 'compu_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert {'compu_tpu_torch.parallel.mesh', 'compu_tpu_torch.entry'} <= set(sys.modules)\n"
        "assert not torch.distributed.is_initialized()\n"
        "assert not torch.cuda.is_initialized() and not multiprocessing.active_children()\n"
        "print('standalone-ok', len([m for m in sys.modules if m.startswith('compu_tpu_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone-ok" in proc.stdout


def test_port_decoder_runs_stand_alone(tmp_path):
    """Decoding a zstd frame through the port's decoder, with its literal
    sections on kernel P2's plain version, in a fresh interpreter: none of
    the forbidden packages is loaded."""
    code = (
        "import sys\n"
        "from compu_tpu_torch import decoder\n"
        "from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface\n"
        f"data = open({str(ROOT / 'tests' / 'data' / 'alice29.txt')!r}, 'rb').read()[:40000]\n"
        "frame = ByteVec()\n"
        "Interface.zstd(device='cpu').encode_vec_full(data, frame, EncodeOp.Finish)\n"
        "dec = decoder.Interface.zstd(device='cpu')\n"
        "out = ByteVec()\n"
        "res = dec.decode_vec_full(frame.data(), out)\n"
        "assert res.status is decoder.DecodeStatus.Finished and out.data() == data, res\n"
        "assert 'compu_tpu_torch.kernels.zstd_lit_decode' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('decode-standalone-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "decode-standalone-ok" in proc.stdout


def test_port_block_decoder_runs_stand_alone(tmp_path):
    """The block encode and the indexed inflate (``BlockParallelDecoder``
    on kernel P3's plain version) in a fresh interpreter: the stream
    decodes to its input and none of the forbidden packages is loaded."""
    code = (
        "import sys\n"
        "from compu_tpu_torch import BlockParallelDecoder, BlockParallelEncoder, ZlibMode\n"
        "from compu_tpu_torch import make_block_encode_fn\n"
        f"data = open({str(ROOT / 'tests' / 'data' / 'alice29.txt')!r}, 'rb').read()[:70000]\n"
        "fn = make_block_encode_fn(ZlibMode.Gzip, segment_index=True, device='cpu')\n"
        "stream, index = BlockParallelEncoder(fn, block_size=1 << 15).encode(data)\n"
        "out = BlockParallelDecoder(block_size=1 << 15, device='cpu').decode(stream, index)\n"
        "assert out == data\n"
        "assert 'compu_tpu_torch.kernels.inflate_scan' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('inflate-standalone-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "inflate-standalone-ok" in proc.stdout


def test_port_zlib_device_runs_stand_alone(tmp_path):
    """A stdlib gzip stream decoded by ``decoder.Interface.zlib_device`` on
    kernel P4's plain version, in a fresh interpreter: it gives its input
    and none of the forbidden packages is loaded."""
    code = (
        "import sys, zlib\n"
        "from compu_tpu_torch import ZlibMode, decoder\n"
        f"data = open({str(ROOT / 'tests' / 'data' / 'alice29.txt')!r}, 'rb').read()[:40000]\n"
        "blob = zlib.compress(data, 6, wbits=31)\n"
        "out = bytearray(len(data) + 16)\n"
        "res = decoder.Interface.zlib_device(ZlibMode.Auto, device='cpu').decode(blob, out)\n"
        "assert res.status is decoder.DecodeStatus.Finished, res\n"
        "assert bytes(out[:len(data)]) == data and res.output_remain == 16\n"
        "assert 'compu_tpu_torch.kernels.inflate_spec' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('zlib-device-standalone-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "zlib-device-standalone-ok" in proc.stdout


def test_port_brotli_runs_stand_alone(tmp_path):
    """A brotli stream through ``Interface.brotli(device="cpu")`` and back
    through ``decoder.Interface.brotli()``, and ``Detection`` and the
    stored format, in a fresh interpreter: the data come back and none of
    the forbidden packages is loaded."""
    code = (
        "import sys\n"
        "from compu_tpu_torch import Detection, decoder\n"
        "from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface\n"
        f"data = open({str(ROOT / 'tests' / 'data' / 'alice29.txt')!r}, 'rb').read()[:40000]\n"
        "for enc, dec in ((Interface.brotli(device='cpu'), decoder.Interface.brotli()),\n"
        "                 (Interface.stored(), decoder.Interface.stored())):\n"
        "    blob, out = ByteVec(), ByteVec()\n"
        "    enc.encode_vec_full(data, blob, EncodeOp.Finish)\n"
        "    res = dec.decode_vec_full(blob.data(), out)\n"
        "    assert res.status is decoder.DecodeStatus.Finished and out.data() == data, res\n"
        "    assert Detection.detect(blob.data()) is Detection.Unknown\n"
        "assert 'compu_tpu_torch.formats.device_lz' in sys.modules\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('brotli-standalone-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "brotli-standalone-ok" in proc.stdout


def test_corpus_equals_bench(monkeypatch):
    """The port's corpus is bench.build_corpus's, byte for byte; the
    reference reads its text from the working directory, the copy from the
    repository root."""
    monkeypatch.chdir(ROOT)
    import bench

    assert build_corpus(1 << 20) == bench.build_corpus(1 << 20)


def test_corpus_independent_of_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    corpus = build_corpus(1 << 16)
    assert len(corpus) == 1 << 16
    assert corpus[:100] == (ROOT / "tests" / "data" / "alice29.txt").read_bytes()[:100]


def _pairs(seed, count=8):
    """Seeded (value1, value2, length) triples, lengths from 0 to 2^24."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 255, 1 << 18, *rng.integers(0, 1 << 24, count - 4).tolist()]
    return [(int(a), int(b), int(n)) for a, b, n in
            zip(rng.integers(0, 1 << 32, count, dtype=np.uint64),
                rng.integers(0, 1 << 32, count, dtype=np.uint64), lens)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc32_combine_equals_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, b, n in _pairs(seed):
        assert checksum.crc32_combine(a, b, n) == ref.crc32_combine(a, b, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adler32_combine_equals_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, b, n in _pairs(seed):
        assert checksum.adler32_combine(a, b, n) == ref.adler32_combine(a, b, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crc_shift_unshift_equal_reference(seed):
    from compu_tpu.ops import checksum as ref

    for a, _, n in _pairs(seed):
        shifted = checksum.crc_shift(a, n)
        assert shifted == ref.crc_shift(a, n)
        assert checksum.crc_unshift(shifted, n) == ref.crc_unshift(shifted, n) == a


def test_checksum_tables_equal_reference():
    from compu_tpu.ops import checksum as ref

    assert checksum.ADLER_MOD == ref.ADLER_MOD
    assert np.array_equal(checksum.CRC_TABLE, ref.CRC_TABLE)
    for n in (1, 7, 1024):
        assert np.array_equal(checksum.zero_shift_operator(n), ref.zero_shift_operator(n))
    op = checksum.zero_shift_operator(3)
    assert np.array_equal(checksum._gf2_matmul(op, op), ref._gf2_matmul(op, op))


def test_combines_give_zlib_values():
    """Combining per-block checksums gives the stream's, as the framing
    relies on."""
    import zlib

    data = (ROOT / "tests" / "data" / "alice29.txt").read_bytes()[:50_000]
    a, b = data[:12_345], data[12_345:]
    assert checksum.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == zlib.crc32(data)
    assert checksum.adler32_combine(zlib.adler32(a), zlib.adler32(b),
                                    len(b)) == zlib.adler32(data)


@pytest.mark.parametrize("mode", ["zlib", "gzip", "deflate"])
def test_stream_header_equals_reference(mode):
    """The port's one header function gives the reference framing's header
    at every level; at level 6 it is also the reference scheduler's."""
    from compu_tpu.formats.deflate.options import ZlibMode as RefMode
    from compu_tpu.formats.deflate.options import ZlibOptions as RefOptions
    from compu_tpu.formats.deflate.pipeline import DeflateEncoder as RefEncoder
    from compu_tpu_torch.formats.deflate.options import ZlibMode, stream_header

    for level in range(10):
        ref = RefEncoder(RefOptions(mode=RefMode(mode), level=level))._header()
        assert stream_header(ZlibMode(mode), level) == ref


def test_block_index_bytes_equal_reference():
    from compu_tpu.parallel.scheduler import BlockIndex as RefIndex

    fields = ([1 << 18, 5], [2, 70_000], [69_998, 12])
    blob = BlockIndex(*fields).to_bytes()
    assert blob == RefIndex(*fields).to_bytes()
    back = BlockIndex.from_bytes(blob)
    assert (back.raw_lengths, back.compressed_offsets, back.compressed_lengths) == fields


def test_port_mesh_runs_stand_alone(tmp_path):
    """The multi-device dry run on one gloo rank and a v2 block stream, in
    a fresh interpreter: both check out and none of the forbidden packages
    is loaded."""
    code = (
        "import sys, zlib\n"
        "from compu_tpu_torch import BlockParallelEncoder, ZlibMode, make_block_encode_fn\n"
        "from compu_tpu_torch.entry import dryrun_multichip\n"
        "dryrun_multichip(1, device='cpu')\n"
        f"data = open({str(ROOT / 'tests' / 'data' / 'alice29.txt')!r}, 'rb').read()[:40000]\n"
        "fn = make_block_encode_fn(ZlibMode.Zlib, kernel='v2', device='cpu')\n"
        "stream, _ = BlockParallelEncoder(fn, block_size=1 << 14, mode=ZlibMode.Zlib).encode(data)\n"
        "assert zlib.decompress(stream) == data\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('mesh-standalone-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "mesh-standalone-ok" in proc.stdout


def test_port_runtime_builds_and_loads_only_its_own(tmp_path):
    """In a fresh interpreter the host backends run from the port's own
    runtime: every compile reads a source under
    ``compu_tpu_torch/runtime/csrc`` and writes under the build directory,
    (the port's ``_build``, or the directory the test names), and the one
    runtime library mapped into the process is the port's, under
    ``compu_tpu_torch/_build`` (never the root ``csrc``'s)."""
    code = (
        "import subprocess, sys, zlib\n"
        "cmds = []\n"
        "real = subprocess.Popen\n"
        "subprocess.Popen = lambda cmd, *a, **k: cmds.append(cmd) or real(cmd, *a, **k)\n"
        "from compu_tpu_torch import decoder\n"
        "from compu_tpu_torch.encoder import ByteVec, EncodeOp, Interface\n"
        "from compu_tpu_torch.runtime import native\n"
        f"native.build(build_dir={str(tmp_path / 'b')!r})\n"
        "data = b'standalone runtime ' * 4000\n"
        "for make in (Interface.zlib, Interface.zlib_native, Interface.zstd_native,\n"
        "             Interface.brotli_native):\n"
        "    vec = ByteVec(); make().encode_vec_full(data, vec, EncodeOp.Finish)\n"
        "    assert len(vec.data()) < len(data)\n"
        "out = ByteVec()\n"
        "decoder.Interface.zlib_native().decode_vec_full(zlib.compress(data), out)\n"
        "assert out.data() == data\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if 'libcompu_runtime' in l]\n"
        "print('MAPS', sorted(set(maps)))\n"
        "print('SRCS', sorted({a for c in cmds for a in c if a.endswith('.cpp')}))\n"
        "print('OUTS', sorted({c[c.index('-o') + 1] for c in cmds if '-o' in c}))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = {k: ast.literal_eval(v) for k, v in
             (line.split(" ", 1) for line in proc.stdout.splitlines())}
    maps = lines["MAPS"]
    assert len(maps) == 1
    assert pathlib.Path(maps[0]).parent == ROOT / "compu_tpu_torch" / "_build"
    srcs = [pathlib.Path(s) for s in lines["SRCS"]]
    assert len(srcs) == 10
    assert {s.parent for s in srcs} == {ROOT / "compu_tpu_torch" / "runtime" / "csrc"}
    dirs = (tmp_path / "b", ROOT / "compu_tpu_torch" / "_build")
    assert all(any(pathlib.Path(o).is_relative_to(d) for d in dirs) for o in lines["OUTS"])


#: The port's copies of the root csrc differ in comments alone: the
#: reference project's sources are named relative to it, without the
#: directory it was checked out in, and one comment names its test harness
#: "the partial-buffer tests".
CSRC_COMMENT_EDITS = ((re.compile(r"/[a-z]+/(?=reference/src/)"), ""),
                      (re.compile(r"(?<=the partial-buffer )[a-z]+ (?=tests pin)"), ""))


def test_port_runtime_sources_equal_the_root_csrc():
    """The port's ten C++ sources are the root ``csrc``'s, byte for byte but
    for ``CSRC_COMMENT_EDITS`` inside ``//`` comments (the test reads both;
    the package reads only its own)."""
    port = sorted((ROOT / "compu_tpu_torch" / "runtime" / "csrc").glob("*.cpp"))
    root = sorted((ROOT / "csrc").glob("*.cpp"))
    assert [p.name for p in port] == [p.name for p in root] and len(port) == 10
    edited = 0
    for a, b in zip(port, root):
        want = b.read_bytes().decode()
        got = a.read_bytes().decode()
        assert len(got.splitlines()) == len(want.splitlines()), a.name
        for line_got, line_want in zip(got.splitlines(True), want.splitlines(True)):
            if line_got == line_want:
                continue
            code = line_want[: line_want.index("//")]
            assert line_got[: len(code)] == code, (a.name, line_want)
            for pattern, new in CSRC_COMMENT_EDITS:
                line_want = pattern.sub(new, line_want)
            assert line_got == line_want, (a.name, line_got)
            edited += 1
    assert 0 < edited <= 16
    text = "".join(p.read_text() for p in (ROOT / "compu_tpu_torch").rglob("*.py"))
    assert "parent.parent.parent / \"csrc\"" not in text and "libcompu_runtime.so" not in text
