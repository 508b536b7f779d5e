"""The one traffic generator: a traffic file's parts, made from the seed.

A traffic file (``portbench/traffic/<name>.json``) gives the size of a
request, how many distinct inputs the pool holds, and the parts of each
input in order: each a ``kind`` with its ``weight`` and its parameters. A
part's share of the bytes is its weight over the sum of the weights; a
weight may be given as ``stands_for``, a table of the public corpus files
the part stands in for and their sizes in bytes, which then weigh it.
Every input of the pool has the same parts at the same sizes; the seed
and the input's place in the pool choose the bytes. All of it is made on
the host, in bulk, in NumPy. One client sends the pool's inputs in turn,
in a closed loop (``harness.closed_loop``); a traffic file has no key for
anything else, and :func:`check` refuses keys it does not know.

Kinds:

* ``text``: copies of a text file under ``portbench/`` (``source``), each
  with ``mutations_per_copy`` bytes replaced by printable ones, so no two
  copies are equal;
* ``records``: ``records`` JSON-like records with counters,
  ``{"id": 00001234, "name": "item-N", "flags": [1,2,3]}``, from an id the
  seed draws, repeated to fill the part;
* ``tokens``: byte strings from a vocabulary of ``vocabulary`` strings,
  each chosen by a Zipf law of exponent ``zipf`` over the vocabulary's
  ranks; the string of rank r has 1 + r mod ``max_len`` bytes, which the
  seed draws;
* ``image16``: a picture of ``width`` little-endian 16-bit samples a row,
  ``bits`` of them significant: a field of ``cell`` x ``cell`` tiles of
  one level each, plus Gaussian noise of ``sigma``;
* ``noise``: uniform random bytes;
* ``logs``: JSON log lines with the fields of the Elastic Common Schema
  (``@timestamp``, ``log.level``, ``service.name``, ``host.name``,
  ``trace.id``, ``http.*``, ``url.path``, ``event.duration``), the values
  drawn by the tables the part gives.
"""

from __future__ import annotations

import inspect
import pathlib

import numpy as np

PKG = pathlib.Path(__file__).resolve().parent

#: The keys a traffic file may have.
TRAFFIC_KEYS = {"request_bytes", "pool", "why", "source", "assumed", "parts"}


def _text(rng, size: int, source: str, mutations_per_copy: int) -> np.ndarray:
    text = np.frombuffer((PKG / source).read_bytes(), np.uint8)
    copies = -(-size // len(text))
    out = np.tile(text, copies)
    at = (rng.integers(0, len(text), (copies, mutations_per_copy))
          + (np.arange(copies) * len(text))[:, None])
    out[at.reshape(-1)] = rng.integers(32, 127, at.size, dtype=np.uint8)
    return out[:size]


def _records(rng, size: int, records: int) -> np.ndarray:
    start = int(rng.integers(0, 10 ** 7))
    block = b"".join(b'{"id": %08d, "name": "item-%d", "flags": [1,2,3]}\n' % (i, i % 977)
                     for i in range(start, start + records))
    return np.tile(np.frombuffer(block, np.uint8), -(-size // len(block)))[:size]


def _tokens(rng, size: int, vocabulary: int, max_len: int, zipf: float) -> np.ndarray:
    lens = 1 + np.arange(vocabulary) % max_len  # by rank: the same for every seed
    words = rng.integers(0, 256, (vocabulary, max_len), dtype=np.uint8)
    n = size // 2 + 64  # fewer draws than bytes: every string is a byte or more
    while True:
        pick = np.minimum(rng.zipf(zipf, n), vocabulary) - 1
        mask = np.arange(max_len) < lens[pick][:, None]
        out = words[pick][mask]
        if len(out) >= size:
            return out[:size]
        n *= 2


def _image16(rng, size: int, width: int, bits: int, cell: int, sigma: float) -> np.ndarray:
    rows = -(-size // (2 * width))
    levels = rng.integers(0, 1 << bits, (-(-rows // cell), -(-width // cell)))
    field = np.repeat(np.repeat(levels, cell, 0), cell, 1)[:rows, :width]
    pix = np.clip(np.rint(field + rng.normal(0.0, sigma, (rows, width))), 0, (1 << bits) - 1)
    return pix.astype("<u2").view(np.uint8).reshape(-1)[:size]


def _noise(rng, size: int) -> np.ndarray:
    return rng.integers(0, 256, size, dtype=np.uint8)


# Columns of text, for the log lines: each a (rows, width) uint8 matrix and
# the bytes each row uses from its left.

def _const(n: int, s: bytes):
    return np.broadcast_to(np.frombuffer(s, np.uint8), (n, len(s))), np.full(n, len(s))


def _table(values, pick):
    vals = [str(v).encode() for v in values]
    mat = np.zeros((len(vals), max(map(len, vals))), np.uint8)
    for i, v in enumerate(vals):
        mat[i, :len(v)] = np.frombuffer(v, np.uint8)
    return mat[pick], np.asarray([len(v) for v in vals])[pick]


def _decimal(x):
    x = np.asarray(x, np.int64)
    w = len(str(int(x.max()))) if x.size else 1
    nd = 1 + sum((x >= 10 ** k).astype(np.int64) for k in range(1, w))
    p = nd[:, None] - 1 - np.arange(w)
    digits = (x[:, None] // 10 ** np.maximum(p, 0)) % 10
    return (48 + digits).astype(np.uint8), nd


def _hex(x, width: int):
    x = np.asarray(x, np.uint64)
    shift = (4 * (width - 1 - np.arange(width))).astype(np.uint64)
    nib = (x[:, None] >> shift) & np.uint64(15)
    return np.frombuffer(b"0123456789abcdef", np.uint8)[nib.astype(np.int64)], np.full(len(x),
                                                                                       width)


def _join(columns) -> bytes:
    """Each row's columns one after another, the rows one after another."""
    lens = np.stack([c[1] for c in columns], 1).astype(np.int64)
    ends = np.cumsum(lens.reshape(-1)).reshape(lens.shape)
    out = np.empty(int(ends[-1, -1]) if lens.size else 0, np.uint8)
    for j, (mat, ln) in enumerate(columns):
        mask = np.arange(mat.shape[1]) < ln[:, None]
        out[((ends[:, j] - ln)[:, None] + np.arange(mat.shape[1]))[mask]] = mat[mask]
    return out.tobytes()


def _weighted(rng, table: dict, n: int):
    keys = list(table)
    p = np.asarray([table[k] for k in keys], np.float64)
    return keys, rng.choice(len(keys), n, p=p / p.sum())


def _logs(rng, size: int, services: list, hosts: int, levels: dict, methods: dict,
          resources: list, statuses: dict) -> np.ndarray:
    out, have = [], 0
    t = np.int64(1_700_000_000_000) + rng.integers(0, 10 ** 10)
    while have < size:
        n = (size - have) // 300 + 1024  # lines run 300-450 bytes
        t = t + np.cumsum(rng.geometric(0.2, n))
        stamp = np.datetime_as_string(t.astype("datetime64[ms]"), unit="ms").astype("S23")
        t = t[-1]
        lv_keys, lv = _weighted(rng, levels, n)
        me_keys, me = _weighted(rng, methods, n)
        st_keys, st = _weighted(rng, statuses, n)
        path = [_const(n, b"/v1/"), _table(resources, rng.integers(0, len(resources), n)),
                _const(n, b"/"), _decimal(rng.integers(0, 100000, n))]
        cols = [_const(n, b'{"@timestamp":"'),
                (stamp.view(np.uint8).reshape(n, 23), np.full(n, 23)),
                _const(n, b'Z","log.level":"'), _table(lv_keys, lv),
                _const(n, b'","message":"'), _table(me_keys, me), _const(n, b" "), *path,
                _const(n, b" "), _table(st_keys, st),
                _const(n, b'","ecs.version":"8.11.0","service.name":"'),
                _table(services, rng.integers(0, len(services), n)),
                _const(n, b'","host.name":"node-'), _hex(rng.integers(0, hosts, n), 4),
                _const(n, b'","trace.id":"'),
                _hex(rng.integers(0, 1 << 64, n, dtype=np.uint64), 16),
                _hex(rng.integers(0, 1 << 64, n, dtype=np.uint64), 16),
                _const(n, b'","user.id":"'), _decimal(rng.integers(0, 10 ** 8, n)),
                _const(n, b'","http.request.method":"'), _table(me_keys, me),
                _const(n, b'","url.path":"'), *path,
                _const(n, b'","http.response.status_code":'), _table(st_keys, st),
                _const(n, b',"http.response.body.bytes":'),
                _decimal(rng.integers(100, 50000, n)),
                _const(n, b',"event.duration":'),
                _decimal(1000 * rng.geometric(1 / 40000, n)), _const(n, b"}\n")]
        chunk = _join(cols)
        out.append(chunk)
        have += len(chunk)
    return np.frombuffer(b"".join(out), np.uint8)[:size]


KINDS = {"text": _text, "records": _records, "tokens": _tokens, "image16": _image16,
         "noise": _noise, "logs": _logs}


def _args(part: dict) -> dict:
    return {k: v for k, v in part.items() if k not in ("kind", "weight", "stands_for")}


def check(traffic: dict) -> None:
    """Raise on a key, a kind or a part's parameter this generator does not
    implement, or a part with no weight or with two."""
    unknown = set(traffic) - TRAFFIC_KEYS
    if unknown:
        raise ValueError(f"traffic keys the generator does not implement: {sorted(unknown)}")
    for part in traffic["parts"]:
        fn = KINDS[part["kind"]]
        want = set(inspect.signature(fn).parameters) - {"rng", "size"}
        if set(_args(part)) != want:
            raise ValueError(f"{part['kind']} takes {sorted(want)}, got {sorted(_args(part))}")
        if ("weight" in part) == ("stands_for" in part):
            raise ValueError(f"a {part['kind']} part needs a weight or stands_for, not both")


def shares(traffic: dict) -> list[float]:
    """Each part's share of an input's bytes."""
    w = [float(p["weight"]) if "weight" in p else float(sum(p["stands_for"].values()))
         for p in traffic["parts"]]
    return [x / sum(w) for x in w]


def make_input(traffic: dict, seed: int, k: int) -> bytes:
    """Input ``k`` of the pool: the traffic's parts in order, each at its
    share of ``request_bytes`` (the last takes what is left)."""
    rng = np.random.default_rng([seed % (1 << 64), k])  # any whole seed
    total = int(traffic["request_bytes"])
    parts, left = [], total
    for j, (part, share) in enumerate(zip(traffic["parts"], shares(traffic))):
        size = left if j == len(traffic["parts"]) - 1 else int(round(share * total))
        size = min(size, left)
        parts.append(KINDS[part["kind"]](rng, size, **_args(part)))
        left -= size
    out = np.concatenate(parts).tobytes()
    if len(out) != total:
        raise ValueError(f"traffic parts made {len(out)} bytes, not {total}")
    return out


def make_pool(traffic: dict, seed: int) -> list[bytes]:
    """The ``pool`` distinct inputs a cell sends in turn."""
    return [make_input(traffic, seed, k) for k in range(int(traffic["pool"]))]
