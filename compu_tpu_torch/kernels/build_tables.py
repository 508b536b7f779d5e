"""Per-block table stage of the v3 DEFLATE encode: the canonical Huffman
trees, the code-length tree of the header, the block-type choice and the
header fields.

Port of ``compu_tpu/kernels/deflate_jax_v3.py``'s ``build_lengths``,
``canonical_codes`` and ``_build_tables``, which the reference runs under
``jax.vmap`` inside its jitted encode: blocks are a leading dimension here.

``build_tables`` dispatches by device: kernel P5 (``csrc/build_tables.cu``,
one launch a batch, one CUDA block a DEFLATE block) for CUDA tensors, the
plain version ``build_tables_torch`` for CPU tensors. The wrapper makes no
torch op before the launch: the kernel seeds the histograms itself and
takes no logarithm. Three tables, each computed once a device with the
plain version's own torch ops so that they round as it does there, stand
in for its logarithms (``tables.on_device``): the lit/len and distance
trees' start-length thresholds (``"start_thresholds"``), the code-length
tree's start lengths (``"cl_start_len"``) and the flat tree's depth
(``"flat_k"``).
"""

from __future__ import annotations

import torch

from . import tables
from .tables import NDIST, NLIT, on_device

CAPBITS = 12   # max lit/len/dist code length (keeps every field in 4 bytes)
CLCAP = 7      # max code-length-code length (RFC limit)
NCL = 19       # code-length alphabet
NLENS = NLIT + NDIST           # the lengths the header sends, one CL symbol each
NHDR = 1 + NCL + NLENS         # header fields: first word, 19 CL lengths, 316 lengths
HDR_FIRST = 4 | (29 << 3) | (29 << 8) | (15 << 13)  # btype=10, HLIT HDIST HCLEN


def _log2_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` as the reference computes it: float32 log(x) / log(2),
    divided by a float32 tensor (a Python scalar divisor may become a
    multiply by its reciprocal, which rounds differently)."""
    return torch.log(x) / on_device("ln2_f32", x.device)


def _rev_bits(x: torch.Tensor, bits: torch.Tensor, maxbits: int = 15) -> torch.Tensor:
    """Reverse ``x`` within ``bits`` bits."""
    r = torch.zeros_like(x)
    for i in range(maxbits):
        r = r | (((x >> i) & 1) << (maxbits - 1 - i))
    return r >> (maxbits - bits)


# ---------------------------------------------------------------------------
# Canonical Huffman construction
# ---------------------------------------------------------------------------

def _exponents(p: torch.Tensor) -> torch.Tensor:
    """float32 ``ceil(-log2 max(p, 2^-30))``, elementwise."""
    return torch.ceil(-_log2_f32(torch.clamp(p, min=2.0 ** -30)))


def _start_exponents(freq: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """float32 ``ceil(-log2 max(freq / total, 2^-30))``, elementwise, with
    ``total`` broadcast against ``freq``."""
    return _exponents(freq.to(torch.float32) / torch.clamp(total.to(torch.float32), min=1.0))


def start_lengths(freq: torch.Tensor, cap: int) -> torch.Tensor:
    """The (B, A) int64 start lengths of :func:`build_lengths`: each used
    symbol's ``ceil(-log2 p)`` clamped to [1, cap], 0 for an unused one."""
    l0 = _start_exponents(freq, freq.to(torch.int64).sum(-1)[:, None])
    return torch.where(freq > 0, torch.clamp(l0, 1, cap).to(torch.int64), 0)


def _flat_depth(nused: torch.Tensor) -> torch.Tensor:
    """``ceil(log2 max(nused, 2))``: the depth of the flat complete tree."""
    return torch.ceil(_log2_f32(torch.clamp(nused.to(torch.float32), min=2.0))
                      ).to(torch.int64)


def length_loops(freq: torch.Tensor, cap: int, fill_iters: int = 64, fix_iters: int = 16,
                 count: bool = False):
    """:func:`build_lengths` without its fallback: the (B, A) int64 lengths
    after the lengthening and exact-fill loops, complete or not, and with
    ``count`` the (B,) number of steps that changed a length (else None).
    A step that changes nothing leaves every later step nothing to change,
    so these are the steps kernel P5 takes."""
    B, A = freq.shape
    rows = torch.arange(B, device=freq.device)
    freq = freq.to(torch.int64)
    used = freq > 0
    l = start_lengths(freq, cap)
    budget = 1 << cap
    steps = torch.zeros(B, dtype=torch.int64, device=freq.device) if count else None

    def units(l):
        return torch.where(used & (l > 0), budget >> torch.clamp(l, max=cap), 0)

    for _ in range(fix_iters):
        u = units(l)
        over = u.sum(-1) - budget
        score = torch.where(used & (l < cap) & (l > 0), u, -1)
        j = score.argmax(-1)
        l[rows, j] += (over > 0).to(torch.int64)
        if count:
            steps += over > 0

    freq_f = freq.to(torch.float32)
    for _ in range(fill_iters):
        u = units(l)
        slack = budget - u.sum(-1)
        fits = used & (l > 1) & (u <= slack[:, None]) & (u > 0)
        score = torch.where(fits, freq_f / torch.clamp(u, min=1).to(torch.float32),
                            -1.0)
        j = score.argmax(-1)
        do = (slack > 0) & (score[rows, j] > 0)
        l[rows, j] -= do.to(torch.int64)
        if count:
            steps += do
    return l, steps


def build_lengths(freq: torch.Tensor, cap: int, fill_iters: int = 64,
                  fix_iters: int = 16) -> torch.Tensor:
    """Code lengths (B, A) int64 forming a complete prefix code with all
    lengths <= cap, from (B, A) frequencies with >= 2 used symbols per row.
    ceil(-log2 p) start in float32, a bounded lengthening loop for Kraft
    overflow, a bounded exact-fill loop (:func:`length_loops`), and a flat
    complete tree as the fallback — each step as the reference takes it."""
    B, A = freq.shape
    dev = freq.device
    freq = freq.to(torch.int64)
    used = freq > 0
    nused = used.sum(-1)
    l, _ = length_loops(freq, cap, fill_iters, fix_iters)
    units = torch.where(used & (l > 0), (1 << cap) >> torch.clamp(l, max=cap), 0)
    ok = units.sum(-1) == 1 << cap
    k = _flat_depth(nused)
    n_short = (1 << k) - nused
    idx = torch.arange(A, device=dev)
    key = (torch.where(used, -freq, 1).to(torch.float32) * A
           + idx.to(torch.float32))
    order = torch.argsort(key, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, idx.expand(B, A))
    flat = torch.clamp(torch.where(rank < n_short[:, None], (k - 1)[:, None],
                                   k[:, None]), min=1)
    flat = torch.where(used, flat, 0)
    return torch.where(ok[:, None], l, flat)


def canonical_codes(lengths: torch.Tensor, maxbits: int = 15) -> torch.Tensor:
    """Bit-reversed canonical codes (B, A) int64 from (B, A) lengths
    (RFC1951 §3.2.2)."""
    B = lengths.shape[0]
    classes = torch.arange(1, maxbits + 1, device=lengths.device)
    lens1h = (lengths[:, :, None] == classes).to(torch.int64)  # (B, A, maxbits)
    bl_count = lens1h.sum(1)
    code = torch.zeros(B, dtype=torch.int64, device=lengths.device)
    first = []
    for m in range(maxbits):
        prev_count = bl_count[:, m - 1] if m else torch.zeros_like(code)
        code = (code + prev_count) << 1
        first.append(code)
    first = torch.stack(first, -1)
    rank = torch.cumsum(lens1h, 1) - lens1h
    codes = (lens1h * (first[:, None, :] + rank)).sum(-1)
    return _rev_bits(codes, torch.clamp(lengths, min=1), maxbits)


# The kernel's three tables, each computed once a device with the ops above.
THRESHOLD_CHUNK = 1 << 22  # floats evaluated at a time by the threshold build


def _start_threshold_table(device, exponents=_exponents) -> torch.Tensor:
    """(CAPBITS - 1,) float32: entry k - 1 holds ``t_k``, the least float32
    ``p <= 1`` at which ``exponents(p)`` (the plain version's
    :func:`_exponents`) is at most k, for k = 1..11. Every float32 of
    ``[2^-12, 1]`` is evaluated, THRESHOLD_CHUNK at a time, on ``device``;
    below 2^-12 the exponent exceeds 11 whatever the rounding. A used symbol's
    start length is then ``1 + #{k : p < t_k}``, as kernel P5 takes it.
    Raises unless the exponents over the range fall as ``p`` rises (a step
    function that does not increase): else no table reproduces them."""
    lo, hi = (int(torch.tensor(v, dtype=torch.float32).view(torch.int32))
              for v in (2.0 ** -12, 1.0))
    ks = -torch.arange(1, CAPBITS, dtype=torch.float32, device=device)
    above = torch.zeros(CAPBITS - 1, dtype=torch.int64, device=device)
    last = None
    for at in range(lo, hi + 1, THRESHOLD_CHUNK):
        p = torch.arange(at, min(at + THRESHOLD_CHUNK, hi + 1), dtype=torch.int32,
                         device=device).view(torch.float32)
        e = exponents(p)
        if not bool((e[1:] <= e[:-1]).all()) or (last is not None and bool(e[0] > last)):
            raise ValueError(f"the start exponents rise with p in [{float(p[0])!r}, "
                             f"{float(p[-1])!r}]: no threshold table reproduces them")
        above += torch.searchsorted(-e, ks)  # how many p of the chunk have an exponent > k
        last = e[-1]
    if int(above.max()) > hi - lo:
        raise ValueError("an exponent exceeds its k at p = 1: no threshold table")
    return (lo + above).to(torch.int32).view(torch.float32)


def _cl_start_table(device) -> torch.Tensor:
    """(2, NLENS + 2) int32: row t, column f holds the code-length tree's
    float32 ``ceil(-log2 p)`` of a symbol of frequency f when the tree's
    total is NLENS + t. The code-length histogram counts the 316 lengths,
    plus one when it is seeded, so its total is always 316 or 317."""
    freq = torch.arange(NLENS + 2, device=device).expand(2, -1)
    total = NLENS + torch.arange(2, device=device)[:, None]
    return _start_exponents(freq, total).to(torch.int32).contiguous()


def _flat_k_table(device) -> torch.Tensor:
    """(NLIT + 1,) int32: the flat tree's depth for nused = 0..NLIT."""
    return _flat_depth(torch.arange(NLIT + 1, device=device)).to(torch.int32)


tables.BUILT_ON_DEVICE.update(cl_start_len=_cl_start_table, flat_k=_flat_k_table,
                              start_thresholds=_start_threshold_table)


# ---------------------------------------------------------------------------
# The table stage
# ---------------------------------------------------------------------------

def seed_histograms(lit_freq: torch.Tensor, dist_freq: torch.Tensor):
    """New (B, 286) and (B, 30) histograms with >= 2 used symbols per tree:
    lit always has EOB, so symbol 0 is seeded; dist may be empty, so codes
    0 and 1 are."""
    lit_freq = lit_freq.clone()
    dist_freq = dist_freq.clone()
    lit_freq[:, 0] += ((lit_freq > 0).sum(-1) < 2).to(torch.int64)
    need = (dist_freq > 0).sum(-1) < 2
    dist_freq[:, 0] += (need & (dist_freq[:, 0] == 0)).to(torch.int64)
    dist_freq[:, 1] += ((dist_freq > 0).sum(-1) < 2).to(torch.int64)
    return lit_freq, dist_freq


def code_length_histogram(all_lens: torch.Tensor) -> torch.Tensor:
    """The (B, 19) code-length histogram of the (B, 316) lengths the header
    sends, seeded to two used symbols."""
    cl_freq = torch.zeros(all_lens.shape[0], NCL, dtype=torch.int64,
                          device=all_lens.device).scatter_add_(1, all_lens,
                                                               torch.ones_like(all_lens))
    cl_freq[:, 1] += ((cl_freq > 0).sum(-1) < 2).to(torch.int64)
    return cl_freq


def build_tables_torch(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns) -> dict:
    """Plain version: trees, header fields and the block-type choice, per
    block, from (B, 286) and (B, 30) int64 histograms and (B,) int64 extra
    bits and block lengths."""
    B = lit_freq.shape[0]
    dev = lit_freq.device
    fixed_lit, fixed_dist = on_device("fixed_lit", dev), on_device("fixed_dist", dev)
    lit_freq, dist_freq = seed_histograms(lit_freq, dist_freq)

    lit_len = build_lengths(lit_freq, CAPBITS)
    dist_len = build_lengths(dist_freq, CAPBITS)
    extra = extra_l_bits + extra_d_bits
    dyn_body = (lit_freq * lit_len).sum(-1) + (dist_freq * dist_len).sum(-1) + extra
    fix_body = (lit_freq * fixed_lit).sum(-1) + (dist_freq * fixed_dist).sum(-1) + extra

    # Header: the code-length tree over the 316 lengths (no run coding).
    all_lens = torch.cat([lit_len, dist_len], -1)
    cl_len = build_lengths(code_length_histogram(all_lens), CLCAP)
    cl_code = canonical_codes(cl_len, CLCAP)
    hb_lens = cl_len.gather(1, all_lens)
    dyn_cost = dyn_body + 14 + NCL * 3 + hb_lens.sum(-1)
    use_dyn = dyn_cost < fix_body
    huff_cost = torch.minimum(dyn_cost, fix_body)
    stored_cost = 8 * (ns + 5 * ((ns + 65534) // 65535))
    use_stored = stored_cost < huff_cost

    ud = use_dyn[:, None]
    lit_len_sel = torch.where(ud, lit_len, fixed_lit)
    dist_len_sel = torch.where(ud, dist_len, fixed_dist)
    # Fixed codes come from the full 288-symbol tree (codes 286/287 shift
    # the 9-bit first code); dynamic trees are self-defined over 286.
    fixed_lit_code = canonical_codes(on_device("fixed_lit288", dev)[None], 15)[:, :NLIT]
    lit_code = torch.where(ud, canonical_codes(lit_len, 15), fixed_lit_code)
    lit_code = torch.where(lit_len_sel > 0, lit_code, 0)
    dist_code = torch.where(ud, canonical_codes(dist_len, 15),
                            canonical_codes(fixed_dist[None], 15))

    # Header fields (1 + 19 + 316), values and widths; a fixed-tree block
    # has only its 3-bit header (bfinal=0, btype=01).
    hdr_vals = torch.cat([torch.full((B, 1), HDR_FIRST, device=dev),
                          cl_len[:, on_device("cl_order", dev)], cl_code.gather(1, all_lens)], -1)
    hdr_bits = torch.cat([torch.full((B, 1), 17, device=dev),
                          torch.full((B, NCL), 3, device=dev), hb_lens], -1)
    fixed_vals = torch.zeros_like(hdr_vals)
    fixed_vals[:, 0] = 2
    fixed_bits = torch.zeros_like(hdr_bits)
    fixed_bits[:, 0] = 3
    hdr_vals = torch.where(ud, hdr_vals, fixed_vals)
    hdr_bits = torch.where(ud, hdr_bits, fixed_bits)
    return dict(lit_len=lit_len_sel, lit_code=lit_code, dist_len=dist_len_sel,
                dist_code=dist_code, hdr_vals=hdr_vals, hdr_bits=hdr_bits,
                header_total=hdr_bits.sum(-1), use_stored=use_stored)


def build_tables_cuda(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns) -> dict:
    """Kernel P5 (``csrc/build_tables.cu``); the contract of
    :func:`build_tables_torch`. The arguments are checked and the outputs
    allocated; the seeding and the start lengths happen inside the one
    launch (:func:`launch_p5`), with no torch op before it."""
    from .. import _build

    B = lit_freq.shape[0] if lit_freq.dim() else 0
    for name, t, shape in (("lit_freq", lit_freq, (B, NLIT)), ("dist_freq", dist_freq, (B, NDIST)),
                           ("extra_l_bits", extra_l_bits, (B,)),
                           ("extra_d_bits", extra_d_bits, (B,)), ("ns", ns, (B,))):
        _build.require(t, name, ndim=len(shape), dtype=torch.int64)
        if tuple(t.shape) != shape or t.device != lit_freq.device:
            raise ValueError(f"{name}: expected shape {shape} on {lit_freq.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return launch_p5(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns)


def launch_p5(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns) -> dict:
    """The launch alone, on the raw histograms, all contiguous int64 CUDA
    tensors of :func:`build_tables_cuda`'s shapes, with the device's three
    tables (``start_thresholds``, ``cl_start_len``, ``flat_k``)."""
    from .. import _build

    B, dev = lit_freq.shape[0], lit_freq.device
    out = dict(lit_len=torch.empty(B, NLIT, dtype=torch.int64, device=dev),
               lit_code=torch.empty(B, NLIT, dtype=torch.int64, device=dev),
               dist_len=torch.empty(B, NDIST, dtype=torch.int64, device=dev),
               dist_code=torch.empty(B, NDIST, dtype=torch.int64, device=dev),
               hdr_vals=torch.empty(B, NHDR, dtype=torch.int64, device=dev),
               hdr_bits=torch.empty(B, NHDR, dtype=torch.int64, device=dev),
               header_total=torch.empty(B, dtype=torch.int64, device=dev),
               use_stored=torch.empty(B, dtype=torch.bool, device=dev))
    if B == 0:
        return out
    err = _build.lib().compu_build_tables(
        lit_freq.data_ptr(), dist_freq.data_ptr(), extra_l_bits.data_ptr(),
        extra_d_bits.data_ptr(), ns.data_ptr(), on_device("start_thresholds", dev).data_ptr(),
        on_device("cl_start_len", dev).data_ptr(), on_device("flat_k", dev).data_ptr(),
        *(t.data_ptr() for t in out.values()), B, _build.stream_handle(lit_freq))
    _build.check_launch(err, "build_tables")
    return out


def build_tables(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns) -> dict:
    """The table stage: kernel P5 on CUDA, the plain version on the CPU."""
    kind = lit_freq.device.type
    if kind == "cuda":
        return build_tables_cuda(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns)
    if kind == "cpu":
        return build_tables_torch(lit_freq, dist_freq, extra_l_bits, extra_d_bits, ns)
    raise ValueError(f"no build_tables for device {lit_freq.device}")
