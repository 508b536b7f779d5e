"""Back-reference resolution of the device inflates: the expansion (kernel
P7) and the pointer doubling (kernel P6), ``csrc/inflate_resolve.cu``.

Port of the reference's jax.lax device loops of its two decode paths:
``compu_tpu/kernels/inflate_jax.py::_expand_and_resolve`` (the slot
scatter, running max, record gather and source computation, then the
``while_loop`` over the whole map and the one over the compacted set) and
``compu_tpu/kernels/inflate_spec.py::resolve_foreign`` (the same for an
ordered token list, then its ``while_loop``).

A root is an int32 a position: -(byte + 1) at a literal or stored byte,
else the position it copies from. The expansions make the map of roots:

* ``expand_indexed``, from a scan's records (B*S, R) int32: start in the
  lane's frame (9 bits, 511 none) | is_lit (1) | payload (15). The slot
  ids (row-major (lane, t) + 1) are scatter-maxed at each valid record's
  flat start, and a running max gives each position its token; a match
  position's source is ``start - dist + floormod(pos - start, dist)``.
* ``expand_foreign``, from the ordered token list of a foreign stream:
  each position takes the last token that starts at or before it, and the
  stored ranges' positions are their bytes' literal roots. The starts must
  rise strictly, as ``device_inflate``'s do.

The resolutions run the reference's schedule to the round and return
(out u8[NT], ok i32[1], rounds i32[2]: whole-map and compacted rounds);
with ``counts=True`` also the unresolved counts round by round, int32
(2, max_iters + 1): row 0 the unresolved valid positions before the first
whole-map round and after each, row 1 the compacted set's size and its
unresolved count after each of its rounds, 0 past the rounds that ran
(the kernel's counter block, read after its launch):

* ``resolve_indexed``: whole-map rounds of two hops while more than
  ``ksub = max(128, NT // 8)`` valid positions are unresolved and fewer
  than ``ceil(log2 NT)`` rounds have run; then the first ``ksub``
  unresolved valid positions, in order, one hop a round (the new roots
  written back into the map) while any is unresolved, at most as many
  rounds again. ``ok`` is the scan's flag and every valid position (below
  its block's ``ns``) resolved.
* ``resolve_foreign_roots``: whole-map rounds of two hops until none is
  unresolved, at most ``max(12, ceil(log2 NT))``; ``ok``: all resolved.

Each function dispatches by the tensor's device: the kernel for CUDA
tensors, with no host read between its launch and the caller's fetch (the
round counts and "any left" flags stay in device memory), the plain
version (``*_torch``) for CPU tensors; any other device raises. The plain
resolutions read their counts on the host, as before (the foreign one every
``ROUNDS_PER_CHECK`` rounds).
"""

from __future__ import annotations

import math

import torch

from .inflate_scan import NO_TOKEN, SEG

DUMP = 1 << 16  # cells the plain expansion's scatter drops slots without a token into
# Pointer-doubling rounds between two reads of the unresolved count in the
# plain foreign resolution: the roots do not change once every one is a
# literal, so later rounds are idempotent, and the host waits for the
# device once per group.
ROUNDS_PER_CHECK = 4
MAX_MAP = 1 << 30  # positions (and record slots) a kernel call takes at most


def indexed_schedule(nt: int) -> tuple[int, int]:
    """(max_iters, ksub) of the indexed resolution of ``nt`` positions."""
    return max(1, math.ceil(math.log2(max(nt, 2)))), max(SEG, nt // 8)


def foreign_max_iters(nt: int) -> int:
    """The foreign resolution's round limit: the reference's log2 of its
    padded length, at least 12."""
    return max(12, math.ceil(math.log2(max(nt, 2))))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def expand_indexed_torch(rec: torch.Tensor, *, B: int, N: int, S: int, R: int) -> torch.Tensor:
    """Each output position's token, by a scatter-max of slot ids at the
    token starts, a running max and one gather; returns the roots (B*N,)
    int32."""
    from .inflate import _running_max   # inflate imports this module

    dev = rec.device
    L, NT = B * S, B * N
    rec = rec.to(torch.int64).reshape(L, R)
    t_start = rec & 0x1FF
    flat_start = (torch.arange(L, device=dev)[:, None] * SEG + t_start).reshape(-1)
    # Slots without a token (most of them: R is sized for the worst case)
    # land in a dump area past the positions, spread over DUMP cells so
    # their atomic maxima do not queue on one address, and are cut off.
    slot = torch.arange(1, L * R + 1, device=dev)
    dump = NT + SEG + 512
    addr = torch.where(t_start.reshape(-1) < NO_TOKEN, flat_start, dump + (slot & (DUMP - 1)))
    slot_at = torch.zeros(dump + DUMP, dtype=torch.int64, device=dev).scatter_reduce(
        0, addr, slot, "amax")[:NT]
    tokid = torch.clamp(_running_max(slot_at) - 1, 0, L * R - 1)
    rec_of = rec.reshape(-1)[tokid]   # the one expansion gather
    is_lit = ((rec_of >> 9) & 1) > 0
    payload = (rec_of >> 10) & 0x7FFF
    dist = payload + 1
    # A token's start: its lane's base plus the start in the lane's frame
    # (a merged match can start in an earlier lane than the position's).
    start = (tokid // R) * SEG + (rec_of & 0x1FF)
    src = start - dist + torch.remainder(torch.arange(NT, device=dev) - start, dist)
    return torch.where(is_lit, -(payload + 1), torch.clamp(src, 0, NT - 1)).to(torch.int32)


def expand_foreign_torch(outlens: torch.Tensor, is_lit: torch.Tensor, payload: torch.Tensor,
                         starts: torch.Tensor, stored_out: torch.Tensor,
                         stored_mask: torch.Tensor, *, total_out: int) -> torch.Tensor:
    """The roots (total_out,) int32 of an ordered token list: every
    position takes the last token that starts at or before it (a scatter of
    token ids at their starts, then a running max); stored positions their
    byte's root."""
    from .inflate import _running_max

    dev = stored_out.device
    NT = total_out
    T = outlens.shape[0]
    starts = starts.to(torch.int64)
    pay = payload.to(torch.int64)
    slot_at = torch.zeros(NT, dtype=torch.int64, device=dev)
    slot_at[starts] = torch.arange(1, T + 1, device=dev)   # starts are distinct
    tokid = torch.clamp(_running_max(slot_at) - 1, 0, max(T - 1, 0))
    if T:
        start_of = starts[tokid]
        pay_of = pay[tokid]
        lit_of = is_lit[tokid] != 0
        dist_of = pay_of + 1
        gp = torch.arange(NT, device=dev)
        src = start_of - dist_of + torch.remainder(gp - start_of, dist_of)
        root = torch.where(lit_of, -(pay_of + 1), torch.clamp(src, 0, NT - 1))
    else:
        root = torch.zeros(NT, dtype=torch.int64, device=dev)
    root = torch.where(stored_mask, -(stored_out.to(torch.int64) + 1), root)
    return root.to(torch.int32)


def _out_bytes(root: torch.Tensor) -> torch.Tensor:
    return (torch.where(root < 0, -root, 1) - 1).to(torch.uint8)


def resolve_indexed_torch(root: torch.Tensor, ns: torch.Tensor, ok: torch.Tensor, *, N: int,
                          counts: bool = False):
    """Pointer doubling of the roots to literals; (out u8, ok i32[1], rounds
    i32[2]), and with ``counts`` the unresolved counts (2, max_iters + 1).
    The rounds read their remaining count on the host, once a round;
    ``root`` is left as it was."""
    from .inflate import _double, _double_sub

    NT = root.shape[0]
    root = root.clone()
    gp = torch.arange(NT, device=root.device)
    valid = (gp % N) < ns.to(torch.int64)[gp // N]
    max_iters, ksub = indexed_schedule(NT)
    seen = torch.zeros(2, max_iters + 1, dtype=torch.int32)

    def unresolved() -> int:
        return int(((root >= 0) & valid).sum())

    # Whole-map rounds until the unresolved set fits ksub...
    it, left = 0, unresolved()
    seen[0, 0] = left
    while left > ksub and it < max_iters:
        root = _double(root)
        it, left = it + 1, unresolved()
        seen[0, it] = left
    # ...then rounds over that set alone (the first ksub of it, in order).
    cand = torch.nonzero((root >= 0) & valid).reshape(-1)[:ksub]
    sub = root[cand]
    seen[1, 0] = cand.numel()
    sub_it = 0
    while sub_it < max_iters and bool((sub >= 0).any()):
        sub = _double_sub(root, cand, sub)
        sub_it += 1
        if counts:
            seen[1, sub_it] = int((sub >= 0).sum())
    ok = ok & torch.where(valid, root < 0, True).all()
    res = (_out_bytes(root), ok.to(torch.int32).reshape(1),
           torch.tensor([it, sub_it], dtype=torch.int32, device=root.device))
    return res + (seen.to(root.device),) if counts else res


def resolve_foreign_roots_torch(root: torch.Tensor, *, counts: bool = False):
    """Pointer doubling, two hops a round, until every root is a literal,
    at most :func:`foreign_max_iters` rounds; (out u8, ok i32[1], rounds
    i32[2]: the rounds that began with a root unresolved, and 0), and with
    ``counts`` the unresolved counts (2, max_iters + 1; row 1 zero). The
    unresolved count is read every ROUNDS_PER_CHECK rounds."""
    from .inflate import _double

    max_iters = foreign_max_iters(root.shape[0])
    run = torch.zeros((), dtype=torch.int32, device=root.device)
    seen = torch.zeros(2, max_iters + 1, dtype=torch.int32, device=root.device)
    seen[0, 0] = (root >= 0).sum()
    it = 0
    while it < max_iters and bool((root >= 0).any()):
        for _ in range(min(ROUNDS_PER_CHECK, max_iters - it)):
            run += (root >= 0).any()
            root = _double(root)
            it += 1
            if counts:
                seen[0, it] = (root >= 0).sum()
    ok = (root < 0).all()
    res = (_out_bytes(root), ok.to(torch.int32).reshape(1), torch.stack([run, torch.zeros_like(run)]))
    return res + (seen,) if counts else res


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor on its device (a device op, no
    host read)."""
    return t.to(torch.int32).contiguous()


def expand_indexed_cuda(rec: torch.Tensor, *, B: int, N: int, S: int, R: int) -> torch.Tensor:
    """Kernel P7's indexed entry: one cooperative launch, a barrier between
    the lanes' summaries and the positions; the contract of
    :func:`expand_indexed_torch`."""
    from .. import _build

    _build.require(rec, "rec", ndim=2, dtype=torch.int32)
    L, NT = B * S, B * N
    if tuple(rec.shape) != (L, R) or L * R == 0:
        raise ValueError(f"rec must be (B * S, R) = {(L, R)} with records, "
                         f"got {tuple(rec.shape)}")
    if NT <= 0 or NT >= MAX_MAP or L * R >= MAX_MAP:
        raise ValueError(f"{NT} positions and {L * R} record slots: each must lie in "
                         f"1..{MAX_MAP - 1}")
    lib = _build.lib()
    root = torch.empty(NT, dtype=torch.int32, device=rec.device)
    scratch = torch.empty(2 * L + lib.compu_inflate_resolve_max_grid(), dtype=torch.int32,
                          device=rec.device)
    err = lib.compu_inflate_expand_indexed(rec.data_ptr(), L * R, R, NT, root.data_ptr(),
                                           scratch.data_ptr(), _build.stream_handle(rec))
    _build.check_launch(err, "inflate_expand")
    return root


def expand_foreign_cuda(outlens: torch.Tensor, is_lit: torch.Tensor, payload: torch.Tensor,
                        starts: torch.Tensor, stored_out: torch.Tensor,
                        stored_mask: torch.Tensor, *, total_out: int) -> torch.Tensor:
    """Kernel P7's foreign entry: one launch, a block a run of tiles of
    1,024 positions; the contract of :func:`expand_foreign_torch` for
    starts that rise and payloads below 2^18 (DEFLATE's are below 2^15).
    The token fields are taken as int32 (a device conversion where they
    are not)."""
    from .. import _build

    dev = stored_out.device
    _build.require(stored_out, "stored_out", ndim=1, dtype=torch.uint8)
    _build.require(stored_mask, "stored_mask", ndim=1, dtype=torch.bool)
    T = outlens.shape[0]
    for name, t, n in (("outlens", outlens, T), ("is_lit", is_lit, T), ("payload", payload, T),
                       ("starts", starts, T), ("stored_out", stored_out, total_out),
                       ("stored_mask", stored_mask, total_out)):
        if t.dim() != 1 or t.shape[0] != n or t.device != dev:
            raise ValueError(f"{name} must be ({n},) on {dev}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if total_out >= MAX_MAP or T >= MAX_MAP:
        raise ValueError(f"{total_out} positions and {T} tokens: at most {MAX_MAP - 1}")
    root = torch.empty(total_out, dtype=torch.int32, device=dev)
    if total_out == 0:   # nothing to expand: no launch
        return root
    is_lit, payload, starts = (_as_int32(t) for t in (is_lit, payload, starts))
    err = _build.lib().compu_inflate_expand_foreign(
        is_lit.data_ptr(), payload.data_ptr(), starts.data_ptr(), T, stored_out.data_ptr(),
        stored_mask.data_ptr(), total_out, root.data_ptr(), _build.stream_handle(stored_out))
    _build.check_launch(err, "inflate_expand")
    return root


def _launch_p6(root: torch.Tensor, ns, ok, *, N: int, max_iters: int, ksub: int,
               counts: bool = False):
    """One cooperative launch of P6 over ``root``; (out, ok, rounds), and
    with ``counts`` the counter block's unresolved counts (2, max_iters +
    1), a view of the launch's scratch."""
    from .. import _build

    NT, dev = root.shape[0], root.device
    if NT == 0:   # nothing to resolve: no launch
        flag = torch.ones(1, dtype=torch.int32, device=dev) if ok is None else ok.to(torch.int32)
        res = (torch.empty(0, dtype=torch.uint8, device=dev), flag.reshape(1),
               torch.zeros(2, dtype=torch.int32, device=dev))
        return res + (torch.zeros(2, max_iters + 1, dtype=torch.int32, device=dev),) \
            if counts else res
    lib = _build.lib()
    ksub = min(ksub, NT)
    tiles = -(-NT // lib.compu_inflate_resolve_tile())
    ctr_words = lib.compu_inflate_resolve_ctr_words()
    scratch = torch.empty(2 * tiles * lib.compu_inflate_resolve_tile() + 3 * ksub + 3 * tiles
                          + 3 * lib.compu_inflate_resolve_max_grid() + ctr_words,
                          dtype=torch.int32, device=dev)
    out = torch.empty(NT, dtype=torch.uint8, device=dev)
    ok_out = torch.empty(1, dtype=torch.int32, device=dev)
    rounds = torch.empty(2, dtype=torch.int32, device=dev)
    err = lib.compu_inflate_resolve(
        root.data_ptr(), NT, N, None if ns is None else ns.data_ptr(),
        None if ok is None else ok.data_ptr(), max_iters, ksub, scratch.data_ptr(),
        out.data_ptr(), ok_out.data_ptr(), rounds.data_ptr(), _build.stream_handle(root))
    _build.check_launch(err, "inflate_resolve")
    if not counts:
        return out, ok_out, rounds
    # The counter block's first 2 * cap words: the whole-map counts, then
    # the compacted set's, cap (the kernel's round limit) each.
    cap = (ctr_words - 4) // 2
    seen = scratch[scratch.numel() - ctr_words:][:2 * cap].view(2, cap)[:, :max_iters + 1]
    return out, ok_out, rounds, seen
def _check_root(root: torch.Tensor) -> None:
    from .. import _build

    _build.require(root, "root", ndim=1, dtype=torch.int32)
    if root.shape[0] >= MAX_MAP:
        raise ValueError(f"root must hold fewer than {MAX_MAP} positions, got {root.shape[0]}")


def resolve_indexed_cuda(root: torch.Tensor, ns: torch.Tensor, ok: torch.Tensor, *, N: int,
                         counts: bool = False):
    """Kernel P6 over an indexed batch's roots (B*N,) int32, with the
    blocks' lengths ``ns`` (B,) int32 and the scan's flag ``ok`` (a bool of
    one element), all on one CUDA device: one launch; the contract of
    :func:`resolve_indexed_torch`. ``root`` is left as it was."""
    from .. import _build

    _check_root(root)
    _build.require(ns, "ns", ndim=1, dtype=torch.int32)
    if ok.dtype != torch.bool or ok.numel() != 1 or not ok.is_contiguous():
        raise ValueError(f"ok must be one contiguous bool, got {ok.dtype} {tuple(ok.shape)}")
    if N <= 0 or ns.shape[0] * N != root.shape[0] or ns.shape[0] == 0:
        raise ValueError(f"root must hold len(ns) * N = {ns.shape[0]} * {N} positions, "
                         f"got {root.shape[0]}")
    if ns.device != root.device or ok.device != root.device:
        raise ValueError(f"ns and ok must be on {root.device}")
    max_iters, ksub = indexed_schedule(root.shape[0])
    return _launch_p6(root, ns, ok, N=N, max_iters=max_iters, ksub=ksub, counts=counts)


def resolve_foreign_roots_cuda(root: torch.Tensor, *, counts: bool = False):
    """Kernel P6 over a foreign stream's roots (NT,) int32 on a CUDA
    device: one launch; the contract of :func:`resolve_foreign_roots_torch`."""
    _check_root(root)
    NT = root.shape[0]
    return _launch_p6(root, None, None, N=NT, max_iters=foreign_max_iters(NT), ksub=0,
                      counts=counts)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _route(name: str, t: torch.Tensor, cuda, plain):
    kind = t.device.type
    if kind == "cuda":
        return cuda
    if kind == "cpu":
        return plain
    raise ValueError(f"no {name} for device {t.device}")


def expand_indexed(rec, *, B: int, N: int, S: int, R: int) -> torch.Tensor:
    """The indexed expansion: kernel P7 on CUDA, the plain version on the CPU."""
    fn = _route("expand_indexed", rec, expand_indexed_cuda, expand_indexed_torch)
    return fn(rec, B=B, N=N, S=S, R=R)


def expand_foreign(outlens, is_lit, payload, starts, stored_out, stored_mask, *,
                   total_out: int) -> torch.Tensor:
    """The foreign expansion: kernel P7 on CUDA, the plain version on the CPU."""
    fn = _route("expand_foreign", stored_out, expand_foreign_cuda, expand_foreign_torch)
    return fn(outlens, is_lit, payload, starts, stored_out, stored_mask, total_out=total_out)


def resolve_indexed(root, ns, ok, *, N: int, counts: bool = False):
    """The indexed resolution: kernel P6 on CUDA, the plain version on the CPU."""
    fn = _route("resolve_indexed", root, resolve_indexed_cuda, resolve_indexed_torch)
    return fn(root, ns, ok, N=N, counts=counts)


def resolve_foreign_roots(root, *, counts: bool = False):
    """The foreign resolution: kernel P6 on CUDA, the plain version on the CPU."""
    fn = _route("resolve_foreign_roots", root, resolve_foreign_roots_cuda,
                resolve_foreign_roots_torch)
    return fn(root, counts=counts)
