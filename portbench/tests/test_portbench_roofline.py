"""The roofline's yardstick: B1's operations in closed form against the
running minimum the matcher walks, and a bound that takes the larger of
bytes and operations."""

import json

import numpy as np
import pytest
import torch

from portbench import generate, harness, roofline

N = 1 << 15
KIND = "NVIDIA H100 80GB HBM3"


def walked_candidates(rows: np.ndarray, depth: int) -> int:
    """Candidates weighed, lane by lane, over the port's own sort: until
    the running minimum of the neighbours' common prefix is 0."""
    from compu_tpu_torch.kernels.lcp_match import _adj_from_words, sort_stage_lex

    *wbe, _ = sort_stage_lex(torch.from_numpy(rows), wcap=16, keys=2, stride=1)
    w = torch.stack([x.reshape(-1) for x in wbe])
    n = w.shape[1]
    lpos = torch.arange(n) & (N - 1)
    adj = torch.where(lpos == 0, 0, _adj_from_words(w, torch.roll(w, 1, dims=1)))
    back, fwd = adj, torch.where(lpos == N - 1, 0, torch.roll(adj, -1))
    weighed = 2 * n
    for d in range(1, depth):
        weighed += int((back > 0).sum()) + int((fwd > 0).sum())
        back = torch.minimum(back, torch.roll(adj, d))
        fwd = torch.minimum(fwd, torch.where(lpos >= N - (d + 1), 0, torch.roll(adj, -(d + 1))))
    return weighed


@pytest.mark.parametrize("traffic,depth", [("mixed-16m", 16), ("mixed-16m", 48),
                                           ("logs-16m", 48)])
def test_lcp_ops_closed_form(traffic, depth):
    t = json.loads((harness.PKG / "traffic" / f"{traffic}.json").read_text())
    rows = np.frombuffer(generate.make_input(dict(t, request_bytes=1 << 17), 9, 0),
                         np.uint8).reshape(-1, N).copy()
    want = walked_candidates(rows, depth) * roofline.OPS_PER_CANDIDATE + 3 * 4 * rows.size
    assert roofline.lcp_ops(rows, 16, depth) == want


def test_bound_is_the_larger_of_bytes_and_operations():
    data = bytes(np.random.default_rng(3).integers(0, 256, 1 << 20, dtype=np.uint8))
    rest = sum(f(4, 1 << 18, 16) for k, f in roofline.KERNELS.items() if k != "lcp_kernel")
    by_bytes = (roofline.lcp_candidates(4, 1 << 18, 16) + rest) / roofline.PEAK_BYTES_PER_S[KIND]
    shallow = roofline.request_bound_s(data, 1 << 18, {"wcap": 16, "depth": 16}, KIND)
    deep = roofline.request_bound_s(data, 1 << 18, {"wcap": 16, "depth": 48}, KIND)
    blocks = np.frombuffer(data, np.uint8).reshape(4, -1)
    ops = roofline.lcp_ops(blocks, 16, 48) / roofline.PEAK_INT_OPS_PER_S[KIND]
    assert shallow == pytest.approx(by_bytes)
    assert ops > roofline.lcp_candidates(4, 1 << 18, 16) / roofline.PEAK_BYTES_PER_S[KIND]
    assert deep == pytest.approx(rest / roofline.PEAK_BYTES_PER_S[KIND] + ops)
    assert roofline.request_bound_s(data, 1 << 18, {"wcap": 16, "depth": 48}, "cpu") is None
