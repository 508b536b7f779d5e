"""The end-to-end arithmetic over every request of a window, on a fake
clock: MB/s over the whole window, the 95th percentile of all latencies,
the ratio of the completed requests."""

import statistics

import pytest

from portbench import harness


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class FakeSystem:
    """Each request takes the next latency of a cycle and returns a stream
    of a quarter of its input; the input of index 2 fails."""

    def __init__(self, clock, latencies):
        self.clock, self.lat, self.calls = clock, latencies, 0

    def __call__(self, data):
        self.clock.now += self.lat[self.calls % len(self.lat)]
        self.calls += 1
        if data[:1] == b"\2":
            raise RuntimeError("device fault")
        return (data[: len(data) // 4], None), {"framing_ms": 1.0}

    @staticmethod
    def out_bytes(out):
        return len(out[0])


def test_window_and_metrics():
    clock = FakeClock()
    lat = [0.1, 0.25, 0.05, 0.4, 0.2]
    sut = FakeSystem(clock, lat)
    pool = [bytes([k]) * 1_000_000 for k in range(4)]
    t0, t1, reqs = harness.closed_loop(sut, pool, 3.0, clock)
    # Requests start until 3 s have passed; the last one ends the window.
    want, t = [], 0.0
    while t < 3.0:
        want.append(lat[len(want) % len(lat)])
        t += want[-1]
    assert [r.seconds for r in reqs] == pytest.approx(want)
    assert t1 - t0 == pytest.approx(sum(want))
    assert [r.k for r in reqs] == [i % 4 for i in range(len(want))]
    failed = [r for r in reqs if r.out is None]
    assert failed and all(r.k == 2 and "device fault" in r.error for r in failed)
    m = harness.end_to_end(pool, t0, t1, reqs, sut, setup_s=7.5)
    done = len(reqs) - len(failed)
    assert m["MBps"] == {"value": pytest.approx(done / sum(want)), "unit": "MB/s"}
    assert m["p95_ms"]["value"] == pytest.approx(
        1e3 * statistics.quantiles(want, n=20, method="inclusive")[-1])
    assert m["ratio"]["value"] == pytest.approx(4.0)
    assert m["setup_s"] == {"value": 7.5, "unit": "s"}


def test_p95_of_all_requests():
    vals = [float(v) for v in range(1, 201)]
    assert harness.p95(vals) == pytest.approx(190.05)
    assert harness.p95([3.0]) == 3.0
