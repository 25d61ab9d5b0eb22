"""Timing/stats substrate (util.c analogue) unit coverage."""

import math

from cfd_proxy.utils.timing import IterationStats, format_stats_table


def test_stats_summary():
    s = IterationStats("bulk")
    for t in (0.003, 0.001, 0.002, 0.010):
        s.add(t)
    assert s.min == 0.001 and s.max == 0.010
    assert s.median == 0.0025
    assert abs(s.mean - 0.004) < 1e-12


def test_table_speedups():
    a = IterationStats("bulk"); a.add(0.002)
    b = IterationStats("early"); b.add(0.001)
    table = format_stats_table([a, b], ref="bulk")
    lines = table.splitlines()
    assert "variant" in lines[0]
    assert "2.00" in lines[2]   # early is 2x bulk


def test_nan_sample_propagates():
    s = IterationStats("tiny")
    s.add(float("nan"))
    assert math.isnan(s.median)


def test_two_point_sampler_cancels_dispatch_overhead():
    """The shared primitive (solver and mbench ride it): per-iteration time = (t_big - t_small)/iters, dispatch
    overhead cancelled."""
    from cfd_proxy.utils.timing import two_point_sampler

    t = {"now": 0.0}
    sleeps = []

    def fake_run(cost):
        def run():
            t["now"] += cost
            sleeps.append(cost)
        return run

    import time as _time
    real = _time.perf_counter
    _time.perf_counter = lambda: t["now"]
    try:
        # dispatch 30 ms + 1 ms/iter: small = 10 iters, big = 110 iters
        sample = two_point_sampler(fake_run(0.030 + 0.001 * 10),
                                   fake_run(0.030 + 0.001 * 110), 100)
        v = sample()
        assert v is not None and abs(v - 0.001) < 1e-12
    finally:
        _time.perf_counter = real


def test_two_point_sampler_noise_floor_returns_none():
    from cfd_proxy.utils.timing import two_point_sampler

    t = {"now": 0.0}

    def fake_run(cost):
        def run():
            t["now"] += cost
        return run

    import time as _time
    real = _time.perf_counter
    _time.perf_counter = lambda: t["now"]
    try:
        # both lengths dominated by the same 30 ms dispatch: diff ~0
        sample = two_point_sampler(fake_run(0.030), fake_run(0.0305), 100)
        assert sample() is None
    finally:
        _time.perf_counter = real
