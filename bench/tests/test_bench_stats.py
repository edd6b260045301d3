"""Percentiles, rates and token gaps on hand-made timelines, and the
end-to-end readers over them."""
import math

import pytest

from bench.lib import stats
from bench.lib.serve import Track
from bench.lib.spec import load_module
from conftest import ROOT


def reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                       "test_" + name.replace(".", "_")).read


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([3.0], 90) == 3.0
    assert stats.percentile([1, 2, math.inf], 90) == math.inf
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate():
    assert stats.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_token_gaps_divide_by_tokens_delivered_together():
    # first token with 3 more at t=1 (gap 0 each), 4 tokens at t=1.2,
    # 2 tokens at t=1.6
    d = [(1.0, 4), (1.2, 4), (1.6, 2)]
    gaps = stats.token_gaps(d, 0.0, 10.0)
    assert gaps == pytest.approx([0, 0, 0, 0.05, 0.05, 0.05, 0.05, 0.2, 0.2])
    # only deliveries inside the window count
    assert stats.token_gaps(d, 1.1, 1.3) == pytest.approx([0.05] * 4)
    assert stats.tokens_in(d, 1.1, 1.7) == 6


def test_ttft_counts_failures_as_missing():
    a = Track(0, [1] * 4, 8, 0.5, deliveries=[(1.0, 1)])
    b = Track(1, [1] * 4, 8, 0.9, end_t=1.5, status="FAILED")
    c = Track(2, [1] * 4, 8, 0.0, deliveries=[(0.2, 1)])   # before
    assert stats.ttft_samples([a, b, c], 0.8, 2.0) == [0.5, math.inf]


def serve_rec(tracks, t0=0.0, t1=10.0):
    return {"kind": "serve", "tracks": tracks, "t_open": t0, "t_close": t1,
            "window_s": t1 - t0}


def steady(n_req=20, stall_at=None):
    """Requests each delivering 8 tokens every 0.1 s; with ``stall_at``,
    one delivery of every request held back 2 s."""
    tracks = []
    for i in range(n_req):
        t, d = 0.5 + 0.01 * i, []
        d.append((t, 1))
        for k in range(10):
            t += 0.1 + (2.0 if stall_at == k else 0.0)
            d.append((t, 8))
        tracks.append(Track(i, [1] * 4, 81, 0.4, deliveries=d))
    return tracks


def test_end_to_end_readers():
    rec = serve_rec(steady())
    assert reader("output_tps")(rec) == pytest.approx(20 * 81 / 10.0)
    assert reader("ttft_p90_ms")(rec) == pytest.approx(100.0 + 10 * 17)
    assert reader("itl_p95_ms")(rec) == pytest.approx(100.0 / 8)
    assert reader("output_tps")({"kind": "train"}) is None


def test_a_stall_raises_the_token_gap_tail():
    calm = reader("itl_p95_ms")(serve_rec(steady()))
    # one stall in ten deliveries: 10% of the gaps grow 21-fold
    stalled = reader("itl_p95_ms")(serve_rec(steady(stall_at=3)))
    assert stalled == pytest.approx(2100.0 / 8)
    assert stalled > 10 * calm
