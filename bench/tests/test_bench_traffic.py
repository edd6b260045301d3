"""The traffic generator: the same sizes for every seed, in the seed's
order, with token ids from the seed; Poisson arrivals conditioned on
their count."""
import numpy as np

from bench.lib import traffic

MIX = {"arrivals": {"kind": "poisson", "rate": 4.0},
       "initial_requests": 4, "requests": 32, "block": 1,
       "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.7,
                  "lo": 8, "hi": 200},
       "output": {"dist": "lognormal", "median": 9, "sigma": 0.5,
                  "lo": 4, "hi": 20}}


def sizes(reqs, prefix=0):
    return sorted((len(r.prompt) - prefix, r.max_new_tokens) for r in reqs)


def test_same_seed_same_requests():
    a = traffic.requests(MIX, 2 ** 31 + 12345, 1000, 0)
    b = traffic.requests(MIX, 2 ** 31 + 12345, 1000, 0)
    assert [r.max_new_tokens for r in a] == [r.max_new_tokens for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_seeds_share_sizes_in_another_order():
    a = traffic.requests(MIX, 5, 1000, 3)
    b = traffic.requests(MIX, 2 ** 40 + 7, 1000, 3)
    assert sizes(a, 3) == sizes(b, 3)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert all((r.prompt[:3] == 0).all() for r in a)     # patch slots
    assert max(int(r.prompt.max()) for r in a) < 1000


def test_lengths_follow_the_distribution():
    lens = traffic.quantile_lengths(MIX["prompt"], 1001)
    assert lens.min() >= 8 and lens.max() <= 200
    assert abs(np.median(lens) - 40) <= 1
    few = traffic.quantile_lengths(
        {"dist": "lognormal", "median": 100, "sigma": 1.0, "lo": 50,
         "hi": 150}, 4)
    assert list(few) == [50, 73, 138, 150]        # clipped at both ends
    with np.testing.assert_raises(ValueError):
        traffic.quantile_lengths({"dist": "uniform", "lo": 1, "hi": 2}, 4)


def test_first_budgets_stagger():
    reqs = traffic.requests(MIX, 9, 1000, 0)
    first = traffic.first_budgets(MIX, reqs)
    assert len(first) == 4
    assert all(1 <= f <= r.max_new_tokens for f, r in zip(first, reqs))


def test_open_loop_gaps():
    """Arrivals are a Poisson process conditioned on its count: every seed
    sends rate x span requests, and the counts in short stretches spread
    as a Poisson count's do (variance near the mean), not smoothed."""
    mix = dict(MIX, arrivals={"kind": "poisson", "rate": 4.0})
    t1 = traffic.arrival_times(mix, 3, 50.0)
    t2 = traffic.arrival_times(mix, 3, 50.0)
    t3 = traffic.arrival_times(mix, 2 ** 33 + 4, 50.0)
    assert np.array_equal(t1, t2) and len(t1) == len(t3) == 200
    assert not np.array_equal(t1, t3)
    assert (np.diff(t1) >= 0).all() and 0 <= t1[0] and t1[-1] < 50.0
    counts = np.concatenate([
        np.histogram(traffic.arrival_times(mix, s, 50.0),
                     bins=np.arange(0.0, 50.01, 2.5))[0]
        for s in range(200)])
    assert abs(counts.mean() - 10.0) < 0.01
    assert 0.85 < counts.var() / counts.mean() < 1.1
    with np.testing.assert_raises(ValueError):
        traffic.arrival_times(
            dict(MIX, arrivals={"kind": "bursty", "rate": 4.0}), 3, 50.0)


def test_trace_arrivals_rotate_one_draw():
    """A ``poisson_trace`` mix offers every seed the same gaps in the
    ramp and in the window, each turned on its circle by the seed; the
    fixed draw spreads as a Poisson count does."""
    mix = dict(MIX, ramp_s=10.0,
               arrivals={"kind": "poisson_trace", "rate": 4.0,
                         "trace_seed": 1})
    t1 = traffic.arrival_times(mix, 3, 60.0)
    t2 = traffic.arrival_times(mix, 3, 60.0)
    t3 = traffic.arrival_times(mix, 2 ** 33 + 4, 60.0)
    assert np.array_equal(t1, t2) and not np.array_equal(t1, t3)
    assert len(t1) == len(t3) == 240
    assert (np.diff(t1) >= 0).all() and 0 <= t1[0] and t1[-1] < 60.0
    for t in (t1, t3):
        assert ((t < 10.0).sum()) == 40

    def circle_gaps(t, lo, length):
        x = np.sort(t[(t >= lo) & (t < lo + length)] - lo)
        return np.sort(np.diff(np.append(x, x[0] + length)))
    for lo, length in ((0.0, 10.0), (10.0, 50.0)):
        np.testing.assert_allclose(circle_gaps(t1, lo, length),
                                   circle_gaps(t3, lo, length), atol=1e-9)
    other = traffic.arrival_times(
        dict(mix, arrivals=dict(mix["arrivals"], trace_seed=2)), 3, 60.0)
    assert not np.array_equal(t1, other)
    counts = np.concatenate([
        np.histogram(traffic.arrival_times(
            dict(mix, arrivals=dict(mix["arrivals"], trace_seed=k)), 0,
            60.0)[40:], bins=np.arange(10.0, 60.01, 2.5))[0]
        for k in range(200)])
    assert 0.85 < counts.var() / counts.mean() < 1.1


def test_every_run_of_a_block_holds_one_size_of_each_stratum():
    mix = dict(MIX, block=8, arrivals={"kind": "poisson", "rate": 4.0})
    ranks = {p: i for i, (p, _) in enumerate(sorted(
        traffic.size_set(mix), key=lambda s: s[0]))}
    for seed in (1, 2 ** 31 + 7):
        reqs = traffic.requests(mix, seed, 1000, 0)
        for b in range(0, 32, 8):
            strata = sorted(ranks[len(r.prompt)] // 4 for r in reqs[b:b + 8])
            assert strata == list(range(8))
    a = traffic.requests(mix, 1, 1000, 0)
    b = traffic.requests(mix, 2, 1000, 0)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    with np.testing.assert_raises(ValueError):
        traffic.requests(dict(mix, block=5), 1, 1000, 0)
