"""The traffic copy: deterministic per seed, different across seeds, the
same work (sizes and gaps) on every seed, and the rate it is asked for."""
import numpy as np

from portbench import harness, traffic

MIXES = ("closed8", "chat-open")


def _stream(mix, seed):
    return traffic.Traffic(harness.mix(mix), seed, 102400)


def test_deterministic_per_seed():
    for mix in MIXES:
        a, b = _stream(mix, 2 ** 31 + 77), _stream(mix, 2 ** 31 + 77)
        for i in (0, 5, 130):
            ra, rb = a.request(i), b.request(i)
            assert ra.prompt == rb.prompt and ra.max_new == rb.max_new
    p = harness.mix("chat-open")
    assert np.array_equal(_stream("chat-open", 9).arrivals(50),
                          _stream("chat-open", 9).arrivals(50))
    assert p["rate"] > 0


def test_differs_across_seeds():
    for mix in MIXES:
        a, b = _stream(mix, 1), _stream(mix, 2)
        assert [a.request(i).prompt for i in range(8)] != \
            [b.request(i).prompt for i in range(8)]
    # the fixed order permutes the pool: neither sorted nor the same in
    # its next block
    s = _stream("chat-open", 1)
    n = harness.mix("chat-open")["pool"]
    outs = [s.request(i).max_new for i in range(2 * n)]
    assert outs[:n] != sorted(outs[:n]) and outs[:n] != outs[n:]


def test_same_work_on_every_seed():
    for mix in MIXES:
        n = harness.mix(mix)["pool"]
        sizes = [sorted((len(r.prompt), r.max_new) for r in
                        (_stream(mix, s).request(i) for i in range(n)))
                 for s in (1, 2)]
        lens = [sorted(len(_stream(mix, s).request(i).prompt)
                       for i in range(n)) for s in (1, 2)]
        assert lens[0] == lens[1]
        assert sorted(x[1] for x in sizes[0]) == sorted(x[1] for x in sizes[1])
    ends = [_stream("chat-open", s).arrivals(64)[-1] for s in (1, 2)]
    assert abs(ends[0] - ends[1]) < 1e-9
    # the fixed order: the same sizes at the same times
    for mix in MIXES:
        a, b = _stream(mix, 1), _stream(mix, 2)
        assert [(len(a.request(i).prompt), a.request(i).max_new)
                for i in range(100)] == \
            [(len(b.request(i).prompt), b.request(i).max_new)
             for i in range(100)]
    assert np.array_equal(_stream("chat-open", 1).arrivals(100),
                          _stream("chat-open", 2).arrivals(100))


def test_lengths_and_rate():
    p = harness.mix("chat-open")
    s = _stream("chat-open", 3)
    lens = [len(s.request(i).prompt) for i in range(p["pool"])]
    assert min(lens) >= p["prompt"]["min"] and max(lens) <= p["prompt"]["max"]
    assert abs(float(np.median(lens)) - p["prompt"]["median"]) <= 8
    t = s.arrivals(10 * p["pool"])
    assert abs(len(t) / t[-1] - p["rate"]) / p["rate"] < 0.02
    outs = [s.request(i).max_new for i in range(p["pool"])]
    assert min(outs) >= p["output"]["min"] and max(outs) <= p["output"]["max"]


def test_diurnal_and_prefix():
    p = dict(harness.mix("chat-open"), diurnal={"period_s": 16.0,
                                                "amplitude": 0.8},
             prefix={"count": 4, "len": 32, "zipf_s": 1.3})
    s = traffic.Traffic(p, 4, 1000)
    t = s.arrivals(640)
    assert np.all(np.diff(t) > 0)
    assert abs(len(t) / t[-1] - p["rate"]) / p["rate"] < 0.1
    heads = {tuple(s.request(i).prompt[:32]) for i in range(40)}
    assert heads <= {tuple(x) for x in s.prefixes} and len(heads) > 1
