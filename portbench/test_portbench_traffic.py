"""The traffic generator: deterministic by seed, the same sizes for every
seed, and the stated distributions."""
import math
from statistics import NormalDist

import numpy as np
import pytest

from portbench import harness, traffic

MIXES = ("chat", "offline")


def mix(name):
    return harness.load(harness.HERE / "mixes" / f"{name}.json")


def lengths(sched):
    return (np.array([len(d.prompt) for d in sched]),
            np.array([d.max_new_tokens for d in sched]))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.schedule(mix(name), 2 ** 31 + 7, 1000, 3.0, 10)
    b = traffic.schedule(mix(name), 2 ** 31 + 7, 1000, 3.0, 10)
    assert [d.due_s for d in a] == [d.due_s for d in b]
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.max_new_tokens == y.max_new_tokens for x, y in zip(a, b))


@pytest.mark.parametrize("name", MIXES)
def test_seeds_reorder_one_set_of_sizes(name):
    a = traffic.schedule(mix(name), 1, 1000, 3.0, 10)
    b = traffic.schedule(mix(name), 2, 1000, 3.0, 10)
    pa, oa = lengths(a)
    pb, ob = lengths(b)
    assert sorted(pa) == sorted(pb) and sorted(oa) == sorted(ob)
    assert not np.array_equal(pa, pb)
    assert not all(np.array_equal(x.prompt[:8], y.prompt[:8])
                   for x, y in zip(a, b))
    gaps_a = np.diff([0.0] + [d.due_s for d in a])
    gaps_b = np.diff([0.0] + [d.due_s for d in b])
    assert np.allclose(sorted(gaps_a), sorted(gaps_b))


def test_lognormal_lengths_follow_the_mix():
    spec = mix("chat")["prompt_tokens"]
    q = traffic.quantiles(spec, 4001)
    assert q.min() >= spec["min"] and q.max() <= spec["max"]
    assert abs(np.median(q) - spec["median"]) <= 1
    # the share under x follows the clipped lognormal's CDF
    for x in (256, 512, 2048):
        want = NormalDist().cdf(math.log(x / spec["median"]) / spec["sigma"])
        assert abs((q <= x).mean() - want) < 2e-3


def test_uniform_lengths_follow_the_mix():
    spec = mix("offline")["prompt_tokens"]
    q = traffic.quantiles(spec, 8193)
    assert q.min() == spec["min"] and q.max() == spec["max"]
    counts = np.bincount(q - spec["min"])
    assert counts.max() - counts.min() <= 1


def test_poisson_gaps_have_the_rate():
    sched = traffic.schedule(mix("chat"), 5, 1000, 4.0, 200)
    gaps = np.diff([0.0] + [d.due_s for d in sched])
    assert abs(gaps.mean() - 1 / 4.0) < 0.01
    assert abs(np.median(gaps) - math.log(2) / 4.0) < 0.01
    assert len(sched) == traffic.count(mix("chat"), 4.0, 200)


def test_blocks_hold_every_stratum():
    values = np.arange(traffic.BLOCK * 10)
    out = traffic.blocked_shuffle(values, np.random.default_rng(0))
    for b in range(10):
        block = out[b * traffic.BLOCK:(b + 1) * traffic.BLOCK]
        assert sorted(block // 10) == list(range(traffic.BLOCK))


@pytest.mark.parametrize("name", MIXES)
def test_every_block_of_a_schedule_holds_every_size_stratum(name):
    m = mix(name)
    sched = traffic.schedule(m, 11, 1000, 2.0, 50)
    n = len(sched)
    assert n % traffic.BLOCK == 0
    want = traffic.quantiles(m["prompt_tokens"], n).reshape(
        traffic.BLOCK, -1)
    prompt, _ = lengths(sched)
    for b in range(0, n, traffic.BLOCK):
        got = np.sort(prompt[b:b + traffic.BLOCK])
        assert all(lo <= g <= hi for g, lo, hi in
                   zip(got, want.min(1), want.max(1)))


def test_poisson_arrivals_bunch_as_a_poisson_stream():
    """Counts of arrivals in 5-s bins of the window: their variance over
    their mean is about 1, as a Poisson stream's (a stratified order of the
    gaps read about 0.33 here), and the window holds rate x seconds."""
    m = mix("chat")
    disp, held = [], []
    for seed in range(100):
        due = np.array([d.due_s for d in traffic.schedule(
            m, 2 ** 33 + seed, 1000, 2.0, 50)])
        c = np.histogram(due, bins=np.arange(m["ramp_s"], m["ramp_s"] + 51,
                                              5.0))[0]
        disp.append(c.var(ddof=1) / c.mean())
        held.append(c.sum())
    assert 0.85 < np.mean(disp) < 1.15
    assert abs(np.mean(held) - 100) < 3


def test_backlog_is_due_at_once():
    sched = traffic.schedule(mix("offline"), 3, 1000, 0.0, 10)
    assert len(sched) == mix("offline")["backlog"]
    assert all(d.due_s == 0.0 for d in sched)


def test_token_ids_in_vocabulary():
    sched = traffic.schedule(mix("chat"), 9, 321, 3.0, 5)
    assert all(d.prompt.dtype == np.int32 and d.prompt.min() >= 0
               and d.prompt.max() < 321 for d in sched)
