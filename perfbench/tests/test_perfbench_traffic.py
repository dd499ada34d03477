"""The traffic generator: fixed by the seed, the same work for every seed."""

import numpy as np
import pytest

from perfbench.tests import smoke
from perfbench import traffic


def _take(stream, n):
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_same_seed_same_requests(loop):
    mix = traffic.Mix("m", smoke.mix_spec(loop, tenants=3))
    a = _take(mix.stream(2 ** 31 + 12345, 256), 150)
    b = _take(mix.stream(2 ** 31 + 12345, 256), 150)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.budget, x.tenant, x.due) == (y.budget, y.tenant, y.due)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_seeds_share_each_block_in_another_order(loop):
    mix = traffic.Mix("m", smoke.mix_spec(loop, tenants=3))
    a = _take(mix.stream(7, 256), traffic.BLOCK)
    b = _take(mix.stream(8, 256), traffic.BLOCK)
    for field in ("budget", "tenant"):
        assert sorted(getattr(r, field) for r in a) == sorted(
            getattr(r, field) for r in b)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert [r.budget for r in a] != [r.budget for r in b]
    if loop == "open":
        # The same gaps in another order: the block ends at the same time.
        assert a[-1].due == pytest.approx(b[-1].due)


def test_open_loop_rate_and_warm_load():
    spec = smoke.mix_spec("open")
    mix = traffic.Mix("m", spec)
    reqs = _take(mix.stream(3, 256), traffic.BLOCK * 4)
    assert reqs[0].due < 0 < reqs[-1].due          # the warm load comes first
    span = reqs[-1].due + spec["warm_s"]
    assert len(reqs) / span == pytest.approx(spec["rate"], rel=0.05)


def test_lengths_within_the_mix_and_max_seq():
    mix = traffic.Mix("m", smoke.mix_spec())
    for r in _take(mix.stream(11, 256), 200):
        assert 4 <= len(r.prompt) <= 16 and 8 <= r.budget <= 24
        assert len(r.prompt) + r.budget <= mix.max_seq + 1
        assert r.prompt.min() >= 0 and r.prompt.max() < 256


def test_zipf_tenants_skewed():
    ids = traffic._zipf_block(8, 1.1)
    counts = np.bincount(ids, minlength=8)
    assert counts.sum() == traffic.BLOCK
    assert list(counts) == sorted(counts, reverse=True) and counts[0] > 3 * counts[-1]


def test_residual_budgets_stagger_the_first_answers():
    out = traffic.residual_budgets([100] * 10)
    assert out == sorted(out) and out[0] == 5 and out[-1] == 95


def test_a_mix_longer_than_max_seq_is_refused():
    spec = smoke.mix_spec()
    spec["max_seq"] = 20
    with pytest.raises(ValueError):
        traffic.Mix("m", spec)
