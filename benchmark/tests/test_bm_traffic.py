"""The traffic generator is deterministic in the seed, and every seed gets
the same sizes and arrivals in another order."""
import numpy as np
import pytest

import generator as gen

BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_same_seed_same_traffic(seed):
    a = gen.stratified_lengths(513, 1000, 64, gen.rng_for(seed, 1))
    b = gen.stratified_lengths(513, 1000, 64, gen.rng_for(seed, 1))
    assert a == b
    assert gen.poisson_gaps(40.0, 128, gen.rng_for(seed, 4)) == gen.poisson_gaps(40.0, 128, gen.rng_for(seed, 4))
    m1, m2 = gen.mel_pool(a[:3], 80, seed, 2), gen.mel_pool(a[:3], 80, seed, 2)
    assert all(np.array_equal(x, y) for x, y in zip(m1, m2))


def test_seeds_share_sizes_not_order():
    a = gen.stratified_lengths(100, 1000, 128, gen.rng_for(1, 1))
    b = gen.stratified_lengths(100, 1000, 128, gen.rng_for(BIG, 1))
    assert sorted(a) == sorted(b) and a != b
    ga, gb = gen.poisson_gaps(40.0, 256, gen.rng_for(1, 4)), gen.poisson_gaps(40.0, 256, gen.rng_for(2, 4))
    assert sorted(ga) == sorted(gb) and ga != gb
    assert abs(np.mean(ga) - 1 / 40.0) < 0.02 / 40.0
    m1, m2 = gen.mel_pool([50], 80, 1, 2)[0], gen.mel_pool([50], 80, 2, 2)[0]
    assert m1.shape == m2.shape == (1, 50, 80) and not np.array_equal(m1, m2)


def test_lengths_cover_their_range():
    a = gen.stratified_lengths(513, 1000, 64, gen.rng_for(3, 1))
    assert min(a) >= 513 and max(a) <= 1000 and len(set(a)) == 64
