"""The traffic is fixed by the seed, and every seed gets the same work."""

import numpy as np

from portbench import traffic


def _prefill(seed, stream=traffic.TRAFFIC):
    mix = traffic.load("prefill_repo")
    return traffic.Prefill(mix, 49152, seed, stream)


def _generate(seed):
    return traffic.Generate(traffic.load("generate_batch"), 49152, seed)


def test_prefill_is_deterministic_in_the_seed():
    a, b = _prefill(2 ** 31 + 5), _prefill(2 ** 31 + 5)
    for _ in range(3):
        for x, y in zip(a.cycle(), b.cycle()):
            np.testing.assert_array_equal(x, y)


def test_prefill_seeds_differ_in_data_not_in_sizes():
    a, b = _prefill(3).cycle(), _prefill(4).cycle()
    assert sorted(x.shape for x in a) == sorted(x.shape for x in b) == [
        (2, 4096), (2, 6144), (2, 8192)]
    assert not all(np.array_equal(x, y) for x, y in zip(
        sorted(a, key=len), sorted(b, key=len)))


def test_warmup_stream_is_not_the_window_stream():
    w, t = _prefill(9, traffic.WARMUP).cycle(), _prefill(9).cycle()
    assert not any(np.array_equal(x, y) for x in w for y in t
                   if x.shape == y.shape)


def test_generate_is_deterministic_and_keeps_its_lengths():
    """Every seed and every call has the same lengths in the same order
    (which requests share a slot, and so the call's steps); the seed
    changes the token ids only."""
    a, b, c = _generate(77), _generate(77), _generate(78)
    pa, pb, pc = a.call(), b.call(), c.call()
    assert len(pa) == 512
    for x, y in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    order = [len(p) for p in pa]
    assert order == [len(p) for p in pc] == [len(p) for p in a.call()]
    assert order != sorted(order)
    assert min(order) == 16 and max(order) == 64
    assert not all(np.array_equal(x, y) for x, y in zip(pa, pc))
    assert all(p.min() >= 0 and p.max() < 49152 for p in pa)


def test_a_negative_or_huge_seed_works():
    for seed in (-1, 2 ** 40 + 3):
        assert len(_generate(seed).call()) == 512
