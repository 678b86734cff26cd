"""Parity of the port's host matchers (``repro_torch.core.matching``, numpy
copies) with the reference's ``repro.core.matching``.

Both packages get the same numpy matrices, made from a seed: symmetric
costs of SYNPA's range (pair costs 2-8), at N from 2 to 200, and odd
populations closed by the idle-context vertex (``IDLE_COST`` edges, as the
fused step prepares them).  Every tier must return the same pairs as the
reference's on the same matrix: ``min_cost_pairs`` in all five methods,
``refine_pairs``, ``repair_pairs``, ``_two_opt`` (against
``_two_opt_reference`` too) and ``max_weight_matching``.  A property test
holds ``min_cost_pairs("blossom")`` to the exact ``"dp"`` oracle at
N <= 12.  The device tier's host entry ``device_pairs`` is held to the
reference's on the same matrix.
"""

import pytest

torch = pytest.importorskip("torch")

import hypothesis  # noqa: E402
import hypothesis.strategies as st  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import matching as jmat  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402


def _cost(n, seed, idle=False, dtype=np.float64):
    """A symmetric SYNPA-like cost matrix of ``n`` applications (diagonal
    ``BIG``); with ``idle`` one more vertex, the idle context, whose edges
    cost ``IDLE_COST``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(1.0, 4.0, (n, n))
    c = x + x.T
    if idle:
        c = np.pad(c, ((0, 1), (0, 1)), constant_values=jmat.IDLE_COST)
    np.fill_diagonal(c, jmat.BIG)
    return c.astype(dtype)


def _pairs_of(n, seed):
    perm = np.random.default_rng(seed).permutation(n)
    return [(int(perm[2 * k]), int(perm[2 * k + 1])) for k in range(n // 2)]


SIZES = [2, 4, 8, 16, 64, 128, 200]
ODD = [1, 7, 15, 33, 127, 199]
#: The dp oracle is exponential (N <= 12) and the Python blossom O(N^3)
#: (the tiers use it up to BLOSSOM_MAX_N = 128).
_LIMIT = {"dp": 12, "blossom": 128}
CASES = [(method, n, idle)
         for method in ("blossom", "tiled", "greedy", "dp", "auto")
         for n, idle in [(n, False) for n in SIZES] + [(n, True) for n in ODD]
         if n + idle <= _LIMIT.get(method, 200)]


@pytest.mark.parametrize("method,n,idle", CASES)
def test_min_cost_pairs_matches(method, n, idle):
    v = n + idle
    cost = _cost(n, seed=1000 + v, idle=idle)
    got = tmat.min_cost_pairs(cost, method=method)
    want = jmat.min_cost_pairs(cost, method=method)
    assert got == want
    assert tmat.matching_cost(cost, got) == jmat.matching_cost(cost, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_float32_matrices_and_compact_cost(dtype):
    """The fused step hands the matchers float32 matrices, through
    ``compact_cost`` (contiguous rows are a slice, others a gather)."""
    padded = _cost(40, seed=3, dtype=dtype)
    for rows in (list(range(24)), [0, 3, 5, 9, 11, 20, 22, 39],
                 list(range(1, 40, 2))):
        got = tmat.compact_cost(padded, rows)
        want = jmat.compact_cost(padded, rows)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert tmat.min_cost_pairs(got) == jmat.min_cost_pairs(want)


@pytest.mark.parametrize("n", [8, 32, 96, 200])
@pytest.mark.parametrize("eps,max_swaps", [(1e-9, None), (1e-2, 24),
                                           (1e-2, 3)])
def test_refine_and_two_opt_match(n, eps, max_swaps):
    cost = _cost(n, seed=n)
    start = _pairs_of(n, seed=n + 1)
    got = tmat.refine_pairs(cost, start, max_swaps=max_swaps, eps=eps)
    assert got == jmat.refine_pairs(cost, start, max_swaps=max_swaps, eps=eps)
    # The incremental 2-opt is the full-recompute one, bit for bit.
    assert tmat._two_opt(cost, start, max_swaps=max_swaps, eps=eps) == \
        tmat._two_opt_reference(cost, start, max_swaps=max_swaps, eps=eps)
    assert tmat._two_opt_reference(cost, start, max_swaps=max_swaps,
                                   eps=eps) == \
        jmat._two_opt_reference(cost, start, max_swaps=max_swaps, eps=eps)


@pytest.mark.parametrize("n,n_dirty", [(8, 2), (16, 6), (64, 10),
                                       (200, 40), (200, 140), (33, 10)])
def test_repair_matches(n, n_dirty):
    """Kept pairs plus an even dirty set (arrivals, widows, the idle
    vertex of an odd population); the dirty set past ``BLOSSOM_MAX_N``
    goes through ``min_cost_pairs``."""
    idle = n % 2 == 1
    v = n + idle
    cost = _cost(n, seed=7 * v, idle=idle)
    rng = np.random.default_rng(v)
    dirty = sorted(int(x) for x in rng.choice(v, size=n_dirty,
                                              replace=False))
    rest = [x for x in range(v) if x not in dirty]
    kept = [(rest[2 * k], rest[2 * k + 1]) for k in range(len(rest) // 2)]
    for kw in ({}, {"eps": 1e-2, "max_swaps": 24}):
        got = tmat.repair_pairs(cost, kept, dirty, **kw)
        assert got == jmat.repair_pairs(cost, kept, dirty, **kw)
    assert tmat.repair_pairs(cost, kept + [tuple(dirty[:2])], dirty[2:]) == \
        jmat.repair_pairs(cost, kept + [tuple(dirty[:2])], dirty[2:])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("maxcard", [False, True])
def test_max_weight_matching_matches(seed, maxcard):
    """General graphs: sparse, with negative and tied integer weights."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 40))
    edges = [(i, j, int(rng.integers(-20, 60)))
             for i in range(n) for j in range(i + 1, n)
             if rng.random() < 0.35]
    if not edges:
        edges = [(0, 1, 5)]
    assert tmat.max_weight_matching(edges, maxcardinality=maxcard) == \
        jmat.max_weight_matching(edges, maxcardinality=maxcard)


@hypothesis.given(
    n=st.sampled_from([2, 4, 6, 8, 10, 12]),
    seed=st.integers(0, 2**31 - 1),
)
@hypothesis.settings(max_examples=40, deadline=None)
def test_blossom_is_exact_against_dp(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 9, (n, n)).astype(np.float64)   # ties included
    cost = x + x.T
    np.fill_diagonal(cost, tmat.BIG)
    exact = tmat.matching_cost(cost, tmat._dp_min_cost_pairs(cost))
    got = tmat.min_cost_pairs(cost, method="blossom")
    assert sorted(v for p in got for v in p) == list(range(n))
    assert abs(tmat.matching_cost(cost, got) - exact) <= 1e-9 * exact


@pytest.mark.parametrize("p,n_valid", [(24, 16), (40, 33), (136, 128)])
def test_device_pairs_host_entry_matches(p, n_valid):
    """``device_pairs`` (sort seed + 2-opt on tensors, one partner copy)
    against the reference's on the same padded float32 matrix."""
    rng = np.random.default_rng(p)
    cost = np.full((p, p), jmat.BIG, np.float32)
    slots = np.sort(rng.choice(p - 1, size=n_valid, replace=False))
    x = rng.uniform(1.0, 4.0, (n_valid, n_valid))
    cost[np.ix_(slots, slots)] = (x + x.T).astype(np.float32)
    valid = np.zeros(p, bool)
    valid[slots] = True
    if n_valid % 2:                        # the idle vertex, last row
        cost[p - 1, slots] = cost[slots, p - 1] = jmat.IDLE_COST
        valid[p - 1] = True
    np.fill_diagonal(cost, jmat.BIG)
    copies = tmat.HOST_PARTNER_COPIES
    got = tmat.device_pairs(torch.as_tensor(cost), valid, eps=1e-2)
    assert tmat.HOST_PARTNER_COPIES == copies + 1
    want = jmat.device_pairs(jnp.asarray(cost), valid, eps=1e-2)
    assert got == want
