"""Parity of the device matcher ``repro_torch.core.matching`` with the
reference's device tier, on identical prepared cost matrices.

Partner vectors (and 2-opt round counts) must be equal exactly, P <= 64,
on even populations and on odd ones that wire the idle-context vertex, with
and without the clone structure of cluster workloads (many exactly tied
costs, which exercise stable sorts and first-index ``argmin``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import matching as jmat  # noqa: E402
from repro.core.synpa import fused_pad as j_fused_pad  # noqa: E402
from repro_torch.core import matching as tmat  # noqa: E402
from repro_torch.core.synpa import fused_pad  # noqa: E402

SIZES = [6, 7, 16, 63]


def _prepared(n, seed, clones):
    """A cost matrix as the fused step prepares it: (P, P) f32 with ``BIG``
    on self and padding entries and ``IDLE_COST`` edges on row/column ``n``
    of an odd population, plus the validity mask."""
    rng = np.random.default_rng(seed)
    p = fused_pad(n)
    if clones:
        # Eighths: every row sum is exact in float32 whatever the order of
        # summation, so clone rows tie exactly in both packages.
        base = rng.integers(4, 12, (4, 4)) / 8.0
        base = base + base.T
        labels = rng.integers(0, 4, n)
        c = base[labels][:, labels]
    else:
        c = rng.uniform(1.0, 3.0, (n, n))
        c = c + c.T
    cost = np.full((p, p), jmat.BIG, np.float32)
    cost[:n, :n] = c
    np.fill_diagonal(cost, jmat.BIG)
    valid = np.zeros(p, bool)
    valid[:n] = True
    if n % 2 == 1:
        cost[n, :n] = jmat.IDLE_COST
        cost[:n, n] = jmat.IDLE_COST
        valid[n] = True
    return cost, valid


def _random_involution(p, valid, seed):
    """A random perfect matching inside the valid set, padding paired
    consecutively among itself."""
    rng = np.random.default_rng(seed)
    part = np.arange(p)
    v = rng.permutation(np.flatnonzero(valid))
    inv = np.flatnonzero(~valid)
    for group in (v, inv):
        for k in range(0, len(group), 2):
            a, b = group[k], group[k + 1]
            part[a], part[b] = b, a
    return part


def test_constants_and_pad_match():
    assert tmat.BIG == jmat.BIG and tmat.IDLE_COST == jmat.IDLE_COST
    for n in range(1, 200):
        assert fused_pad(n) == j_fused_pad(n)


@pytest.mark.parametrize("clones", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_seed_partner_matches(n, clones):
    cost, valid = _prepared(n, n, clones)
    want = np.asarray(jmat.device_seed_partner(jnp.asarray(cost),
                                               jnp.asarray(valid)))
    got = tmat.device_seed_partner(torch.as_tensor(cost),
                                   torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("clones", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_partner_to_pair_arrays_matches(n, clones):
    cost, valid = _prepared(n, 3 * n, clones)
    part = _random_involution(cost.shape[0], valid, n)
    want = jmat._partner_to_pair_arrays(jnp.asarray(part, jnp.int32),
                                        jnp.asarray(valid))
    got = tmat._partner_to_pair_arrays(torch.as_tensor(part),
                                       torch.as_tensor(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("max_rounds", [1, 8, 9, None])
@pytest.mark.parametrize("clones", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_two_opt_matches(n, clones, max_rounds):
    """From a random carried pairing, with budgets inside, at and across
    the host's convergence-check blocks."""
    cost, valid = _prepared(n, 5 * n + 1, clones)
    part = _random_involution(cost.shape[0], valid, 2 * n)
    want, want_k = jmat.device_two_opt_partner(
        jnp.asarray(cost), jnp.asarray(part, jnp.int32), jnp.asarray(valid),
        eps=1e-2, max_rounds=max_rounds, with_rounds=True)
    got, got_k = tmat.device_two_opt_partner(
        torch.as_tensor(cost), torch.as_tensor(part), torch.as_tensor(valid),
        eps=1e-2, max_rounds=max_rounds, with_rounds=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got_k) == int(want_k)
    # still a fixed-point-free involution that keeps padding apart
    g = got.numpy()
    idx = np.arange(g.size)
    assert (g[g] == idx).all() and (g != idx).all()
    assert (valid[g] == valid).all()


@pytest.mark.parametrize("clones", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_pairs_partner_matches(n, clones):
    cost, valid = _prepared(n, 7 * n + 2, clones)
    budget = 4 * (cost.shape[0] // 2)
    want = jmat.device_pairs_partner(jnp.asarray(cost), jnp.asarray(valid),
                                     eps=1e-2, max_rounds=budget)
    before = tmat.TWO_OPT_SYNCS
    got, rounds = tmat.device_pairs_partner(
        torch.as_tensor(cost), torch.as_tensor(valid), eps=1e-2,
        max_rounds=budget, with_rounds=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The host reads the convergence flag at most once per block of
    # SYNC_EVERY rounds, and only while budget is left.
    syncs = tmat.TWO_OPT_SYNCS - before
    assert syncs <= -(-int(rounds) // tmat.SYNC_EVERY)


def _open_masks(n, seed):
    """Validity masks of two consecutive open-system quanta over the same
    cost matrix: a random subset of the ``n`` slots active, the idle
    vertex (row ``n``) valid exactly when that subset is odd."""
    rng = np.random.default_rng(seed)
    p = fused_pad(n)
    out = []
    for _ in range(2):
        valid = np.zeros(p, bool)
        valid[:n] = rng.random(n) < 0.7
        valid[n] = bool(valid[:n].sum() % 2)
        out.append(valid)
    return out


@pytest.mark.parametrize("max_rounds", [0, 8, None])
@pytest.mark.parametrize("clones", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_repair_partner_matches(n, clones, max_rounds):
    """Churn repair of a pairing carried from the previous quantum's
    membership: the repaired start (no 2-opt round), and with the bounded
    and the full 2-opt, equal to the reference's partner vector exactly."""
    cost, _ = _prepared(n, 9 * n + 3, clones)
    if n % 2 == 0:
        # The idle vertex's edges, for active subsets of odd size.
        cost[n, :n] = jmat.IDLE_COST
        cost[:n, n] = jmat.IDLE_COST
    prev_valid, valid = _open_masks(n, 11 * n + clones)
    part = _random_involution(cost.shape[0], prev_valid, 4 * n)
    want = jmat.device_repair_partner(
        jnp.asarray(cost), jnp.asarray(part, jnp.int32), jnp.asarray(valid),
        eps=1e-2, max_rounds=max_rounds)
    got = tmat.device_repair_partner(
        torch.as_tensor(cost), torch.as_tensor(part), torch.as_tensor(valid),
        eps=1e-2, max_rounds=max_rounds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = got.numpy()
    idx = np.arange(g.size)
    assert (g[g] == idx).all() and (g != idx).all()
    assert (valid[g] == valid).all()
    # Pairs whose two ends stay valid are kept by the repair itself.
    if max_rounds == 0:
        kept = valid & valid[part] & (part != idx)
        np.testing.assert_array_equal(g[kept], part[kept])
