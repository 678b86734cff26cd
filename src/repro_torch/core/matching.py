"""Device tier of the SYNPA matcher (paper Step 3), on tensors.

Consumes the cost matrices that the fused step prepares
(``repro_torch.core.synpa.make_fused_step``): ``BIG`` sentinels on self and
invalid entries, ``IDLE_COST`` edges on the idle-context vertex.  The
matching is a **partner vector** — ``partner[v]`` is the vertex matched to
``v`` — the shape-stable carry of the closed race.

Validity contract: ``valid`` marks the vertices to be matched (active
slots, plus the idle-context vertex when the population is odd); its
popcount must be even, and every valid-valid edge must be finite.  Invalid
(padding) vertices are paired among themselves and never mix with valid
ones.

Every sort is stable (``jnp.argsort`` is, ``torch.argsort`` only with
``stable=True``), and ``argmin`` returns the first minimal index, as the
reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

#: Cost of pairing an application with the idle context: both "directions"
#: run interference-free (slowdown 1.0 each).
IDLE_COST = 2.0

#: Sentinel on self-pairings and padding entries of prepared cost matrices
#: (matches the pair-score kernel's ``DIAG``).
BIG = 1e9

#: The 2-opt checks its convergence flag on the host once every this many
#: rounds (and only while budget is left).
SYNC_EVERY = 8

#: Host reads of the 2-opt's ``improved`` flag: the matcher's only
#: device-to-host sync.
TWO_OPT_SYNCS = 0


def device_seed_partner(cost, valid):
    """Complementary sort seed: rank the valid vertices by mean pairable
    cost and pair rank k with rank nv-1-k; invalid vertices pair among
    themselves by rank.  Returns the (P,) int64 partner vector of a
    perfect matching of all P vertices."""
    p = cost.shape[0]
    idx = torch.arange(p, device=cost.device)
    pairable = valid[:, None] & valid[None, :] & (idx[:, None] != idx[None, :])
    deg = torch.where(pairable, cost.to(torch.float32), 0.0).sum(1) \
        / torch.clamp(pairable.sum(1), min=1)
    order = torch.argsort(torch.where(valid, deg, torch.inf), stable=True)
    nv = valid.sum()
    # Sorted position k pairs position nv-1-k; the (even) tail of padding
    # positions pairs consecutively.
    mate_pos = torch.where(idx < nv, nv - 1 - idx, nv + ((idx - nv) ^ 1))
    return torch.zeros_like(order).scatter(0, order, order[mate_pos])


def _partner_to_pair_arrays(partner, valid):
    """Partner vector -> (P/2,) pair arrays ``(i, j)`` with ``i < j`` plus
    the movable mask (pairs of valid vertices — the only ones the 2-opt may
    touch).  ``partner`` must be a fixed-point-free involution."""
    p = partner.shape[0]
    idx = torch.arange(p, device=partner.device)
    first = partner > idx
    order = torch.argsort(torch.where(first, idx, p + idx), stable=True)
    nf = first.sum()
    lead = order[: p // 2]
    kk = torch.arange(p // 2, device=partner.device)
    i_arr = torch.where(kk < nf, lead, 0)
    j_arr = torch.where(kk < nf, partner[lead], 0)
    return i_arr, j_arr, valid[i_arr]


def device_two_opt_partner(cost, partner, valid, eps=1e-9,
                           max_rounds: Optional[int] = None,
                           with_rounds: bool = False):
    """Masked 2-opt by parallel mutual-best rounds.

    Each round computes the full (P/2, P/2) swap-delta matrix, every pair
    names its best improving counterpart, and all *mutual* picks are
    applied at once.  Rounds run in blocks of :data:`SYNC_EVERY` under a
    device-side ``improved`` flag: a round after one that committed
    nothing changes nothing, so the fixed-round loop is exact, and the
    host reads the flag once per block (only while budget is left) to stop
    early.  ``with_rounds=True`` also returns the round count, including
    the final unproductive round that proved local optimality.
    """
    global TWO_OPT_SYNCS
    q = partner.shape[0] // 2
    if max_rounds is None:
        max_rounds = q
    cost = cost.to(torch.float32)
    i, j, movable = _partner_to_pair_arrays(partner, valid)
    eye = torch.eye(q, dtype=torch.bool, device=cost.device)
    ok_swap = movable[:, None] & movable[None, :] & ~eye
    rows = torch.arange(q, device=cost.device)

    def body(i, j):
        cur = cost[i, j]
        alt1 = cost[i[:, None], i[None, :]] + cost[j[:, None], j[None, :]]
        alt2 = cost[i[:, None], j[None, :]] + cost[j[:, None], i[None, :]]
        delta = torch.minimum(alt1, alt2) - (cur[:, None] + cur[None, :])
        delta = torch.where(ok_swap, delta, 0.0)
        best = torch.argmin(delta, dim=1)
        gain = delta[rows, best]
        commit = (gain < -eps) & (best[best] == rows) & (rows < best)
        b = best
        ib, jb = i[b], j[b]
        use1 = alt1[rows, b] <= alt2[rows, b]
        # Row a keeps i_a and takes i_b (alt1) or j_b (alt2); row b = best[a]
        # keeps the old j_a as its i and j_b (alt1) or i_b (alt2) as its j.
        recv = commit[b] & (b[b] == rows)
        use1_b = use1[b]
        i_n = torch.where(recv, jb, i)
        j_n = torch.where(commit, torch.where(use1, ib, jb), j)
        j_n = torch.where(recv, torch.where(use1_b, j, i), j_n)
        return i_n, j_n, commit.any()

    k = torch.zeros((), dtype=torch.int64, device=cost.device)
    improved = torch.ones((), dtype=torch.bool, device=cost.device)
    done = 0
    while done < max_rounds:
        for _ in range(min(SYNC_EVERY, max_rounds - done)):
            i_n, j_n, any_commit = body(i, j)
            i = torch.where(improved, i_n, i)
            j = torch.where(improved, j_n, j)
            k = k + improved.to(torch.int64)
            improved = improved & any_commit
        done = min(done + SYNC_EVERY, max_rounds)
        if done < max_rounds:
            TWO_OPT_SYNCS += 1
            if not bool(improved):
                break
    # Rebuild the partner involution: concat(i, j) is a permutation of the
    # vertices, so gathering the mates through its argsort inverts it.
    vert = torch.cat([i, j])
    mate = torch.cat([j, i])
    out = mate[torch.argsort(vert, stable=True)]
    if with_rounds:
        return out, k
    return out


def device_pairs_partner(cost, valid, eps=1e-9,
                         max_rounds: Optional[int] = None,
                         with_rounds: bool = False):
    """Sort seed + masked 2-opt.  Returns the partner vector (plus the
    2-opt round counter under ``with_rounds=True``)."""
    seed = device_seed_partner(cost, valid)
    return device_two_opt_partner(cost, seed, valid, eps=eps,
                                  max_rounds=max_rounds,
                                  with_rounds=with_rounds)
