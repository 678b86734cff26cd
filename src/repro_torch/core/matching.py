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

Lanes.  Every function also takes a leading lane axis: ``cost`` (L, P, P),
``partner`` and ``valid`` (L, P) (a (P,) ``valid`` is shared by all
lanes).  Each lane is matched on its own, with the same operations on the
same values as a call on that lane alone; the 2-opt keeps one
``improved`` flag a lane, freezes a lane whose flag has dropped, and the
host reads whether any lane is still improving once per block of
:data:`SYNC_EVERY` rounds, however many lanes there are.
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
    perfect matching of all P vertices ((L, P) with lanes)."""
    p = cost.shape[-1]
    idx = torch.arange(p, device=cost.device)
    valid = valid.expand(cost.shape[:-1])
    pairable = (valid[..., :, None] & valid[..., None, :]
                & (idx[:, None] != idx[None, :]))
    deg = torch.where(pairable, cost.to(torch.float32), 0.0).sum(-1) \
        / torch.clamp(pairable.sum(-1), min=1)
    order = torch.argsort(torch.where(valid, deg, torch.inf), dim=-1,
                          stable=True)
    nv = valid.sum(-1, keepdim=True)
    # Sorted position k pairs position nv-1-k; the (even) tail of padding
    # positions pairs consecutively.
    mate_pos = torch.where(idx < nv, nv - 1 - idx, nv + ((idx - nv) ^ 1))
    return torch.zeros_like(order).scatter(-1, order,
                                           order.gather(-1, mate_pos))


def _partner_to_pair_arrays(partner, valid):
    """Partner vector -> (P/2,) pair arrays ``(i, j)`` with ``i < j`` plus
    the movable mask (pairs of valid vertices — the only ones the 2-opt may
    touch).  ``partner`` must be a fixed-point-free involution."""
    p = partner.shape[-1]
    idx = torch.arange(p, device=partner.device)
    first = partner > idx
    order = torch.argsort(torch.where(first, idx, p + idx), dim=-1,
                          stable=True)
    nf = first.sum(-1, keepdim=True)
    lead = order[..., : p // 2]
    kk = torch.arange(p // 2, device=partner.device)
    i_arr = torch.where(kk < nf, lead, 0)
    j_arr = torch.where(kk < nf, partner.gather(-1, lead), 0)
    return i_arr, j_arr, valid.expand(partner.shape).gather(-1, i_arr)


def device_two_opt_partner(cost, partner, valid, eps=1e-9,
                           max_rounds: Optional[int] = None,
                           with_rounds: bool = False):
    """Masked 2-opt by parallel mutual-best rounds.

    Each round computes the full (P/2, P/2) swap-delta matrix, every pair
    names its best improving counterpart, and all *mutual* picks are
    applied at once.  Rounds run in blocks of :data:`SYNC_EVERY` under a
    device-side ``improved`` flag (one a lane): a round after one that
    committed nothing changes nothing, so the fixed-round loop is exact,
    and the host reads the flags once per block (only while budget is
    left) to stop early when no lane improves.  ``with_rounds=True`` also
    returns the round count (one a lane), including the final
    unproductive round that proved local optimality.
    """
    global TWO_OPT_SYNCS
    p = partner.shape[-1]
    q = p // 2
    lanes = tuple(partner.shape[:-1])
    if max_rounds is None:
        max_rounds = q
    cost = cost.to(torch.float32)
    i, j, movable = _partner_to_pair_arrays(partner, valid)
    eye = torch.eye(q, dtype=torch.bool, device=cost.device)
    ok_swap = movable[..., :, None] & movable[..., None, :] & ~eye
    rows = torch.arange(q, device=cost.device)
    lane_idx = (torch.arange(lanes[0], device=cost.device)[:, None]
                if lanes else None)

    def at(a, b):
        """``cost[a, b]`` lane by lane, for broadcastable index tensors."""
        if not lanes:
            return cost[a, b]
        return cost[lane_idx if a.dim() == 2 else lane_idx[..., None], a, b]

    def pick(x, k):
        """``x[r, k[r]]`` for every row r."""
        return x.gather(-1, k[..., None])[..., 0]

    def body(i, j):
        cur = at(i, j)
        ic, ir = i[..., :, None], i[..., None, :]
        jc, jr = j[..., :, None], j[..., None, :]
        alt1 = at(ic, ir) + at(jc, jr)
        alt2 = at(ic, jr) + at(jc, ir)
        delta = torch.minimum(alt1, alt2) - (cur[..., :, None]
                                             + cur[..., None, :])
        delta = torch.where(ok_swap, delta, 0.0)
        best = torch.argmin(delta, dim=-1)
        gain = pick(delta, best)
        b = best
        bb = b.gather(-1, b)
        commit = (gain < -eps) & (bb == rows) & (rows < best)
        ib, jb = i.gather(-1, b), j.gather(-1, b)
        use1 = pick(alt1, b) <= pick(alt2, b)
        # Row a keeps i_a and takes i_b (alt1) or j_b (alt2); row b = best[a]
        # keeps the old j_a as its i and j_b (alt1) or i_b (alt2) as its j.
        recv = commit.gather(-1, b) & (bb == rows)
        use1_b = use1.gather(-1, b)
        i_n = torch.where(recv, jb, i)
        j_n = torch.where(commit, torch.where(use1, ib, jb), j)
        j_n = torch.where(recv, torch.where(use1_b, j, i), j_n)
        return i_n, j_n, commit.any(-1, keepdim=True)

    k = torch.zeros(lanes + (1,), dtype=torch.int64, device=cost.device)
    improved = torch.ones(lanes + (1,), dtype=torch.bool, device=cost.device)
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
            if not bool(improved.any()):
                break
    # Rebuild the partner involution: concat(i, j) is a permutation of the
    # vertices, so gathering the mates through its argsort inverts it.
    vert = torch.cat([i, j], -1)
    mate = torch.cat([j, i], -1)
    out = mate.gather(-1, torch.argsort(vert, dim=-1, stable=True))
    if with_rounds:
        return out, k[..., 0]
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


def device_repair_partner(cost, partner, valid, eps=1e-9,
                          max_rounds: Optional[int] = None,
                          with_diag: bool = False):
    """Masked churn repair of a carried partner vector.

    The open system's validity mask changes every quantum (arrivals fill
    slots, departures empty them, the idle vertex toggles with the active
    population's parity) while its shape stays put, so the carried
    matching is repaired, not rebuilt.  ``partner`` is the previous
    quantum's (P,) involution; ``valid`` marks the vertices to match now
    (popcount even).  Pairs whose two ends are both still valid are kept;
    the uncovered valid vertices (the dirty set: arrivals, widows, a
    toggled idle vertex) are ranked by mean pairable cost among
    themselves and paired complementarily, heaviest with lightest;
    invalid vertices pair among themselves by index.  A bounded masked
    2-opt (:func:`device_two_opt_partner`) then ripples the repair
    outward through the kept pairs.

    ``with_diag=True`` returns ``(partner, rounds, n_dirty)``: the 2-opt's
    round count and the number of dirty vertices re-paired (one of each a
    lane) — the telemetry ring's churn-repair counters.  The partner is
    the same either way.
    """
    p = partner.shape[-1]
    idx = torch.arange(p, device=cost.device)
    pt = partner.to(torch.int64)
    valid = valid.expand(pt.shape)
    keep = valid & valid.gather(-1, pt) & (pt != idx)
    dirty = valid & ~keep
    invalid = ~valid
    pairable = (dirty[..., :, None] & dirty[..., None, :]
                & (idx[:, None] != idx[None, :]))
    deg = torch.where(pairable, cost.to(torch.float32), 0.0).sum(-1) \
        / torch.clamp(pairable.sum(-1), min=1)
    # Three-band sort key: dirty vertices first (by degree), then invalid
    # (by index), then kept (by index; they retain their partner below).
    # Degrees are bounded by BIG, so the bands cannot interleave; within a
    # band the float32 keys can round together, and the stable sort then
    # keeps index order, as the reference's does.
    fidx = idx.to(torch.float32)
    key = torch.where(dirty, torch.clamp(deg, max=BIG),
                      torch.where(invalid, 2.0 * BIG + fidx, 4.0 * BIG + fidx))
    order = torch.argsort(key, dim=-1, stable=True)
    nd = dirty.sum(-1, keepdim=True)
    ninv = invalid.sum(-1, keepdim=True)
    mate_pos = torch.where(
        idx < nd, nd - 1 - idx,
        torch.where(idx < nd + ninv, nd + ((idx - nd) ^ 1), idx))
    # ``order`` is a permutation, so its argsort inverts it: a gather in
    # place of the seed's scatter.
    repaired = order.gather(-1, mate_pos).gather(
        -1, torch.argsort(order, dim=-1, stable=True))
    repaired = torch.where(keep, pt, repaired)
    out = device_two_opt_partner(cost, repaired, valid, eps=eps,
                                 max_rounds=max_rounds, with_rounds=with_diag)
    if with_diag:
        return out + (nd[..., 0],)
    return out
