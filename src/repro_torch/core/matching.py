"""Pair selection, the paper's Step 3 (Blossom algorithm, Edmonds 1965):
the host tiers in numpy and the device tier on tensors.

Host tiers (numpy copies of the reference's, line for line, so that the
same matrix gives the same pairs):

* :func:`max_weight_matching` — Edmonds' maximum-weight matching for
  general graphs (Galil's primal-dual formulation).  Exact.
* :func:`_dp_min_cost_pairs` — exact bitmask dynamic program, the oracle
  of the tests.
* :func:`_tiled_min_cost_pairs` — greedy seed, exact blossom per tile of
  similar pairs, global 2-opt: the cluster-scale tier.
* :func:`_greedy_min_cost_pairs` — greedy + 2-opt local search.
* :func:`refine_pairs` / :func:`repair_pairs` — the streaming allocator's
  warm re-matching and churn repair.

:func:`min_cost_pairs` picks the engine by N.  Costs are floats; the
blossom scales them to integers so its dual arithmetic is exact.
:func:`compact_cost` gathers the active submatrix of the padded (P, P)
matrix the fused step prepares (once copied to the host).

Device tier (tensors): consumes the padded cost matrices that the fused
step prepares (``repro_torch.core.synpa.make_fused_step``): ``BIG``
sentinels on self and invalid entries, ``IDLE_COST`` edges on the
idle-context vertex.  The matching is a **partner vector** —
``partner[v]`` is the vertex matched to ``v`` — the shape-stable carry of
the closed race.  :func:`device_pairs` is its host entry: pairs out, with
one device-to-host copy of the partner vector.

Validity contract of the device tier: ``valid`` marks the vertices to be
matched (active slots, plus the idle-context vertex when the population is
odd); its popcount must be even, and every valid-valid edge must be
finite.  Invalid (padding) vertices are paired among themselves and never
mix with valid ones.

Every sort of the device tier is stable (``jnp.argsort`` is,
``torch.argsort`` only with ``stable=True``), and ``argmin`` returns the
first minimal index, as the reference's does.  The host tiers keep
numpy's own sorts where the reference uses them.

Lanes.  Every device function also takes a leading lane axis: ``cost``
(L, P, P), ``partner`` and ``valid`` (L, P) (a (P,) ``valid`` is shared by
all lanes).  Each lane is matched on its own, with the same operations on
the same values as a call on that lane alone; the 2-opt keeps one
``improved`` flag a lane, freezes a lane whose flag has dropped, and the
host reads whether any lane is still improving once per block of
:data:`SYNC_EVERY` rounds, however many lanes there are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import to_device

Pairs = List[Tuple[int, int]]

_INT_SCALE = 10**6

#: Cost of pairing an application with the idle context: both "directions"
#: run interference-free (slowdown 1.0 each).
IDLE_COST = 2.0

#: Sentinel on self-pairings and padding entries of prepared cost matrices
#: (matches the pair-score kernel's ``DIAG``).
BIG = 1e9

#: The 2-opt checks its convergence flag on the host once every this many
#: rounds (and only while budget is left).
SYNC_EVERY = 8

#: Host reads of the 2-opt's ``improved`` flag: the device matcher's
#: data-dependent sync.
TWO_OPT_SYNCS = 0

#: Device-to-host copies of a partner vector by :func:`device_pairs`.
HOST_PARTNER_COPIES = 0


def compact_cost(cost: np.ndarray, rows: Sequence[int]) -> np.ndarray:
    """Gather the matching submatrix for the given vertex rows.

    ``cost`` is the padded (P, P) matrix of the fused pipeline, copied to
    the host; ``rows`` lists the active slots — plus the idle vertex row,
    last, when the population is odd.  Returns the dense
    (len(rows), len(rows)) matrix (native dtype) that
    :func:`min_cost_pairs` and the repair/refine tiers operate on;
    position ``k`` corresponds to ``rows[k]``.
    """
    idx = np.asarray(list(rows), dtype=np.int64)
    # The engines widen to float64 themselves where exactness requires it
    # (min_cost_pairs), so the compact matrix keeps the native dtype — and
    # a contiguous active set (every closed population, and open ones
    # before churn fragments the slots) is a zero-copy slice.
    host = np.asarray(cost)
    n = idx.size
    if n and idx[0] == 0 and idx[-1] == n - 1 and (np.diff(idx) == 1).all():
        return host[:n, :n]
    return host[np.ix_(idx, idx)]


# ---------------------------------------------------------------------------
# Edmonds maximum-weight matching (general graphs, primal-dual, exact).
# ---------------------------------------------------------------------------
def max_weight_matching(
    edges: Sequence[Tuple[int, int, int]], maxcardinality: bool = False
) -> List[int]:
    """Maximum-weight matching on a general graph.

    ``edges`` is a list of ``(i, j, weight)`` with integer weights (callers
    must pre-scale floats; exactness of the dual updates requires integers).
    Returns ``mate`` such that ``mate[v]`` is the vertex matched to ``v`` or
    ``-1``.  With ``maxcardinality=True`` the matching has maximum cardinality
    among all matchings, and maximum weight among those.
    """
    if not edges:
        return []

    nedge = len(edges)
    nvertex = 0
    for (i, j, _w) in edges:
        assert i >= 0 and j >= 0 and i != j
        nvertex = max(nvertex, i + 1, j + 1)

    maxweight = max(0, max(w for (_i, _j, w) in edges))

    # endpoint[p] = vertex at endpoint p; edge k has endpoints 2k and 2k+1.
    endpoint = [edges[p // 2][p % 2] for p in range(2 * nedge)]
    # neighbend[v] = remote endpoints of edges incident to v.
    neighbend: List[List[int]] = [[] for _ in range(nvertex)]
    for k in range(nedge):
        i, j, _w = edges[k]
        neighbend[i].append(2 * k + 1)
        neighbend[j].append(2 * k)

    mate = nvertex * [-1]
    # label: 0 = free, 1 = S, 2 = T (per top-level blossom; 5 marks visited).
    label = (2 * nvertex) * [0]
    labelend = (2 * nvertex) * [-1]
    inblossom = list(range(nvertex))
    blossomparent = (2 * nvertex) * [-1]
    blossomchilds: List = (2 * nvertex) * [None]
    blossombase = list(range(nvertex)) + nvertex * [-1]
    blossomendps: List = (2 * nvertex) * [None]
    bestedge = (2 * nvertex) * [-1]
    blossombestedges: List = (2 * nvertex) * [None]
    unusedblossoms = list(range(nvertex, 2 * nvertex))
    dualvar = nvertex * [maxweight] + nvertex * [0]
    allowedge = nedge * [False]
    queue: List[int] = []

    def slack(k: int) -> int:
        i, j, wt = edges[k]
        return dualvar[i] + dualvar[j] - 2 * wt

    def blossom_leaves(b: int):
        if b < nvertex:
            yield b
        else:
            for t in blossomchilds[b]:
                if t < nvertex:
                    yield t
                else:
                    yield from blossom_leaves(t)

    def assign_label(w: int, t: int, p: int) -> None:
        b = inblossom[w]
        assert label[w] == 0 and label[b] == 0
        label[w] = label[b] = t
        labelend[w] = labelend[b] = p
        bestedge[w] = bestedge[b] = -1
        if t == 1:
            queue.extend(blossom_leaves(b))
        elif t == 2:
            base = blossombase[b]
            assert mate[base] >= 0
            assign_label(endpoint[mate[base]], 1, mate[base] ^ 1)

    def scan_blossom(v: int, w: int) -> int:
        """Trace back from v and w; return the common ancestor base or -1."""
        path = []
        base = -1
        while v != -1 or w != -1:
            b = inblossom[v]
            if label[b] & 4:
                base = blossombase[b]
                break
            assert label[b] == 1
            path.append(b)
            label[b] = 5
            assert labelend[b] == mate[blossombase[b]]
            if labelend[b] == -1:
                v = -1  # reached a single (unmatched) vertex
            else:
                v = endpoint[labelend[b]]
                b = inblossom[v]
                assert label[b] == 2
                assert labelend[b] >= 0
                v = endpoint[labelend[b]]
            if w != -1:
                v, w = w, v
        for b in path:
            label[b] = 1
        return base

    def add_blossom(base: int, k: int) -> None:
        """Make a new blossom from edge k with the given base."""
        v, w, _wt = edges[k]
        bb = inblossom[base]
        bv = inblossom[v]
        bw = inblossom[w]
        b = unusedblossoms.pop()
        blossombase[b] = base
        blossomparent[b] = -1
        blossomparent[bb] = b
        blossomchilds[b] = path = []
        blossomendps[b] = endps = []
        while bv != bb:
            blossomparent[bv] = b
            path.append(bv)
            endps.append(labelend[bv])
            assert label[bv] == 2 or (
                label[bv] == 1 and labelend[bv] == mate[blossombase[bv]]
            )
            assert labelend[bv] >= 0
            v = endpoint[labelend[bv]]
            bv = inblossom[v]
        path.append(bb)
        path.reverse()
        endps.reverse()
        endps.append(2 * k)
        while bw != bb:
            blossomparent[bw] = b
            path.append(bw)
            endps.append(labelend[bw] ^ 1)
            assert label[bw] == 2 or (
                label[bw] == 1 and labelend[bw] == mate[blossombase[bw]]
            )
            assert labelend[bw] >= 0
            w = endpoint[labelend[bw]]
            bw = inblossom[w]
        assert label[bb] == 1
        label[b] = 1
        labelend[b] = labelend[bb]
        dualvar[b] = 0
        for leaf in blossom_leaves(b):
            if label[inblossom[leaf]] == 2:
                # This T-vertex now becomes an S-vertex; add it to the queue.
                queue.append(leaf)
            inblossom[leaf] = b
        # Compute the new blossom's best edges.
        bestedgeto = (2 * nvertex) * [-1]
        for bv in path:
            if blossombestedges[bv] is None:
                nblists = [
                    [p // 2 for p in neighbend[leaf]] for leaf in blossom_leaves(bv)
                ]
            else:
                nblists = [blossombestedges[bv]]
            for nblist in nblists:
                for k2 in nblist:
                    i, j, _w2 = edges[k2]
                    if inblossom[j] == b:
                        i, j = j, i
                    bj = inblossom[j]
                    if (
                        bj != b
                        and label[bj] == 1
                        and (bestedgeto[bj] == -1 or slack(k2) < slack(bestedgeto[bj]))
                    ):
                        bestedgeto[bj] = k2
            blossombestedges[bv] = None
            bestedge[bv] = -1
        blossombestedges[b] = [k2 for k2 in bestedgeto if k2 != -1]
        bestedge[b] = -1
        for k2 in blossombestedges[b]:
            if bestedge[b] == -1 or slack(k2) < slack(bestedge[b]):
                bestedge[b] = k2

    def expand_blossom(b: int, endstage: bool) -> None:
        for s in blossomchilds[b]:
            blossomparent[s] = -1
            if s < nvertex:
                inblossom[s] = s
            elif endstage and dualvar[s] == 0:
                expand_blossom(s, endstage)
            else:
                for leaf in blossom_leaves(s):
                    inblossom[leaf] = s
        if (not endstage) and label[b] == 2:
            # Relabel sub-blossoms from the entry child around to the base.
            assert labelend[b] >= 0
            entrychild = inblossom[endpoint[labelend[b] ^ 1]]
            j = blossomchilds[b].index(entrychild)
            if j & 1:
                j -= len(blossomchilds[b])
                jstep = 1
                endptrick = 0
            else:
                jstep = -1
                endptrick = 1
            p = labelend[b]
            while j != 0:
                label[endpoint[p ^ 1]] = 0
                label[endpoint[blossomendps[b][j - endptrick] ^ endptrick ^ 1]] = 0
                assign_label(endpoint[p ^ 1], 2, p)
                allowedge[blossomendps[b][j - endptrick] // 2] = True
                j += jstep
                p = blossomendps[b][j - endptrick] ^ endptrick
                allowedge[p // 2] = True
                j += jstep
            bv = blossomchilds[b][j]
            label[endpoint[p ^ 1]] = label[bv] = 2
            labelend[endpoint[p ^ 1]] = labelend[bv] = p
            bestedge[bv] = -1
            j += jstep
            while blossomchilds[b][j] != entrychild:
                bv = blossomchilds[b][j]
                if label[bv] == 1:
                    j += jstep
                    continue
                leaf = None
                for leaf in blossom_leaves(bv):
                    if label[leaf] != 0:
                        break
                if leaf is not None and label[leaf] != 0:
                    assert label[leaf] == 2
                    assert inblossom[leaf] == bv
                    label[leaf] = 0
                    label[endpoint[mate[blossombase[bv]]]] = 0
                    assign_label(leaf, 2, labelend[leaf])
                j += jstep
        label[b] = labelend[b] = -1
        blossomchilds[b] = blossomendps[b] = None
        blossombase[b] = -1
        blossombestedges[b] = None
        bestedge[b] = -1
        unusedblossoms.append(b)

    def augment_blossom(b: int, v: int) -> None:
        t = v
        while blossomparent[t] != b:
            t = blossomparent[t]
        if t >= nvertex:
            augment_blossom(t, v)
        i = j = blossomchilds[b].index(t)
        if i & 1:
            j -= len(blossomchilds[b])
            jstep = 1
            endptrick = 0
        else:
            jstep = -1
            endptrick = 1
        while j != 0:
            j += jstep
            t = blossomchilds[b][j]
            p = blossomendps[b][j - endptrick] ^ endptrick
            if t >= nvertex:
                augment_blossom(t, endpoint[p])
            j += jstep
            t = blossomchilds[b][j]
            if t >= nvertex:
                augment_blossom(t, endpoint[p ^ 1])
            mate[endpoint[p]] = p ^ 1
            mate[endpoint[p ^ 1]] = p
        blossomchilds[b] = blossomchilds[b][i:] + blossomchilds[b][:i]
        blossomendps[b] = blossomendps[b][i:] + blossomendps[b][:i]
        blossombase[b] = blossombase[blossomchilds[b][0]]
        assert blossombase[b] == blossombase[v]

    def augment_matching(k: int) -> None:
        v, w, _wt = edges[k]
        for (s, p) in ((v, 2 * k + 1), (w, 2 * k)):
            while True:
                bs = inblossom[s]
                assert label[bs] == 1
                assert labelend[bs] == mate[blossombase[bs]]
                if bs >= nvertex:
                    augment_blossom(bs, s)
                mate[s] = p
                if labelend[bs] == -1:
                    break
                t = endpoint[labelend[bs]]
                bt = inblossom[t]
                assert label[bt] == 2
                assert labelend[bt] >= 0
                s = endpoint[labelend[bt]]
                j = endpoint[labelend[bt] ^ 1]
                assert blossombase[bt] == t
                if inblossom[j] >= nvertex:
                    augment_blossom(inblossom[j], j)
                mate[j] = labelend[bt]
                p = labelend[bt] ^ 1

    # Main loop: one stage per augmentation.
    for _stage in range(nvertex):
        label[:] = (2 * nvertex) * [0]
        bestedge[:] = (2 * nvertex) * [-1]
        for b in range(nvertex, 2 * nvertex):
            blossombestedges[b] = None
        allowedge[:] = nedge * [False]
        queue[:] = []
        for v in range(nvertex):
            if mate[v] == -1 and label[inblossom[v]] == 0:
                assign_label(v, 1, -1)
        augmented = False
        while True:
            while queue and not augmented:
                v = queue.pop()
                assert label[inblossom[v]] == 1
                for p in neighbend[v]:
                    k = p // 2
                    w = endpoint[p]
                    if inblossom[v] == inblossom[w]:
                        continue
                    kslack = 0
                    if not allowedge[k]:
                        kslack = slack(k)
                        if kslack <= 0:
                            allowedge[k] = True
                    if allowedge[k]:
                        if label[inblossom[w]] == 0:
                            assign_label(w, 2, p ^ 1)
                        elif label[inblossom[w]] == 1:
                            base = scan_blossom(v, w)
                            if base >= 0:
                                add_blossom(base, k)
                            else:
                                augment_matching(k)
                                augmented = True
                                break
                        elif label[w] == 0:
                            assert label[inblossom[w]] == 2
                            label[w] = 2
                            labelend[w] = p ^ 1
                    elif label[inblossom[w]] == 1:
                        b = inblossom[v]
                        if bestedge[b] == -1 or kslack < slack(bestedge[b]):
                            bestedge[b] = k
                    elif label[w] == 0:
                        if bestedge[w] == -1 or kslack < slack(bestedge[w]):
                            bestedge[w] = k
            if augmented:
                break
            # Dual update.
            deltatype = -1
            delta = deltaedge = deltablossom = None
            if not maxcardinality:
                deltatype = 1
                delta = min(dualvar[:nvertex])
            for v in range(nvertex):
                if label[inblossom[v]] == 0 and bestedge[v] != -1:
                    d = slack(bestedge[v])
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 2
                        deltaedge = bestedge[v]
            for b in range(2 * nvertex):
                if blossomparent[b] == -1 and label[b] == 1 and bestedge[b] != -1:
                    kslack = slack(bestedge[b])
                    d = kslack // 2 if isinstance(kslack, int) else kslack / 2
                    if deltatype == -1 or d < delta:
                        delta = d
                        deltatype = 3
                        deltaedge = bestedge[b]
            for b in range(nvertex, 2 * nvertex):
                if (
                    blossombase[b] >= 0
                    and blossomparent[b] == -1
                    and label[b] == 2
                    and (deltatype == -1 or dualvar[b] < delta)
                ):
                    delta = dualvar[b]
                    deltatype = 4
                    deltablossom = b
            if deltatype == -1:
                # No further improvement possible (max-cardinality optimum).
                deltatype = 1
                delta = max(0, min(dualvar[:nvertex]))
            # Apply the delta to the duals.
            for v in range(nvertex):
                if label[inblossom[v]] == 1:
                    dualvar[v] -= delta
                elif label[inblossom[v]] == 2:
                    dualvar[v] += delta
            for b in range(nvertex, 2 * nvertex):
                if blossombase[b] >= 0 and blossomparent[b] == -1:
                    if label[b] == 1:
                        dualvar[b] += delta
                    elif label[b] == 2:
                        dualvar[b] -= delta
            # Take action on the minimum-delta structure.
            if deltatype == 1:
                break
            elif deltatype == 2:
                allowedge[deltaedge] = True
                i, j, _w2 = edges[deltaedge]
                if label[inblossom[i]] == 0:
                    i, j = j, i
                assert label[inblossom[i]] == 1
                queue.append(i)
            elif deltatype == 3:
                allowedge[deltaedge] = True
                i, j, _w2 = edges[deltaedge]
                assert label[inblossom[i]] == 1
                queue.append(i)
            elif deltatype == 4:
                expand_blossom(deltablossom, False)
        if not augmented:
            break
        # End of stage: expand all S-blossoms with zero dual.
        for b in range(nvertex, 2 * nvertex):
            if (
                blossomparent[b] == -1
                and blossombase[b] >= 0
                and label[b] == 1
                and dualvar[b] == 0
            ):
                expand_blossom(b, True)

    for v in range(nvertex):
        if mate[v] >= 0:
            mate[v] = endpoint[mate[v]]
    return mate


# ---------------------------------------------------------------------------
# Exact bitmask DP oracle (tests) and greedy engine (very large N).
# ---------------------------------------------------------------------------
def _dp_min_cost_pairs(cost: np.ndarray) -> Pairs:
    """Exact minimum-cost perfect matching by subset DP.  O(2^N * N)."""
    n = cost.shape[0]
    assert n % 2 == 0 and n <= 22, "DP oracle limited to small even N"
    full = (1 << n) - 1
    INF = float("inf")
    dp = np.full(1 << n, INF)
    choice = np.full(1 << n, -1, dtype=np.int64)
    dp[0] = 0.0
    for mask in range(1 << n):
        if dp[mask] == INF:
            continue
        # First unset bit.
        i = 0
        while mask >> i & 1:
            i += 1
        if i >= n:
            continue
        for j in range(i + 1, n):
            if not (mask >> j & 1):
                nm = mask | (1 << i) | (1 << j)
                c = dp[mask] + float(cost[i, j])
                if c < dp[nm]:
                    dp[nm] = c
                    choice[nm] = i * n + j
    pairs: Pairs = []
    mask = full
    while mask:
        ij = int(choice[mask])
        i, j = divmod(ij, n)
        pairs.append((i, j))
        mask &= ~((1 << i) | (1 << j))
    return sorted(pairs)


def _two_opt_reference(cost: np.ndarray, pairs: Pairs,
                       max_swaps: Optional[int] = None,
                       eps: float = 1e-9) -> Pairs:
    """Full-recompute best-improvement 2-opt (the pre-incremental reference).

    Each step evaluates every re-pairing of two cores — pair (i, j) with
    pair (k, l) can become (i, k)/(j, l) or (i, l)/(j, k) — as four (P, P)
    gather matrices, applies the single best improving swap and repeats.
    O(P^2) gathers *per swap*; kept verbatim as the semantic reference the
    property tests hold :func:`_two_opt` to, bit for bit.
    """
    p = len(pairs)
    if p < 2:
        return sorted(tuple(sorted(q)) for q in pairs)
    max_swaps = max_swaps if max_swaps is not None else 4 * p
    i = np.array([q[0] for q in pairs], dtype=np.int64)
    j = np.array([q[1] for q in pairs], dtype=np.int64)
    for _ in range(max_swaps):
        cur = cost[i, j]                              # (P,)
        alt1 = cost[np.ix_(i, i)] + cost[np.ix_(j, j)]  # (i,k)+(j,l)
        alt2 = cost[np.ix_(i, j)] + cost[np.ix_(j, i)]  # (i,l)+(j,k)
        delta = np.minimum(alt1, alt2) - (cur[:, None] + cur[None, :])
        np.fill_diagonal(delta, 0.0)
        a, b = np.unravel_index(int(np.argmin(delta)), delta.shape)
        if delta[a, b] >= -eps:
            break
        ia, ja, ib, jb = i[a], j[a], i[b], j[b]
        if alt1[a, b] <= alt2[a, b]:
            i[a], j[a], i[b], j[b] = ia, ib, ja, jb   # (i,k) and (j,l)
        else:
            i[a], j[a], i[b], j[b] = ia, jb, ja, ib   # (i,l) and (j,k)
    return sorted(tuple(sorted((int(x), int(y)))) for x, y in zip(i, j))


def _two_opt(cost: np.ndarray, pairs: Pairs, max_swaps: Optional[int] = None,
             eps: float = 1e-9,
             active_rows: Optional[Sequence[int]] = None) -> Pairs:
    """Incremental best-improvement 2-opt — bit-identical to the reference.

    The four candidate matrices (cur, alt1, alt2 and their combined delta)
    are built once; after a swap touching pairs ``a`` and ``b`` only rows and
    columns ``a``/``b`` are recomputed — the same expressions over the same
    cost entries the full recompute would evaluate, so every iteration's
    delta matrix (and therefore the argmin swap sequence and the final
    pairing) is bit-identical to :func:`_two_opt_reference` while the per-swap
    cost drops from O(P^2) gathers to O(P).

    ``active_rows`` restricts candidate swaps to those involving at least one
    of the given pair indices (delta is symmetric, so row-masking loses
    nothing).  Pairs modified by an applied swap join the active set, letting
    a local repair ripple outward only as far as it actually improves — this
    is the churn path of the online allocator, which touches only the
    rows/columns of arrived or departed applications.
    """
    p = len(pairs)
    if p < 2:
        return sorted(tuple(sorted(q)) for q in pairs)
    max_swaps = max_swaps if max_swaps is not None else 4 * p
    i = np.array([q[0] for q in pairs], dtype=np.int64)
    j = np.array([q[1] for q in pairs], dtype=np.int64)

    cur = cost[i, j]                                  # (P,)
    alt1 = cost[np.ix_(i, i)] + cost[np.ix_(j, j)]    # (i,k)+(j,l)
    alt2 = cost[np.ix_(i, j)] + cost[np.ix_(j, i)]    # (i,l)+(j,k)
    delta = np.minimum(alt1, alt2) - (cur[:, None] + cur[None, :])
    np.fill_diagonal(delta, 0.0)
    if active_rows is None:
        row_mask = None
    else:
        row_mask = np.zeros(p, dtype=bool)
        row_mask[list(active_rows)] = True

    def _refresh_two(r: int, s: int) -> None:
        """Recompute rows+columns ``r`` and ``s`` of the candidate matrices.

        Exactly the expressions the per-row reference refresh evaluates,
        batched over the two touched pairs — the sequential version's
        transient (row ``r`` built against the stale ``cur[s]``) is
        overwritten by the column-``s`` update anyway, so updating ``cur``
        for both pairs first yields bit-identical final matrices at half
        the numpy-call count.
        """
        rs = [r, s]
        cur[rs] = cost[i[rs], j[rs]]
        ir, jr = i[rs][:, None], j[rs][:, None]
        alt1[rs, :] = cost[ir, i[None, :]] + cost[jr, j[None, :]]
        alt1[:, rs] = cost[i[:, None], i[rs][None, :]] + \
            cost[j[:, None], j[rs][None, :]]
        alt2[rs, :] = cost[ir, j[None, :]] + cost[jr, i[None, :]]
        alt2[:, rs] = cost[i[:, None], j[rs][None, :]] + \
            cost[j[:, None], i[rs][None, :]]
        delta[rs, :] = np.minimum(alt1[rs, :], alt2[rs, :]) - (
            cur[rs][:, None] + cur[None, :]
        )
        delta[:, rs] = np.minimum(alt1[:, rs], alt2[:, rs]) - (
            cur[:, None] + cur[rs][None, :]
        )
        delta[r, r] = delta[s, s] = 0.0

    for _ in range(max_swaps):
        view = delta if row_mask is None else np.where(
            row_mask[:, None], delta, 0.0
        )
        a, b = np.unravel_index(int(np.argmin(view)), view.shape)
        if view[a, b] >= -eps:
            break
        ia, ja, ib, jb = i[a], j[a], i[b], j[b]
        if alt1[a, b] <= alt2[a, b]:
            i[a], j[a], i[b], j[b] = ia, ib, ja, jb   # (i,k) and (j,l)
        else:
            i[a], j[a], i[b], j[b] = ia, jb, ja, ib   # (i,l) and (j,k)
        _refresh_two(a, b)
        if row_mask is not None:
            row_mask[a] = row_mask[b] = True
    return sorted(tuple(sorted((int(x), int(y)))) for x, y in zip(i, j))


def refine_pairs(cost: np.ndarray, pairs: Pairs,
                 max_swaps: Optional[int] = None,
                 eps: float = 1e-9) -> Pairs:
    """Re-converge an existing pairing against an updated cost matrix.

    The streaming allocator's warm re-matching tier: instead of re-running
    greedy + per-tile blossom from scratch every quantum, start the
    incremental 2-opt from the previous quantum's pairing.  ``eps`` is the
    minimum improvement a swap must deliver: per-quantum counter noise
    wiggles near-tie pair costs at the ~1e-3 level, and chasing those ties
    costs hundreds of swaps per quantum for no real quality — the streaming
    allocator passes its noise floor (``StreamingConfig.refine_eps``) so the
    2-opt converges in a handful of swaps that actually matter.
    """
    return _two_opt(cost, pairs, max_swaps=max_swaps, eps=eps)


def repair_pairs(cost: np.ndarray, kept_pairs: Pairs,
                 dirty: Sequence[int], eps: float = 1e-9,
                 max_swaps: Optional[int] = None) -> Pairs:
    """Repair a matching after churn: match the ``dirty`` vertices, then run
    a local 2-opt that only considers swaps touching the repaired pairs.

    ``kept_pairs`` are the surviving pairs of the previous matching (both
    endpoints still present); ``dirty`` are the uncovered vertices — arrived
    applications, widows whose partner departed, a previously-solo slot and,
    for odd populations, the idle-context vertex.  Together they must cover
    every vertex exactly once.  The dirty set is matched exactly (blossom;
    it is small under realistic churn), appended, and the incremental 2-opt
    then ripples the repair outward only as far as it improves the matching.
    ``eps`` bounds the minimum improvement per swap (see
    :func:`refine_pairs`).
    """
    dirty = sorted(int(v) for v in dirty)
    assert len(dirty) % 2 == 0, "dirty vertex set must be even"
    if not dirty:
        return sorted(tuple(sorted(q)) for q in kept_pairs)
    if len(dirty) == 2:
        new_pairs: Pairs = [(dirty[0], dirty[1])]
    else:
        idx = np.asarray(dirty, dtype=np.int64)
        sub = np.asarray(cost, dtype=np.float64)[np.ix_(idx, idx)]
        sub_pairs = (
            _exact_blossom_pairs(sub) if len(dirty) <= BLOSSOM_MAX_N
            else min_cost_pairs(sub)
        )
        new_pairs = [(int(idx[a]), int(idx[b])) for a, b in sub_pairs]
    pairs = list(kept_pairs) + new_pairs
    active = range(len(kept_pairs), len(pairs))
    return _two_opt(cost, pairs, active_rows=active, eps=eps,
                    max_swaps=max_swaps)


def _greedy_min_cost_pairs(cost: np.ndarray, two_opt: bool = True) -> Pairs:
    """Greedy matching + vectorised 2-opt local search.  O(N^2 log N)."""
    n = cost.shape[0]
    order = np.dstack(np.unravel_index(np.argsort(cost, axis=None), cost.shape))[0]
    used = np.zeros(n, dtype=bool)
    pairs: Pairs = []
    for i, j in order:
        if i < j and not used[i] and not used[j]:
            used[i] = used[j] = True
            pairs.append((int(i), int(j)))
            if 2 * len(pairs) == n:
                break
    return _two_opt(cost, pairs) if two_opt else sorted(pairs)


def _tiled_min_cost_pairs(cost: np.ndarray, tile: int = 64) -> Pairs:
    """Scalable near-optimal matching: greedy seed -> per-tile blossom ->
    global vectorised 2-opt.

    A greedy matching seeds the solution; its pairs are sorted by cost and
    grouped ``tile // 2`` at a time, so each tile holds applications whose
    greedy partners cost about the same — exactly the pairs a re-matching
    can still improve.  The exact O(tile^3) blossom then re-solves every
    tile (never worse than the greedy seed inside it), and a global 2-opt
    pass repairs the cross-tile seams.  Keeps ``min_cost_pairs``
    near-optimal at N in the thousands without the O(V^3) blowup of a
    whole-graph blossom.
    """
    n = cost.shape[0]
    assert tile % 2 == 0
    seed = _greedy_min_cost_pairs(cost, two_opt=False)
    seed_cost = np.array([cost[i, j] for i, j in seed])
    order = np.argsort(seed_cost, kind="stable")
    pairs: Pairs = []
    per_tile = tile // 2
    for t in range(0, len(seed), per_tile):
        chunk = [seed[k] for k in order[t:t + per_tile]]
        idx = np.array([v for q in chunk for v in q], dtype=np.int64)
        if len(idx) <= 2:
            pairs.append((int(idx[0]), int(idx[1])))
            continue
        sub = cost[np.ix_(idx, idx)]
        pairs.extend(
            (int(idx[a]), int(idx[b])) for a, b in _exact_blossom_pairs(sub)
        )
    return _two_opt(cost, pairs)


def _exact_blossom_pairs(cost: np.ndarray) -> Pairs:
    """Exact min-cost perfect matching via Edmonds (integer-scaled weights)."""
    n = cost.shape[0]
    # Convert min-cost to max-weight with exact integer arithmetic.
    off = ~np.eye(n, dtype=bool)
    finite = np.clip(cost[off], -1e12, 1e12)
    cmax = float(finite.max()) if finite.size else 0.0
    cmin = float(finite.min()) if finite.size else 0.0
    span = max(cmax - cmin, 1e-12)
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            c = min(max(float(cost[i, j]), cmin), cmax)
            w = int(round((cmax - c) / span * _INT_SCALE))
            edges.append((i, j, w))
    mate = max_weight_matching(edges, maxcardinality=True)
    pairs = sorted({tuple(sorted((v, m))) for v, m in enumerate(mate) if m >= 0})
    assert len(pairs) == n // 2, "blossom failed to produce a perfect matching"
    return [tuple(p) for p in pairs]


# The pure-Python blossom is O(V^3): ~0.1 s at N=64, ~1 s at N=128 and ~8 s
# at N=256 — past this the tiled engine (per-tile blossom + global 2-opt)
# takes over.
BLOSSOM_MAX_N = 128
TILE = 64


def min_cost_pairs(cost: np.ndarray, method: str = "auto") -> Pairs:
    """Minimum-total-cost perfect matching of an even set of applications.

    cost: (N, N) symmetric matrix; cost[i, j] = predicted degradation if i and
    j share a core.  Diagonal is ignored.  Returns N/2 sorted (i, j) pairs.

    method:
      'blossom'  exact Edmonds (default for N <= 128);
      'tiled'    per-tile blossom seeds + global vectorised 2-opt (default
                 above 128; near-optimal at N in the thousands);
      'greedy'   greedy seed + 2-opt (fastest, largest N);
      'dp'       exact bitmask oracle (tests, N <= 22);
      'auto'     pick by N.
    """
    cost = np.asarray(cost, dtype=np.float64)
    n = cost.shape[0]
    assert cost.shape == (n, n) and n % 2 == 0, "need an even number of apps"
    if n == 0:
        return []
    if n == 2:
        return [(0, 1)]
    if method == "auto":
        method = "blossom" if n <= BLOSSOM_MAX_N else "tiled"
    if method == "dp":
        return _dp_min_cost_pairs(cost)
    if method == "greedy":
        return _greedy_min_cost_pairs(cost)
    if method == "tiled":
        return _tiled_min_cost_pairs(cost, tile=min(TILE, n))
    assert method == "blossom", method
    return _exact_blossom_pairs(cost)


def matching_cost(cost: np.ndarray, pairs: Pairs) -> float:
    """Total cost of a matching."""
    return float(sum(cost[i, j] for i, j in pairs))


# ---------------------------------------------------------------------------
# Device tier (tensors).
# ---------------------------------------------------------------------------
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


def device_pairs(cost, valid=None, eps: float = 1e-9,
                 max_rounds: Optional[int] = None) -> Pairs:
    """Host entry of the device tier: padded cost (+ valid mask) -> pairs.

    ``cost`` is the (P, P) tensor the fused step prepared, on its device;
    ``valid`` (host bool array) defaults to all vertices.  Runs the sort
    seed + 2-opt there and copies back only the (P,) partner vector (one
    device-to-host copy, counted in :data:`HOST_PARTNER_COPIES`); returns
    the sorted pair list over the *valid* vertices, as
    :func:`min_cost_pairs` does.
    """
    global HOST_PARTNER_COPIES
    p = cost.shape[-1]
    valid_np = (np.ones(p, bool) if valid is None
                else np.asarray(valid, bool))
    assert int(valid_np.sum()) % 2 == 0, "valid vertex count must be even"
    partner = device_pairs_partner(
        cost, to_device(valid_np, torch.bool, cost.device), eps=eps,
        max_rounds=max_rounds)
    HOST_PARTNER_COPIES += 1
    partner = partner.cpu().numpy()
    return sorted(
        (int(v), int(partner[v]))
        for v in range(p)
        if valid_np[v] and v < partner[v]
    )
