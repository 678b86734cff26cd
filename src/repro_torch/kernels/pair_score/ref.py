"""Plain torch version of the all-pairs Eq. 4 pair-scoring kernel.

:func:`pair_costs_plain` is the whole function the CUDA kernel computes:
the CPU path of :func:`repro_torch.kernels.pair_score.ops.pair_costs` and
the version the kernel is held against on the card.
"""

from __future__ import annotations

import torch

MIN_SLOWDOWN = 0.25
MAX_SLOWDOWN = 16.0
#: Sentinel of the diagonal and of every entry touching an invalid vertex;
#: the matcher's ``BIG``.
DIAG = 1e9
#: Cost of an edge between a valid vertex and the idle-context vertex; the
#: matcher's ``IDLE_COST``.
IDLE_COST = 2.0


def pair_cost_ref(st, coeffs, n_categories: int = 4):
    """st: (N, C) ST stacks; coeffs: (C, 4) rows (alpha, beta, gamma, rho).

    Returns (N, N) f32: cost[i, j] = slowdown(i|j) + slowdown(j|i), diagonal
    set to ``DIAG``.
    """
    st = st.to(torch.float32)
    coeffs = coeffs.to(device=st.device, dtype=torch.float32)
    c = st.shape[-1]
    mask = (torch.arange(c, device=st.device) < n_categories).to(torch.float32)
    a, b, g, r = coeffs[:, 0], coeffs[:, 1], coeffs[:, 2], coeffs[:, 3]
    x_i = st[:, None, :]
    x_j = st[None, :, :]
    pred = (a + b * x_i + g * x_j + r * x_i * x_j) * mask
    s_ij = torch.clamp(torch.clamp(pred, min=0.0).sum(-1),
                       MIN_SLOWDOWN, MAX_SLOWDOWN)
    cost = s_ij + s_ij.T
    idx = torch.arange(st.shape[0], device=st.device)
    return torch.where(idx[:, None] == idx[None, :], DIAG, cost)


def pair_costs_plain(st, coeffs, n_categories: int = 4, n_valid=None,
                     valid=None, idle_row: int = -1, p=None, idle_flag=None):
    """The whole function of the CUDA kernel: :func:`pair_cost_ref` on the
    first ``n_valid`` stacks, padded to (p, p), and the matcher's cost
    preparation.

    ``st`` (rows, C); ``p`` defaults to ``rows`` and ``n_valid`` to
    ``min(rows, p)``; stack rows at or past ``n_valid`` are not read.
    Vertex v is valid when v < n_valid and ``valid[v]`` (``valid``: an
    optional (n_valid,) bool mask).  Every entry whose row or column is not
    valid carries ``DIAG``; with ``idle_row`` >= 0, entries (idle_row, j)
    and (i, idle_row) carry ``IDLE_COST`` where the other side is valid;
    with ``idle_flag`` (a one-element bool tensor) only while it holds
    True, read as a tensor, never on the host.

    Lanes: ``st`` (L, rows, C) with ``valid`` (L, n_valid) and
    ``idle_flag`` (L,) gives (L, p, p), lane by lane: each slab is this
    function of that lane's inputs.
    """
    if st.dim() == 3:
        return torch.stack([
            pair_costs_plain(st[k], coeffs, n_categories, n_valid,
                             None if valid is None else valid[k], idle_row,
                             p, None if idle_flag is None
                             else idle_flag.reshape(-1)[k:k + 1])
            for k in range(st.shape[0])])
    rows = st.shape[0]
    p = rows if p is None else int(p)
    n_valid = min(rows, p) if n_valid is None else min(int(n_valid), p)
    device = st.device
    stp = st[:n_valid].to(torch.float32)
    if p > n_valid:
        stp = torch.cat([stp, stp.new_zeros((p - n_valid, stp.shape[1]))])
    out = pair_cost_ref(stp, coeffs, n_categories)
    idx = torch.arange(p, device=device)
    if n_valid < p:
        invalid = (idx[:, None] >= n_valid) | (idx[None, :] >= n_valid)
        out = torch.where(invalid, DIAG, out)
    if valid is None and idle_row < 0:
        return out
    is_idle = idx == idle_row
    if idle_flag is not None:
        is_idle = is_idle & idle_flag.reshape(())
    if valid is None:
        valid = torch.ones(n_valid, dtype=torch.bool, device=device)
    # The cost preparation of the fused SYNPA step, entry for entry:
    # sentinel out inactive slots, wire the idle vertex.
    validp = torch.cat(
        [valid, torch.zeros(p - n_valid, dtype=torch.bool, device=device)])
    pairv = validp[:, None] & validp[None, :]
    out = torch.where(pairv, out, DIAG)
    out = torch.where(is_idle[:, None] & validp[None, :], IDLE_COST, out)
    out = torch.where(validp[:, None] & is_idle[None, :], IDLE_COST, out)
    return out


def fixed_entries(p: int, n_valid: int, valid=None, idle_row: int = -1,
                  device=None):
    """Where :func:`pair_costs_plain` writes a constant rather than a cost:
    ``(diag, idle)`` bool (p, p) masks of its ``DIAG`` and ``IDLE_COST``
    entries.  A cost can itself equal ``IDLE_COST``, so a check that holds
    the constants exact finds them by position, not by value."""
    validp = torch.zeros(p, dtype=torch.bool, device=device)
    validp[:n_valid] = True if valid is None else valid
    is_idle = torch.arange(p, device=device) == idle_row
    idle = ((is_idle[:, None] & validp[None, :])
            | (validp[:, None] & is_idle[None, :]))
    pair = validp[:, None] & validp[None, :]
    diag = ~idle & (~pair | torch.eye(p, dtype=torch.bool, device=device))
    return diag, idle
