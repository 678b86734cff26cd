"""Plain torch version of the all-pairs Eq. 4 pair-scoring kernel.

:func:`pair_costs_plain` is the whole function the CUDA kernel computes:
the CPU path of :func:`repro_torch.kernels.pair_score.ops.pair_costs` and
the version the kernel is held against on the card.
"""

from __future__ import annotations

import torch

MIN_SLOWDOWN = 0.25
MAX_SLOWDOWN = 16.0
DIAG = 1e9


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


def pair_costs_plain(st, coeffs, n_categories: int = 4, n_valid=None):
    """:func:`pair_cost_ref` plus the padding contract: every entry on a
    row or column at or past ``n_valid`` carries the ``DIAG`` sentinel."""
    out = pair_cost_ref(st, coeffs, n_categories)
    n = st.shape[0]
    if n_valid is not None and n_valid < n:
        idx = torch.arange(n, device=st.device)
        invalid = (idx[:, None] >= n_valid) | (idx[None, :] >= n_valid)
        out = torch.where(invalid, DIAG, out)
    return out
