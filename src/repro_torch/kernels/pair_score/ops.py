"""Public entry of the pair-score kernel: device dispatch + padding contract."""

from __future__ import annotations

from repro_torch.kernels.pair_score import kernel
from repro_torch.kernels.pair_score.ref import pair_costs_plain


def pair_costs(st, coeffs, n_categories: int = 4, n_valid=None, valid=None,
               idle_row: int = -1, p=None, idle_flag=None):
    """All-pairs SYNPA pair costs: (rows, 4) ST stacks -> (p, p) f32.

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
    plain torch version; there is no fallback between them.

    ``p`` (default ``rows``) is the padded output size; rows at or past
    ``n_valid`` (default ``min(rows, p)``) are padding, never read, and
    every cost entry touching them carries the ``DIAG`` sentinel.  With
    ``valid`` (an (n_valid,) bool mask) and ``idle_row`` the result is the
    matcher's cost matrix: ``DIAG`` on every entry of an invalid vertex,
    ``IDLE_COST`` between the idle vertex and each valid one; with
    ``idle_flag`` (a one-element bool tensor on ``st``'s device) the idle
    vertex is ``idle_row`` only while the flag holds True (see
    :func:`repro_torch.kernels.pair_score.ref.pair_costs_plain`).
    ``st`` (L, rows, 4) with ``valid`` (L, n_valid) and ``idle_flag`` (L,)
    scores L lanes at once into (L, p, p): one launch on the card.
    """
    if st.device.type == "cuda":
        return kernel.pair_score_cuda(st, coeffs, n_categories, n_valid,
                                      valid, idle_row, p, idle_flag)
    if st.device.type != "cpu":
        raise ValueError(f"pair_costs: no path for device {st.device}")
    return pair_costs_plain(st, coeffs, n_categories, n_valid, valid,
                            idle_row, p, idle_flag)
