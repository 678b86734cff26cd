"""Public entry of the pair-score kernel: device dispatch + padding contract."""

from __future__ import annotations

from repro_torch.kernels.pair_score import kernel
from repro_torch.kernels.pair_score.ref import pair_costs_plain


def pair_costs(st, coeffs, n_categories: int = 4, n_valid=None):
    """All-pairs SYNPA pair costs: (P, 4) ST stacks -> (P, P) f32.

    A CUDA tensor goes to the hand-written kernel, a CPU tensor to the
    plain torch version; there is no fallback between them.

    ``n_valid``: when given, ``st`` is treated as padded — rows at or past
    ``n_valid`` are padding and every cost entry touching them carries the
    ``DIAG`` sentinel, while the result keeps the full padded (P, P) shape.
    """
    if st.device.type == "cuda":
        return kernel.pair_score_cuda(st, coeffs, n_categories, n_valid)
    if st.device.type != "cpu":
        raise ValueError(f"pair_costs: no path for device {st.device}")
    return pair_costs_plain(st, coeffs, n_categories, n_valid)
