"""Operations and bytes of causal attention with a sliding window.

Counted from the shapes, as the work the result needs and not as any one
kernel does it: a query at position ``i`` attends keys ``max(0, i - w +
1) .. i`` (every earlier key where ``w`` is 0).  Each attended pair costs
two products over the head dim (``q k`` and ``p v``), each a multiply and
an add, so ``4 * D`` FLOPs for every query head.  Bytes: Q, K and V read
once and the output written once, in the element size given.
"""

from __future__ import annotations

from portbench.counts import h100


def attended_pairs(seq: int, window: int) -> int:
    """Query-key pairs of one head of one sequence of length ``seq``:
    ``sum_i min(i + 1, window)``."""
    if window <= 0 or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def flops(batch: int, seq: int, heads: int, head_dim: int,
          window: int) -> float:
    return 4.0 * batch * heads * head_dim * attended_pairs(seq, window)


def bytes_moved(batch: int, seq: int, heads: int, kv_heads: int,
                head_dim: int, elem_bytes: int) -> float:
    q_and_out = 2 * batch * seq * heads * head_dim
    k_and_v = 2 * batch * seq * kv_heads * head_dim
    return float((q_and_out + k_and_v) * elem_bytes)


def least_seconds(batch: int, seq: int, heads: int, kv_heads: int,
                  head_dim: int, window: int, elem_bytes: int) -> float:
    """The roofline's least time of one call: the larger of its FLOPs over
    the bfloat16 peak and its bytes over the HBM bandwidth."""
    return max(flops(batch, seq, heads, head_dim, window)
               / h100.PEAK_BF16_FLOPS,
               bytes_moved(batch, seq, heads, kv_heads, head_dim, elem_bytes)
               / h100.HBM_BW)
