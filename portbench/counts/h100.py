"""Peaks of one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W limit.

Copied from ``repro_torch/launch/roofline.py``, which takes them from
NVIDIA's H100 SXM5 data sheet (dense rates, no sparsity).  A card set
below 700 W runs slower under load; the harness reports the card's power
limit beside every reading against these peaks.
"""

PEAK_BF16_FLOPS = 989.4e12   # FLOP/s, dense bfloat16 on the tensor cores
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # bytes
