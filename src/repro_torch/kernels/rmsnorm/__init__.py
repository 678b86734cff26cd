"""Fused RMSNorm: CUDA kernel (``kernel``), plain torch version (``ref``)
and the device dispatch (``ops``)."""
