"""All-pairs Eq. 4 pair scoring: CUDA kernel (``kernel``), plain torch
version (``ref``) and the device dispatch (``ops``)."""
