"""One-token GQA decode attention over a KV cache: CUDA kernel
(``kernel``), plain torch version (``ref``) and the device dispatch
(``ops``)."""
