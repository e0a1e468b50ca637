"""Hand-written CUDA kernels: build-at-first-use loader (``_build``)."""
