"""Hand-written CUDA kernels of the port (Hopper, ``sm_90a``)."""
