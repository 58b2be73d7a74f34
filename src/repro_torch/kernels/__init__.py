"""Hand-written Hopper kernels of the main path (CUDA C++ in ``csrc/``) and
their plain PyTorch versions; ``ops`` dispatches between them by device."""
