"""Hand-written Hopper kernels (Triton and CUDA C++) with their plain
PyTorch versions; CUDA sources live in ``csrc/``."""
