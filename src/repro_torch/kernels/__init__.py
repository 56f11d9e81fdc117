"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with plain versions.

Nothing is built at import: each source compiles with ``nvcc`` on first use
(:mod:`repro_torch.kernels._build`).
"""
