"""ExtGraph on PyTorch and CUDA: the port of the JAX package ``repro``.

Module paths mirror ``repro``.  Entry points build on the CUDA card unless
the caller passes ``device="cpu"``; the join path's kernels are CUDA C++
(``kernels/csrc``), each beside a plain PyTorch version.
"""
