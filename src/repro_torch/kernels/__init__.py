"""Serving kernels of the port.

``ops`` dispatches each call to a hand-written CUDA kernel (``csrc/``,
built by ``build``) for GPU tensors or to its plain PyTorch version
(``ref``) for CPU tensors: paged decode, paged prefill (also launched as
speculative verify) and the indirect and strided stream converters.
"""
