"""Kernels of the port.

``ops`` dispatches each call to a hand-written CUDA kernel (``csrc/``,
built by ``build``) for GPU tensors or to its plain PyTorch version
(``ref``) for CPU tensors: paged decode, paged prefill (also launched as
speculative verify), the indirect and strided stream converters, and the
paper workloads' tiled transpose, ELL SpMV and panel-streamed ELL SpMV.
"""
