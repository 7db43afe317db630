"""repro_torch: the PyTorch and CUDA port of the AXI-Pack system.

A second package beside the JAX reference ``repro``.  It keeps ``repro``'s
module names (``configs``, ``core``, ``kernels``, ``models``, ``serve``),
adds ``workloads`` (the paper's irregular workloads, run with
``python -m repro_torch.workloads``), imports only ``torch``, numpy and
the standard library, and replaces each Pallas TPU kernel on its paths
(paged, speculative and recurrent serving; the paper's workloads) with a
CUDA C++ kernel for Hopper (``kernels/csrc``), built with ``nvcc`` at
first use.

Entry points take ``device=None``, meaning ``cuda``; see :mod:`.device`.
"""
from .device import resolve_device, set_fp32_numerics

__version__ = "0.1.0"

__all__ = ["resolve_device", "set_fp32_numerics"]
