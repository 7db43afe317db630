"""The paper's irregular workloads on the port.

* :mod:`.impls` -- ismt, gemv_col, trmv, spmv, pagerank and sssp as PyTorch
  code on the port's kernels, with their exact traffic efficiencies.
* :mod:`.paper` -- the same workloads as cycle models over the bus model
  and the banked endpoint simulator (the paper's Fig. 3 rows).

``python -m repro_torch.workloads [--device cpu]`` runs all six, checks
each against numpy, and prints the traffic efficiencies and the modeled
speed-ups.
"""
