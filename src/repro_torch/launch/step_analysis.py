"""Per-device dot FLOPs and collectives of a step run as DTensors (from
``repro.launch.hlo_analysis``).

The reference compiles a cell on fake devices and parses the HLO text:
every ``dot``'s FLOPs and every collective's payload, each times the trip
count of the loops around it.  The port has no HLO: it runs the cell's
step once, eagerly, on ``meta`` DTensors over a fake process group of
the mesh's size (:func:`~repro_torch.launch.mesh.fake_group`), and
:class:`StepCounter`, a ``TorchDispatchMode``, sees what one rank does:

* the **local** products, counted by ``torch.utils.flop_counter``'s
  registry as the global count (``dryrun.count_flops``) counts them.
  A call on DTensors is handed to DTensor (``NotImplemented``), which
  runs the local op and its collectives, and those come back to the
  mode.  The first time an op meets a layout, DTensor's sharding
  propagator also runs it at its global shapes on ``FakeTensor``
  arguments to learn the output's shape: not the rank's work, skipped;
* every collective that DTensor's redistribution or the port's own mesh
  code issues (``_c10d_functional`` and ``c10d`` ops), under the
  reference's kind names, with its payload as the bytes of its result
  (the reference's ``_COLL_RE`` reads the result type, also for a
  reduce-scatter) and its group size from the op's process group.

An eager step runs every loop iteration, so each op is counted as it runs
and :attr:`CollectiveOp.multiplier` stays 1: the reference's loop
multipliers have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveOp", "StepCounter", "summarize_collectives"]


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_payload: int
    group_size: int
    computation: str = "step"
    multiplier: float = 1.0

    @property
    def wire_bytes(self) -> float:
        """Ring bytes a device sends: all-reduce 2·(g-1)/g, collective-
        permute 1x, the others (g-1)/g of the payload."""
        g = max(self.group_size, 1)
        b = self.bytes_payload * self.multiplier
        if self.kind == "all-reduce":
            return 2.0 * (g - 1) / g * b
        if self.kind == "collective-permute":
            return b
        return (g - 1) / g * b


def summarize_collectives(ops: List[CollectiveOp]
                          ) -> Dict[str, Dict[str, float]]:
    """``{kind: {count, payload, wire}}`` over ``ops``."""
    agg: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "payload": 0.0, "wire": 0.0})
    for op in ops:
        a = agg[op.kind]
        a["count"] += op.multiplier
        a["payload"] += op.bytes_payload * op.multiplier
        a["wire"] += op.wire_bytes
    return dict(agg)


def _kinds() -> Dict[object, str]:
    """Collective op packets → the reference's kind names."""
    fn = torch.ops._c10d_functional
    c10d = torch.ops.c10d
    out = {
        fn.all_reduce: "all-reduce",
        fn.all_reduce_coalesced: "all-reduce",
        fn.all_gather_into_tensor: "all-gather",
        fn.all_gather_into_tensor_coalesced: "all-gather",
        fn.reduce_scatter_tensor: "reduce-scatter",
        fn.reduce_scatter_tensor_coalesced: "reduce-scatter",
        fn.all_to_all_single: "all-to-all",
        c10d.allreduce_: "all-reduce",
        c10d.allreduce_coalesced_: "all-reduce",
        c10d.allgather_: "all-gather",
        c10d._allgather_base_: "all-gather",
        c10d.allgather_into_tensor_coalesced_: "all-gather",
        c10d.reduce_scatter_: "reduce-scatter",
        c10d._reduce_scatter_base_: "reduce-scatter",
        c10d.reduce_scatter_tensor_coalesced_: "reduce-scatter",
        c10d.alltoall_: "all-to-all",
        c10d.alltoall_base_: "all-to-all",
    }
    autograd = getattr(torch.ops, "_c10d_functional_autograd", None)
    if autograd is not None and hasattr(autograd, "all_to_all_single"):
        out[autograd.all_to_all_single] = "all-to-all"
    return out


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(func, args, kwargs) -> int:
    """The size of the op's process group: a functional op names it
    (``group_name``), a ``c10d`` op passes the group object."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    raise ValueError(f"no process group among the arguments of {func}")


class StepCounter(TorchDispatchMode):
    """Counts one rank's dot FLOPs (:attr:`dot_flops`) and collectives
    (:attr:`collectives`) of what runs under it; see the module's
    docstring."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.kinds = _kinds()
        self.dot_flops = 0
        self.collectives: List[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            # DTensor runs first and issues its local ops and collectives,
            # which come back here.
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        kind = self.kinds.get(packet)
        if kind is not None:
            self.collectives.append(CollectiveOp(
                kind, self._payload(packet, args, out),
                _group_size(func, args, kwargs)))
        elif packet in self.registry and not any(
                isinstance(t, FakeTensor) for t in _tensors(list(args))):
            self.dot_flops += int(self.registry[packet](
                *args, **kwargs, out_val=out))
        return out

    @staticmethod
    def _payload(packet, args, out) -> int:
        """The bytes of the op's result: the functional ops return it; the
        in-place ``c10d`` ones write it into their first argument (the
        output tensors, or the tensors reduced in place)."""
        if str(packet).startswith("c10d."):
            return _nbytes(args[0])
        return _nbytes(out)
