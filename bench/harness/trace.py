"""The traced run's profiler slice and its reduction to a summary.

A driver opens one slice of the window with :meth:`Tracer.start` and
closes it with :meth:`Tracer.stop`; both synchronise the device, so every
kernel of the slice ran inside it.  Inside the slice the driver marks its
calls into the program with :meth:`Tracer.span` (a ``record_function``
range on the host).  The reduction keeps no trace: it returns

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills), and ``window_s``: the slice's wall time;
- ``kernels``: seconds and launches by device operation name;
- ``by_span``: the same, split by the benchmark span that launched each
  operation (the runtime call with the operation's correlation id lies
  inside that span), ``"none"`` outside every span, ``"unlinked"`` where
  no runtime call was recorded;
- ``idle_gaps``: the device's idle gaps, each labelled by the innermost
  span the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

#: Prefix of the benchmark's own host spans.
SPAN_PREFIX = "bench."
#: Host events of the CUDA runtime and driver that start device work.
RUNTIME_PREFIXES = ("cuda", "cu")


class Tracer:
    """One profiler slice; a no-op when ``enabled`` is False."""

    def __init__(self, enabled: bool, sync):
        self.enabled = enabled
        self._sync = sync
        self._prof = None
        self._begin = self._t0 = 0.0
        self.summary: Optional[Dict] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    def due_to_stop(self, seconds: float) -> bool:
        """Whether the slice has run ``seconds`` since it started."""
        return self.active and time.perf_counter() - self._t0 >= seconds

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.summary:
            return
        from torch.profiler import ProfilerActivity, profile

        self._begin = time.perf_counter()
        self._sync()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()   # the profiler's start-up takes seconds
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._sync()
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        t = time.perf_counter()
        self.summary = reduce_events(prof.events(), window_s)
        self.summary["reduce_s"] = time.perf_counter() - t
        # Host time the slice took from the window, the profiler's start-up
        # and the reduction included.
        self.summary["cost_s"] = time.perf_counter() - self._begin


def _is_device(ev) -> bool:
    return getattr(ev.device_type, "name", str(ev.device_type)) in (
        "CUDA", "DeviceType.CUDA")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _index(spans: List[Tuple[float, float, str]]):
    """Spans by name, each list sorted by start: ``{name: (starts,
    intervals)}``."""
    out: Dict[str, Tuple[List[float], List[Tuple[float, float]]]] = {}
    for a, b, name in sorted(spans):
        starts, ivs = out.setdefault(name, ([], []))
        starts.append(a)
        ivs.append((a, b))
    return out


def _innermost(index, t: float) -> str:
    """The name of the shortest span containing host time ``t``, else
    ``"none"``.  Spans of one name do not overlap one another."""
    best, best_len = "none", float("inf")
    for name, (starts, ivs) in index.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ivs[i][1] >= t and ivs[i][1] - ivs[i][0] < best_len:
            best, best_len = name, ivs[i][1] - ivs[i][0]
    return best


def reduce_events(events, window_s: float) -> Dict:
    """The summary described in the module docstring, from a profiler's
    ``events()`` (times in microseconds)."""
    spans: List[Tuple[float, float, str]] = []
    device: List[Tuple[float, float, str, int]] = []
    launched_at: Dict[int, float] = {}
    for ev in events:
        name = ev.name
        if _is_device(ev):
            if name.startswith(SPAN_PREFIX) or getattr(
                    ev, "is_user_annotation", False):
                continue  # the device-side copy of a host annotation
            device.append((ev.time_range.start, ev.time_range.end, name,
                           ev.id))
        elif name.startswith(SPAN_PREFIX):
            spans.append((ev.time_range.start, ev.time_range.end,
                          name[len(SPAN_PREFIX):]))
        elif name.startswith(RUNTIME_PREFIXES) and ev.id:
            # A launch, copy or fill on the host: the device operation it
            # started carries the same correlation id.
            launched_at[ev.id] = ev.time_range.start
    index = _index(spans)

    kernels: Dict[str, List[float]] = {}
    by_span: Dict[str, Dict[str, List[float]]] = {}
    for a, b, name, corr in device:
        t = launched_at.get(corr)
        label = _innermost(index, t) if t is not None else "unlinked"
        for row in (kernels.setdefault(name, [0.0, 0]),
                    by_span.setdefault(label, {}).setdefault(name, [0.0, 0])):
            row[0] += (b - a) / 1e6
            row[1] += 1

    busy = _union([(a, b) for a, b, _, _ in device])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = []
    for (a0, b0), (a1, _) in zip(busy, busy[1:]):
        gaps.append(((a1 - b0) / 1e6, _innermost(index, (b0 + a1) / 2)))
    gaps.sort(reverse=True)
    return {"busy_s": busy_s, "window_s": window_s, "kernels": kernels,
            "by_span": by_span, "idle_gaps": gaps[:10],
            "n_device_ops": len(device)}


def span_kernel_seconds(summary: Dict, span: str, names) -> Tuple[float, int]:
    """Seconds and launches of the device operations whose name contains
    one of ``names``, launched inside benchmark span ``span``."""
    secs, count = 0.0, 0
    for kname, (s, n) in summary["by_span"].get(span, {}).items():
        if any(part in kname for part in names):
            secs += s
            count += n
    return secs, count


def kernel_seconds(summary: Dict, names) -> Tuple[float, int]:
    """Seconds and launches of the device operations whose name contains
    one of ``names``, over the whole slice."""
    secs, count = 0.0, 0
    for kname, (s, n) in summary["kernels"].items():
        if any(part in kname for part in names):
            secs += s
            count += n
    return secs, count


def breakdown(summary: Dict) -> Dict[str, list]:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten longest idle gaps, in seconds."""
    ops = sorted(((s, name) for name, (s, _) in summary["kernels"].items()),
                 reverse=True)[:10]
    return {"device_ops": [[name[:120], s] for s, name in ops],
            "idle_gaps": [[label, s] for s, label in summary["idle_gaps"]]}
