"""What every driver of the benchmark shares: the run's context, the
chip's peaks, percentiles, the module guard and the result line.

Nothing here imports the program: the drivers do, and only the drivers.
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parents[1]

#: Top-level module names that no process of the benchmark may hold: the
#: JAX stack and the JAX package the program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    workload: str
    config: Dict[str, Any]       # the configuration file, as loaded
    traffic: Dict[str, Any]      # the traffic mix file, as loaded
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0              # perf_counter at process start
    #: Empty in a benchmark run; else the control that stands in the
    #: program's place (each driver names its own).
    control: str = ""


@dataclasses.dataclass
class Check:
    """One number that decides ``correct``: its reading and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to ``run.py``."""

    attempted: int
    failed: int
    checks: List[Check]
    end_to_end: Dict[str, float]           # name -> value (trace 0)
    record: Dict[str, Any]                 # what the per-layer readers read
    memory_peak_bytes: int
    breakdown: Optional[Dict[str, list]] = None
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def peaks(device_name: str) -> Dict[str, float]:
    """The published peaks of the card named ``device_name``
    (``peaks.json``, longest matching key first)."""
    table = json.loads((BENCH / "harness" / "peaks.json").read_text())
    cards = table["cards"]
    for key in sorted(cards, key=len, reverse=True):
        if key in device_name:
            return cards[key]
    raise KeyError(f"no peaks for {device_name!r}; peaks.json has "
                   f"{sorted(cards)}")


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) by linear interpolation between
    order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def load_json(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
