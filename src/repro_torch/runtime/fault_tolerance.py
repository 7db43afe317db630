"""Fault tolerance: a preemption-safe training controller and a straggler
watchdog (from ``repro.runtime.fault_tolerance``).

* **Checkpoint/restart**: the controller persists its state tree (params,
  optimizer state) atomically every ``ckpt_every`` steps (async writer)
  and auto-resumes from the newest complete checkpoint; the data pipeline
  is a pure function of the step counter, so a restart replays no data
  and skips none.
* **Straggler mitigation**: a per-step wall-time EMA; a step exceeding
  ``straggler_factor``× the EMA raises a callback, and an optional hard
  ``step_timeout_s`` aborts the run.

Where the reference blocks on ``jax.block_until_ready``, the controller
synchronizes the device of the state's first leaf.  A step function
updates its state in place, so each run starts from the tree it is given
(a resumed run from the restored one).  A run that ends by a simulated
preemption lets its pending checkpoint write finish, so a run resumed
after it sees that checkpoint.

* **Elastic re-scale**: :func:`reshard_state` moves a state tree onto a
  different mesh (another size or layout, e.g. after losing hosts):
  each leaf's full logical value distributed by its new
  ``parallel.sharding.Sharding``.  Checkpoints hold full logical arrays
  too, so ``CheckpointManager.restore`` against a tree of shardings is
  the same move from disk.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..models.common import tree_leaves, tree_paths, tree_unflatten

__all__ = ["FaultToleranceConfig", "StragglerWatchdog", "TrainController",
           "reshard_state"]


@dataclasses.dataclass
class FaultToleranceConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    step_timeout_s: Optional[float] = None
    ema_beta: float = 0.9


class StragglerWatchdog:
    """Wall-clock step monitor with an EMA baseline."""

    def __init__(self, cfg: FaultToleranceConfig,
                 on_straggler: Optional[Callable] = None):
        self.cfg = cfg
        self.ema: Optional[float] = None
        self.stragglers = 0
        self.on_straggler = on_straggler
        self.history: list = []  # observed dt per step (injected included)

    def observe(self, dt: float, injected: float = 0.0) -> bool:
        """Record one step's wall time; True when it counts as a straggler.
        ``injected`` adds synthetic latency without anyone sleeping."""
        dt = dt + injected
        self.history.append(dt)
        is_straggler = False
        if self.ema is not None and dt > self.cfg.straggler_factor * self.ema:
            self.stragglers += 1
            is_straggler = True
            if self.on_straggler:
                self.on_straggler(dt, self.ema)
        if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
            raise TimeoutError(
                f"step took {dt:.1f}s > {self.cfg.step_timeout_s}s")
        # Stragglers do not poison the baseline.
        if self.ema is None:
            self.ema = dt
        elif not is_straggler:
            self.ema = (self.cfg.ema_beta * self.ema
                        + (1 - self.cfg.ema_beta) * dt)
        return is_straggler


def _sync(state: Any) -> None:
    leaves = tree_leaves(state)
    if leaves and isinstance(leaves[0], torch.Tensor) \
            and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class TrainController:
    """Runs a step function with checkpoint/restart and a watchdog.

    ``state`` is a tree ``{params, opt_state, ...}``; ``step_fn(state,
    batch, step) → (state, metrics)``.  ``make_batch(step)`` must be
    deterministic in ``step`` (restart safety).
    """

    def __init__(self, step_fn: Callable, make_batch: Callable[[int], Any],
                 ft: FaultToleranceConfig):
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.ft = ft
        self.ckpt = CheckpointManager(ft.ckpt_dir, keep=ft.keep)
        self.watchdog = StragglerWatchdog(ft)
        self.history: list = []

    def resume_or_init(self, init_state: Any) -> tuple:
        latest = self.ckpt.latest_step()
        if latest is None:
            return init_state, 0
        return self.ckpt.restore(latest, init_state), latest

    def run(self, init_state: Any, n_steps: int,
            preempt_at: Optional[int] = None, log_every: int = 10,
            log_fn: Callable = print) -> Any:
        """Train to ``n_steps`` (absolute).  ``preempt_at`` simulates a
        kill at the start of that step."""
        state, start = self.resume_or_init(init_state)
        try:
            for step in range(start, n_steps):
                if preempt_at is not None and step == preempt_at:
                    # Simulated preemption after the last checkpoint.
                    raise KeyboardInterrupt(
                        f"simulated preemption at step {step}")
                batch = self.make_batch(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch, step)
                _sync(state)
                dt = time.monotonic() - t0
                self.watchdog.observe(dt)
                self.history.append({k: float(v) for k, v in metrics.items()})
                if (step + 1) % self.ft.ckpt_every == 0 or step + 1 == n_steps:
                    self.ckpt.save_async(step + 1, state)
                if (step + 1) % log_every == 0:
                    log_fn(f"step {step + 1}: "
                           + " ".join(f"{k}={float(v):.4f}"
                                      for k, v in metrics.items())
                           + f" ({dt * 1e3:.0f} ms)")
        finally:
            self.ckpt.wait()
        return state


def reshard_state(state: Any, shardings: Any) -> Any:
    """``state`` (tensors or DTensors) on new shardings (a tree of
    ``parallel.sharding.Sharding`` of the same structure): each leaf's
    full value, gathered from its old mesh where it is a DTensor (a
    collective over that mesh), kept on every rank as its new block."""
    from torch.distributed.tensor import DTensor

    out = []
    for (_, leaf), (_, sharding) in zip(tree_paths(state),
                                        tree_paths(shardings)):
        full = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        out.append(sharding.distribute(full.to(
            sharding.mesh.device_mesh.device_type)))
    return tree_unflatten(state, out)
