"""Optimizers of the port (AdamW, Adafactor), from ``repro.optim``.  The
int8 error-feedback gradient compression waits for a mesh (ROADMAP A9)."""
from .optimizers import (Optimizer, OptimizerConfig, clip_by_global_norm,
                         cosine_schedule, global_norm, make_optimizer)

__all__ = ["Optimizer", "OptimizerConfig", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "make_optimizer"]
