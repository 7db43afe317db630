"""Training step of the port (from ``repro.train``)."""
from .train_step import (grads_with_accum, make_compressed_train_step,
                         make_loss_fn, make_train_step)

__all__ = ["grads_with_accum", "make_compressed_train_step", "make_loss_fn",
           "make_train_step"]
