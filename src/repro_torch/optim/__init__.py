"""Optimizers of the port (AdamW, Adafactor) and the int8 error-feedback
gradient compression of the data-parallel all-reduce, from
``repro.optim``."""
from . import compression
from .compression import (CHUNK, compressed_grad_psum, flatten_tree,
                          int8_psum, tree_size, unflatten_tree)
from .optimizers import (Optimizer, OptimizerConfig, clip_by_global_norm,
                         cosine_schedule, global_norm, make_optimizer)

__all__ = ["CHUNK", "Optimizer", "OptimizerConfig", "clip_by_global_norm",
           "compressed_grad_psum", "compression", "cosine_schedule",
           "flatten_tree", "global_norm", "int8_psum", "make_optimizer",
           "tree_size", "unflatten_tree"]
