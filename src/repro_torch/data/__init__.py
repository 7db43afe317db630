"""Data pipeline of the port: memmap token shards, deterministic per-host
batching (a numpy copy of ``repro.data``)."""
from .pipeline import (TokenDataset, make_frontend_batch, synthetic_corpus,
                       write_corpus)

__all__ = ["TokenDataset", "make_frontend_batch", "synthetic_corpus",
           "write_corpus"]
