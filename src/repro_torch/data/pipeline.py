"""Data pipeline: memmap-backed token shards, packing, deterministic
per-host sharding, and synthetic corpora for the examples/tests.

A copy of ``repro.data.pipeline`` (numpy only), kept so the port imports
nothing of ``repro``: a corpus written by either package reads the same
in the other, and both cut the same windows for a step.

Layout on disk: a directory of ``shard_*.bin`` (uint32 token streams) plus
``meta.json``.  The :class:`TokenDataset` cuts fixed-length windows
(seq_len + 1) deterministically from (epoch, host, step), so every host
reads a disjoint slice with no coordination — restart-safe: the loader is a
pure function of the step counter recorded in checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, Optional

import numpy as np


def write_corpus(
    path: str, tokens: np.ndarray, shard_size: int = 1 << 20
) -> None:
    os.makedirs(path, exist_ok=True)
    tokens = np.asarray(tokens, np.uint32)
    n_shards = max(1, -(-len(tokens) // shard_size))
    for i in range(n_shards):
        tokens[i * shard_size : (i + 1) * shard_size].tofile(
            os.path.join(path, f"shard_{i:05d}.bin")
        )
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"n_tokens": int(len(tokens)), "n_shards": n_shards,
                   "shard_size": shard_size}, f)


def synthetic_corpus(path: str, n_tokens: int, vocab: int, seed: int = 0) -> None:
    """A learnable synthetic corpus: order-2 Markov stream (not uniform noise,
    so training loss can actually decrease in the examples)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(min(vocab, 64)) * 0.1, size=min(vocab, 64))
    toks = np.zeros(n_tokens, np.uint32)
    s = 0
    for i in range(n_tokens):
        s = rng.choice(min(vocab, 64), p=trans[s])
        toks[i] = s
    write_corpus(path, toks)


@dataclasses.dataclass
class TokenDataset:
    path: str
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        with open(os.path.join(self.path, "meta.json")) as f:
            self.meta = json.load(f)
        self.shards = [
            np.memmap(os.path.join(self.path, f"shard_{i:05d}.bin"),
                      dtype=np.uint32, mode="r")
            for i in range(self.meta["n_shards"])
        ]
        self.n_tokens = self.meta["n_tokens"]
        self.windows = self.n_tokens // (self.seq_len + 1)
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts

    def _window(self, idx: int) -> np.ndarray:
        start = idx * (self.seq_len + 1)
        out = np.empty(self.seq_len + 1, np.uint32)
        got = 0
        ssz = self.meta["shard_size"]
        while got < self.seq_len + 1:
            sh, off = divmod(start + got, ssz)
            take = min(self.seq_len + 1 - got, ssz - off)
            out[got : got + take] = self.shards[sh][off : off + take]
            got += take
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, host) — disjoint across hosts."""
        base = (step * self.global_batch + self.host_id * self.host_batch)
        idxs = [(base + i) % self.windows for i in range(self.host_batch)]
        rows = np.stack([self._window(i) for i in idxs])
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "targets": rows[:, 1:].astype(np.int32),
            "mask": np.ones((self.host_batch, self.seq_len), np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_frontend_batch(
    batch: Dict[str, np.ndarray], cfg, rng: Optional[np.random.Generator] = None
) -> Dict[str, np.ndarray]:
    """Attach stub modality embeddings (audio frames / ViT patches)."""
    rng = rng or np.random.default_rng(0)
    b, s = batch["tokens"].shape
    if cfg.modality == "audio":
        return {
            "frontend": rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32),
            "targets": batch["targets"],
            "mask": batch["mask"],
        }
    if cfg.modality == "vlm":
        lf = cfg.frontend_len
        return {
            "tokens": batch["tokens"][:, : s - lf],
            "frontend": rng.normal(size=(b, lf, cfg.frontend_dim)).astype(np.float32),
            "targets": batch["targets"],
            "mask": batch["mask"],
        }
    return batch
