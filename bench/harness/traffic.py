"""The one generator of serving traffic: request sizes and arrivals from a
traffic file's parameters and the run's seed.

Every seed gets the same sizes: each length distribution is read at
``GRID`` evenly spaced quantiles, drawn in blocks of ``BLOCK`` that each
hold an even sample of the distribution, and the seed only orders the
sizes within a block (and draws the tokens).  So two seeds differ in
order, not in work, over any stretch of ``BLOCK`` requests.

A traffic file (``bench/traffic/<name>.json``) for serving holds::

    {"driver": "serve", "loop": "closed" | "poisson",
     "clients": 128,             # closed loop: clients, each one request
                                 #   in flight, the next sent when it ends
     "rate_per_s": 4.0,          # poisson: arrivals per second
     "prompt": {"median": 256, "sigma": 0.8, "min": 64, "max": 1024},
     "output": {"median": 1536, "sigma": 0.6, "min": 256, "max": 3072},
     "block": 64,                # sizes evenly spread over every 64 draws
     "serve": {"slots": 128, "max_len": 4096, "page": 16,
               "pool_pages": 32768, "chunk": 256, "kv_dtype": "bf16"},
     ...}

Lengths are lognormal with the given median and log-space ``sigma``,
clipped to [min, max].  Each closed-loop client's first request starts
part-way through, as a client of a server in steady state is found: its length is drawn in proportion to itself (a
long request is more likely to be under way) and the part already done
is uniform in it; the done part is prefilled during set-up.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

GRID = 4096
#: Draws in which every seed gets the same sizes (see ``_shuffled``).
BLOCK = 64


@dataclasses.dataclass
class Spec:
    """One request: its prompt, the tokens it asks for, and when it is due
    (seconds from the window's start; ``None`` in a closed loop)."""

    prompt: np.ndarray
    max_new: int
    due_s: Optional[float] = None


def length_grid(dist: Dict, n: int = GRID) -> np.ndarray:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of the clipped
    lognormal ``dist``, in increasing order."""
    z = NormalDist()
    mu, sigma = math.log(dist["median"]), dist["sigma"]
    vals = [math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(vals), dist["min"], dist["max"]).astype(np.int64)


class Traffic:
    """Request sizes and arrivals for one run."""

    def __init__(self, params: Dict, seed: int, vocab: int):
        self.params = params
        self.vocab = vocab
        self.rng = np.random.default_rng([seed, 0x5e12e])
        self.prompts = length_grid(params["prompt"])
        self.outputs = length_grid(params["output"])

    def _tokens(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, size=n, dtype=np.int32)

    def _shuffled(self, grid: np.ndarray) -> Iterator:
        """The sorted ``grid`` in blocks of ``block`` values (the traffic
        file's, else ``BLOCK``), block ``b`` holding every ``len(grid) /
        block``-th quantile from offset ``b``: each run of ``block`` draws
        is an even sample of the whole distribution, so a window sees the
        same mix of sizes whatever the seed.  A mix whose window finishes
        few requests takes smaller blocks.  The seed orders the values
        within each block."""
        grid = np.sort(grid)
        stride = len(grid) // self.params.get("block", BLOCK)
        while True:
            for b in range(stride):
                for v in self.rng.permutation(grid[b::stride]):
                    yield v.item()

    def client_streams(self) -> List[Iterator[Spec]]:
        """Closed loop: one endless stream of requests per client.  All
        clients draw from one shared shuffle of the size grids, so the set
        of sizes consumed does not depend on the seed."""
        prompts = self._shuffled(self.prompts)
        outputs = self._shuffled(self.outputs)

        def stream():
            while True:
                yield Spec(self._tokens(next(prompts)), next(outputs))

        return [stream() for _ in range(self.params["clients"])]

    def first_requests(self) -> Tuple[List[Spec], List[Iterator[Spec]]]:
        """Closed loop: each client's first request, found part-way
        through: the output length drawn in proportion to itself at evenly spaced
        quantiles, the part already generated evenly spaced in (0, 1) of
        it; the prompt carries the done part as extra
        tokens and ``max_new`` is what remains.  Returns the first
        requests and the clients' streams of the requests after them."""
        n = self.params["clients"]
        streams = self.client_streams()
        grid = np.sort(self.outputs).astype(np.float64)
        cdf = np.cumsum(grid) / grid.sum()
        q = (np.arange(n) + 0.5) / n
        lengths = grid[np.searchsorted(cdf, q)].astype(np.int64)
        # The (length, done part) pairs are the same for every seed (the
        # pairing is fixed); the seed deals them to the clients.
        done_share = np.random.default_rng(0).permutation(q)
        order = self.rng.permutation(n)
        lengths, done_share = lengths[order], done_share[order]
        firsts = []
        for i, s in enumerate(streams):
            spec = next(s)
            total = int(lengths[i])
            done = min(int(done_share[i] * total), total - 1)
            prompt = np.concatenate([spec.prompt, self._tokens(done)])
            firsts.append(Spec(prompt, total - done))
        return firsts, streams

    def arrivals(self, seconds: float) -> List[Spec]:
        """Open loop: requests due in ``[0, seconds)`` at ``rate_per_s``.
        Gaps are exponential at evenly spaced quantiles, shuffled."""
        rate = self.params["rate_per_s"]
        gaps = -np.log1p(-(np.arange(GRID) + 0.5) / GRID)  # Exp(1) grid
        gap_iter = self._shuffled(gaps)
        prompts = self._shuffled(self.prompts)
        outputs = self._shuffled(self.outputs)
        out, t = [], 0.0
        while True:
            t += next(gap_iter) / rate
            if t >= seconds:
                return out
            out.append(Spec(self._tokens(next(prompts)), next(outputs), t))
