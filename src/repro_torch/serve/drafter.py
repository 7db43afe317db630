"""Draft-token providers for speculative decoding (the port's
``repro.serve.drafter``).

A :class:`Drafter` proposes the ``K-1`` cheap draft tokens that ride after
the feed token into each multi-query verify step
(:func:`repro_torch.kernels.ops.paged_verify`).  Its methods run inside
the verify loop on device tensors and never read them back to the host:
the drafter state stays on the card between steps and launches.

Correctness does not depend on the drafter: greedy verify emits the
target model's argmax tokens only, and the first-mismatch acceptance rule
discards every draft the target disagrees with.  A wrong draft costs
throughput, never bits, which is why eviction replay ignores drafter
state.

* :class:`NGramDrafter` — a per-slot bigram table on the device, updated
  from the emitted transitions.  No model arithmetic at all.
* :class:`TinyLMDrafter` — a tied-embedding greedy head,
  ``argmax(embed[t] @ embed.T)`` chained ``K-1`` times.  Give it any
  model's embedding: a :class:`~repro_torch.serve.paged_lm.PagedLM`'s,
  drawn from an explicit ``torch.Generator``, or the JAX reference's,
  carried over with :func:`~repro_torch.serve.paged_lm.params_from_numpy`.

Both are deterministic; the state updates happen in place (the reference
returns a new table, which its scan carries).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

__all__ = ["Drafter", "NGramDrafter", "TinyLMDrafter"]


class Drafter:
    """Protocol for speculative draft-token providers.

    ``state`` is whatever the drafter keeps on the device (possibly
    nothing).  A drafter must not change after construction: one instance
    serves every verify launch of a model.
    """

    def init_state(self, batch: int, device: torch.device) -> Any:
        """Fresh drafter state for ``batch`` slots on ``device``."""
        raise NotImplementedError

    def draft(self, state: Any, feed: torch.Tensor, k: int) -> torch.Tensor:
        """Propose ``k`` draft tokens per slot following ``feed`` (B,).

        Returns (B, k) int32, chained: draft ``i`` continues draft
        ``i-1``.  ``k == 0`` (spec_k == 1) returns a (B, 0) tensor.
        """
        raise NotImplementedError

    def update(self, state: Any, q_tokens: torch.Tensor,
               greedy: torch.Tensor, n_emit: torch.Tensor) -> Any:
        """Fold one verify step's outcome into the state; returns it.

        q_tokens (B, K) are the scored tokens, ``greedy`` (B, K) the
        target's argmax after each, ``n_emit`` (B,) how many were emitted:
        positions ``i < n_emit[b]`` are known transitions
        ``q_tokens[b, i] -> greedy[b, i]``; the rest was rejected
        speculation and must not be learned.
        """
        raise NotImplementedError


def _empty_drafts(feed: torch.Tensor) -> torch.Tensor:
    return torch.zeros((feed.shape[0], 0), dtype=torch.int32,
                       device=feed.device)


class NGramDrafter(Drafter):
    """Per-slot bigram table on the device (token -> predicted next).

    State is a (B, vocab) int32 table, zero at the start (an unseen token
    predicts token 0).  Drafting chains ``k`` lookups from the feed token;
    the update writes each emitted transition, O(B·K) integer work.
    """

    def __init__(self, vocab: int):
        self.vocab = vocab

    def init_state(self, batch: int, device: torch.device) -> torch.Tensor:
        return torch.zeros((batch, self.vocab), dtype=torch.int32,
                           device=device)

    def draft(self, state: torch.Tensor, feed: torch.Tensor,
              k: int) -> torch.Tensor:
        if k == 0:
            return _empty_drafts(feed)
        t = feed.long()
        out = []
        for _ in range(k):
            t = state.gather(1, t[:, None])[:, 0].long()
            out.append(t)
        return torch.stack(out, dim=1).to(torch.int32)

    def update(self, state: torch.Tensor, q_tokens: torch.Tensor,
               greedy: torch.Tensor, n_emit: torch.Tensor) -> torch.Tensor:
        b, k = q_tokens.shape
        rows = torch.arange(b, device=state.device)
        for i in range(k):
            # The reference routes a rejected position out of bounds and
            # drops it; here a masked write puts back the entry's own value,
            # which needs neither a padded table nor a host read-back.
            col = q_tokens[:, i].long()
            keep = i < n_emit
            new = torch.where(keep, greedy[:, i].to(state.dtype),
                              state[rows, col])
            state.index_put_((rows, col), new)
        return state


class TinyLMDrafter(Drafter):
    """Stateless tied-embedding greedy head over a draft embedding matrix.

    ``draft`` chains ``t -> argmax(embed[t] @ embed.T)`` over the first
    ``vocab`` classes: the zero-layer limit of a small
    :class:`~repro_torch.serve.paged_lm.PagedLM` run greedily without a KV
    cache.  ``embed`` is a (vocab, d) float32 tensor on the serving device.
    """

    def __init__(self, embed: torch.Tensor, vocab: Optional[int] = None):
        self.embed = embed
        self.vocab = int(vocab if vocab is not None else embed.shape[0])

    def init_state(self, batch: int, device: torch.device) -> tuple:
        return ()

    def draft(self, state: tuple, feed: torch.Tensor,
              k: int) -> torch.Tensor:
        if k == 0:
            return _empty_drafts(feed)
        t = feed.long()
        out = []
        for _ in range(k):
            logits = self.embed[t] @ self.embed.T
            t = logits[:, : self.vocab].argmax(dim=-1)
            out.append(t)
        return torch.stack(out, dim=1).to(torch.int32)

    def update(self, state: tuple, q_tokens: torch.Tensor,
               greedy: torch.Tensor, n_emit: torch.Tensor) -> tuple:
        return state
