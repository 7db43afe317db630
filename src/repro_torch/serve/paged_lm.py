"""Paged transformer engine: an attention-only LM over the page pool.

The port's ``repro.serve.paged_lm``.  :class:`PagedLM` runs the decode and
chunked-prefill steps through the dispatch layer
(:mod:`repro_torch.kernels.ops`): ``paged_kv_write`` (a decode step's
append) and ``paged_kv_write_chunk`` launch the paged K/V write kernel
once a layer for every K/V write, and the paged decode / prefill attention
kernels run every layer.  What the kernels read of the step's tables
(int32 page table, lengths, active flags, starts and counts) is made once
a step and passed to every layer.  The projections ``x @ W`` and the
logits ``x @ embed.T`` stay ``torch.matmul``, as the reference left them
to XLA.  :class:`PagedFamily` is the scheduler-facing
:class:`~repro_torch.serve.family.ServableFamily`.

Where the reference fuses ``n`` decode steps into one ``lax.scan`` launch,
the port runs a Python loop whose greedy argmax stays on the device; the
(n, B) tokens cross to the host once per :meth:`PagedLM.decode_upto`.
Speculative decoding (``spec_k > 1``) does the same for its
draft → append → verify → accept → drafter-update loop
(:meth:`PagedLM.verify_upto`): the emitted tokens and counts cross once per
call.  The pools are updated in place (see :mod:`.kv`).

Every per-token computation is row-wise, so a sequence's tokens do not
depend on the batch it rides in — the property the scheduler's
equivalence with :func:`static_batch_generate` rests on.  On a GPU a matrix
product's rounding can depend on its row count (the library picks its
kernel by shape), so each prefill row's projections and logits run as
their own product, with the same shape whichever batch the row is in.  A
verify step's projections run as one (B·K)-row product, as in the
reference: its shape does not depend on which slots are active, and its
tokens need only equal plain greedy decode's, which a decode step reaches
through another attention kernel anyway.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.packing import (
    Traffic,
    paged_decode_traffic,
    paged_prefill_traffic,
    prefix_share_traffic,
    spec_verify_traffic,
)
from ..core.streams import (
    page_table_streams,
    prefill_table_streams,
    share_table_streams,
    verify_table_streams,
)
from ..device import resolve_device
from ..kernels import ops as kops
from .drafter import Drafter, NGramDrafter
from .family import ServableFamily
from .kv import PagedKVCache, resolve_kv_dtype

__all__ = ["PagedFamily", "PagedLM", "params_from_numpy",
           "static_batch_generate"]

PARAM_NAMES = ("embed", "wq", "wk", "wv", "wo")


def params_from_numpy(params: Dict[str, np.ndarray], device=None,
                      names: Sequence[str] = PARAM_NAMES
                      ) -> Dict[str, torch.Tensor]:
    """The reference model's ``params`` (``embed``, ``wq``, ``wk``, ``wv``,
    ``wo`` as arrays) as float32 tensors on ``device`` (``None`` =
    ``cuda``), so both packages can serve the same weights.

    ``names`` picks a subset: ``names=("embed",)`` carries only the
    embedding, which is all a :class:`~.drafter.TinyLMDrafter` takes."""
    dev = resolve_device(device)
    missing = [k for k in names if k not in params]
    if missing:
        raise KeyError(f"params lack {missing}")
    return {k: torch.tensor(np.asarray(params[k]), dtype=torch.float32,
                            device=dev) for k in names}


def _as_device(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _per_row(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (R, ..., d) as R separate products (see module doc)."""
    return torch.stack([x[i] @ w for i in range(x.shape[0])])


def _decode_step(params, tokens, k_pages, v_pages, k_scale, v_scale,
                 page_table, lengths, active, *, h, kvh, hd, impl):
    """One batched decode step against the paged pool; returns (logits,
    new_lengths) and updates the pools in place.

    tokens (B,) int32; active (B,) bool — inactive slots write nothing, keep
    their length and produce zero attention.
    """
    n_layers = params["wq"].shape[0]
    b = tokens.shape[0]
    quantized = k_scale is not None
    x = params["embed"][tokens.long()]                       # (B, d)
    table = page_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32)
    act = active.to(torch.int32)
    new_len = lengths + active.to(lengths.dtype)
    new_len32 = new_len.to(torch.int32)
    for l in range(n_layers):
        q = (x @ params["wq"][l]).view(b, h, hd)
        kn = (x @ params["wk"][l]).view(b, kvh, hd)
        vn = (x @ params["wv"][l]).view(b, kvh, hd)
        ks, vs = (k_scale[l], v_scale[l]) if quantized else (None, None)
        kops.paged_kv_write(  # the append: a chunk of one token
            k_pages[l], v_pages[l], kn[:, None], vn[:, None], table, lens,
            act, k_scale=ks, v_scale=vs, impl=impl,
        )
        attn = kops.paged_decode_attention(
            q, k_pages[l], v_pages[l], table, new_len32,
            k_scale=ks, v_scale=vs, impl=impl,
        )
        x = x + attn.reshape(b, h * hd) @ params["wo"][l]
    return x @ params["embed"].T, new_len


def _prefill_batch(params, tokens, counts, seqs, starts, k_pages, v_pages,
                   k_scale, v_scale, page_table, lengths, *, h, kvh, hd,
                   ctx_pages, impl):
    """Advance every pending sequence by one prompt chunk; returns the last
    real token's logits per row and the new lengths, and updates the pools
    in place.

    tokens (R, C) int32 (row r zero-padded past ``counts[r]``); ``seqs``
    maps rows to batch slots and ``starts`` gives the position of each
    row's tokens[0].  Rows with ``counts == 0`` are padding and touch
    nothing.  Attention reads only the leading ``ctx_pages`` table entries
    per row.
    """
    n_layers = params["wq"].shape[0]
    r, c = tokens.shape
    quantized = k_scale is not None
    x = params["embed"][tokens.long()]                       # (R, C, d)
    rows = page_table[seqs.long()].to(torch.int32)           # (R, n_pages)
    ctx_rows = rows[:, :ctx_pages].contiguous()
    starts, counts = starts.to(torch.int32), counts.to(torch.int32)
    for l in range(n_layers):
        kn = _per_row(x, params["wk"][l]).view(r, c, kvh, hd)
        vn = _per_row(x, params["wv"][l]).view(r, c, kvh, hd)
        ks, vs = (k_scale[l], v_scale[l]) if quantized else (None, None)
        kops.paged_kv_write_chunk(
            k_pages[l], v_pages[l], kn, vn, rows, starts, counts,
            k_scale=ks, v_scale=vs, impl=impl,
        )
        q = _per_row(x, params["wq"][l]).view(r, c, h, hd)
        attn = kops.paged_prefill_attention(
            q, k_pages[l], v_pages[l], ctx_rows, starts, counts,
            k_scale=ks, v_scale=vs, impl=impl,
        )
        x = x + _per_row(attn.reshape(r, c, h * hd), params["wo"][l])
    last_idx = (counts.long() - 1).clamp(0, c - 1)
    last = x[torch.arange(r, device=x.device), last_idx]     # (R, d)
    logits = _per_row(last[:, None, :], params["embed"].T)[:, 0]
    real = counts > 0
    new_len = lengths.clone()
    new_len[seqs.long()[real]] = (starts + counts)[real].to(lengths.dtype)
    return logits, new_len


def _verify_step(params, q_tokens, k_pages, v_pages, k_scale, v_scale,
                 page_table, lengths, counts, *, h, kvh, hd, ctx_pages,
                 impl):
    """Score K speculative tokens per sequence in one multi-query pass;
    returns per-position logits (B, K, vocab) and updates the pools in
    place.

    q_tokens (B, K) int32: the feed token, then the drafts; row ``b``'s
    token ``i`` sits at position ``lengths[b] + i``.  ``counts`` (B,)
    bounds the valid tokens per row (0..K; 0 = inactive, touches nothing).
    Each layer writes the chunk's K/V through the chunk write (one paged
    K/V write launch), then :func:`~repro_torch.kernels.ops.paged_verify`
    scores all K causal queries in one page walk.  Lengths are not
    advanced here: the accept step owns that, since only accepted tokens
    survive.
    """
    n_layers = params["wq"].shape[0]
    b, k = q_tokens.shape
    quantized = k_scale is not None
    x = params["embed"][q_tokens.long()]                     # (B, K, d)
    table = page_table.to(torch.int32).contiguous()
    ctx_rows = table[:, :ctx_pages].contiguous()
    lengths, counts = lengths.to(torch.int32), counts.to(torch.int32)
    for l in range(n_layers):
        kn = (x @ params["wk"][l]).view(b, k, kvh, hd)
        vn = (x @ params["wv"][l]).view(b, k, kvh, hd)
        ks, vs = (k_scale[l], v_scale[l]) if quantized else (None, None)
        kops.paged_kv_write_chunk(
            k_pages[l], v_pages[l], kn, vn, table, lengths, counts,
            k_scale=ks, v_scale=vs, impl=impl,
        )
        q = (x @ params["wq"][l]).view(b, k, h, hd)
        attn = kops.paged_verify(
            q, k_pages[l], v_pages[l], ctx_rows, lengths, counts,
            k_scale=ks, v_scale=vs, impl=impl,
        )
        x = x + attn.reshape(b, k, h * hd) @ params["wo"][l]
    return x @ params["embed"].T


def _verify_steps(params, feed, dstate, k_pages, v_pages, k_scale, v_scale,
                  page_table, lengths, active, caps, *, drafter, n, spec_k,
                  vocab, h, kvh, hd, ctx_pages, impl):
    """``n`` draft → append → verify → accept → drafter-update iterations,
    all on the device (the reference's ``lax.scan`` is this loop).

    Each iteration drafts ``spec_k - 1`` tokens, scores feed + drafts with
    :func:`_verify_step`, emits the matched draft prefix plus the model's
    bonus token (:func:`~repro_torch.kernels.ops.speculative_accept`) and
    advances the lengths by the emitted count.  That is the whole KV
    rollback: rejected appends lie past the new length, masked out of
    every later attention and overwritten by the next chunk write.
    ``caps`` (B,) is each slot's mapped-token capacity; the scored count is
    clamped on the device to ``clip(caps - lens, 0, spec_k)``, so
    speculation never writes past a slot's pages (0 stalls the slot until
    the scheduler grows it).

    Returns ``(tokens (n, B, K), counts (n, B), feed, dstate, lengths)``
    as device tensors; step ``s`` emitted ``tokens[s, b, :counts[s, b]]``.
    """
    fd, ds, lens = feed, dstate, lengths
    toks, emitted = [], []
    for _ in range(n):
        drafts = drafter.draft(ds, fd, spec_k - 1)           # (B, K-1)
        q_tokens = torch.cat([fd[:, None], drafts], dim=1)
        counts = torch.where(active, (caps - lens).clamp(0, spec_k),
                             torch.zeros_like(lens))
        logits = _verify_step(
            params, q_tokens, k_pages, v_pages, k_scale, v_scale,
            page_table, lens, counts, h=h, kvh=kvh, hd=hd,
            ctx_pages=ctx_pages, impl=impl,
        )
        g = logits[..., :vocab].argmax(dim=-1).to(torch.int32)
        n_emit = kops.speculative_accept(drafts, g, counts)
        last = g.gather(1, (n_emit.long() - 1).clamp(0, spec_k - 1)[:, None])
        fd = torch.where(n_emit > 0, last[:, 0], fd)
        ds = drafter.update(ds, q_tokens, g, n_emit)
        lens = lens + n_emit.to(lens.dtype)
        toks.append(g)
        emitted.append(n_emit)
    return torch.stack(toks), torch.stack(emitted), fd, ds, lens


class PagedLM:
    """Attention-only LM serving straight out of a :class:`PagedKVCache`.

    Tied embeddings, no norms or MLP, float32 math — the reference's
    minimal model.  ``params`` (from :func:`params_from_numpy`) serves given
    weights; otherwise they are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when ``None``) with the
    reference's distributions: ``embed ~ N(0, 1) * 0.02`` and each
    projection ``N(0, 1) / sqrt(fan_in)``.

    ``impl='cuda'`` runs the kernels (their plain versions for CPU tensors);
    ``impl='ref'`` runs the plain versions everywhere.  ``kv_dtype`` is
    ``'fp32'``, ``'bf16'`` (K/V rows rounded to bf16 once, when written,
    and widened to fp32 after each load; the weights, q and all arithmetic
    stay fp32, as in the reference), ``'int8'`` (quantize on write,
    dequantize after each page load), a torch dtype, or ``None`` for the
    config's compute dtype (bf16 for the full-size configs); the matching
    cache must be created with the same ``kv_dtype``.
    ``spec_k > 1`` serves speculatively: each decode launch step scores the
    feed token and ``spec_k - 1`` drafts from ``drafter`` (an
    :class:`~.drafter.NGramDrafter` by default).  ``device=None`` means
    ``cuda``.
    """

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None,
                 impl: str = "cuda", kv_dtype=None, spec_k: int = 1,
                 device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 drafter: Optional[Drafter] = None):
        if spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        if impl not in ("cuda", "ref"):
            raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")
        self.cfg = cfg
        self.impl = impl
        self.spec_k = spec_k
        self.drafter = drafter if drafter is not None else NGramDrafter(
            cfg.vocab)
        self.device = resolve_device(device)
        self.kv_dtype = resolve_kv_dtype(cfg, kv_dtype)
        h, kvh = cfg.heads_for_tp(1)
        self.h, self.kvh, self.hd = h, kvh, cfg.hd
        d, L = cfg.d_model, cfg.n_layers
        shapes = {
            "embed": (cfg.vocab, d),
            "wq": (L, d, h * cfg.hd),
            "wk": (L, d, kvh * cfg.hd),
            "wv": (L, d, kvh * cfg.hd),
            "wo": (L, h * cfg.hd, d),
        }
        if params is None:
            params = self._init_params(shapes, generator)
        for k, shape in shapes.items():
            t = params[k]
            if (tuple(t.shape) != shape or t.dtype != torch.float32
                    or t.device != self.device):
                raise ValueError(
                    f"param {k}: want {shape} float32 on {self.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}"
                )
        self.params = params

    def _init_params(self, shapes, generator):
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)

        def normal(shape):
            return torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=self.device)

        params = {"embed": normal(shapes["embed"]) * 0.02}
        for k in ("wq", "wk", "wv", "wo"):
            params[k] = normal(shapes[k]) / math.sqrt(shapes[k][-2])
        return params

    def bind(self, cache: PagedKVCache) -> "PagedFamily":
        """Wrap this model + ``cache`` as the scheduler-facing family."""
        return PagedFamily(self, cache)

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == torch.int8

    @property
    def kv_token_bytes(self) -> int:
        """FP32-equivalent bytes per live KV token (K+V, all layers) — the
        full-width footprint a packing-oblivious BASE server streams."""
        return 2 * self.cfg.n_layers * self.kvh * self.hd * 4

    @property
    def kv_elem_bits(self) -> int:
        """Element width of the KV pools on the stream (32, 16 or 8
        bits)."""
        return self.kv_dtype.itemsize * 8

    @property
    def kv_scale_token_bytes(self) -> int:
        """Scale bytes PACK moves per live KV token (int8 mode): one fp32
        scale per (token, kv-head) per pool per layer."""
        return 2 * self.cfg.n_layers * self.kvh * 4 if self.quantized else 0

    def _pools(self, cache: PagedKVCache):
        return (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale)

    # -- decode --------------------------------------------------------------

    def _shift_lengths(self, cache: PagedKVCache, active, steps: int):
        if cache.lengths_host is None:
            return None
        return (cache.lengths_host
                + steps * np.asarray(active).astype(np.int32))

    def _step(self, feed, cache, lengths, active):
        return _decode_step(
            self.params, feed, *self._pools(cache), cache.page_table,
            lengths, active, h=self.h, kvh=self.kvh, hd=self.hd,
            impl=self.impl,
        )

    def decode_step(self, tokens, cache: PagedKVCache, active):
        """One decode step; returns (logits (B, vocab) on the device,
        cache)."""
        act_host = _host(active).astype(bool)
        logits, new_len = self._step(
            _as_device(tokens, torch.int32, self.device), cache,
            cache.lengths, _as_device(act_host, torch.bool, self.device),
        )
        cache = dataclasses.replace(
            cache, lengths=new_len,
            lengths_host=self._shift_lengths(cache, act_host, 1),
        )
        return logits, cache

    def decode_steps(self, tokens, cache: PagedKVCache, active, n: int):
        """``n`` decode steps with greedy sampling on the device.

        Returns (tokens (n, B) int32 on the device, cache): each step's
        argmax is the next step's input without a host round trip.
        Identical to ``n`` :meth:`decode_step` calls with a host argmax.
        """
        act_host = _host(active).astype(bool)
        act = _as_device(act_host, torch.bool, self.device)
        feed = _as_device(tokens, torch.int32, self.device)
        lens = cache.lengths
        vocab = self.cfg.vocab
        out = []
        for _ in range(n):
            logits, lens = self._step(feed, cache, lens, act)
            feed = logits[:, :vocab].argmax(dim=-1).to(torch.int32)
            out.append(feed)
        cache = dataclasses.replace(
            cache, lengths=lens,
            lengths_host=self._shift_lengths(cache, act_host, n),
        )
        return torch.stack(out), cache

    def decode_upto(self, tokens, cache: PagedKVCache, active, n: int):
        """:meth:`decode_steps`, with the (n, B) tokens brought to the host
        once, here.  Returns (tokens np.ndarray, cache)."""
        toks, cache = self.decode_steps(tokens, cache, active, n)
        return toks.cpu().numpy(), cache

    # -- speculative verify --------------------------------------------------

    def verify_upto(self, tokens, cache: PagedKVCache, active, n: int,
                    dstate):
        """``n`` draft → verify → accept iterations (:func:`_verify_steps`).

        tokens (B,) feed tokens; ``dstate`` the drafter state
        (:meth:`~.drafter.Drafter.init_state`).  The attention context is
        bounded by the pages the furthest slot can reach in this call,
        rounded up to a power of two as in the reference.  Everything stays
        on the device until the stacked tokens and counts cross to the host
        once, here; the host length shadow is then advanced by the emitted
        counts.

        Returns ``(toks (n, B, K) np.ndarray, counts (n, B) np.ndarray,
        cache, dstate)``.
        """
        k = self.spec_k
        b = cache.page_table.shape[0]
        page = cache.page_size
        lens_host = (cache.lengths_host if cache.lengths_host is not None
                     else cache.lengths.cpu().numpy())
        act_host = _host(active).astype(bool)
        caps = np.array([cache._mapped(s) * page for s in range(b)],
                        np.int64)
        hi = np.where(act_host, np.minimum(lens_host + n * k, caps),
                      lens_host)
        need = int(max(1, -(-int(hi.max()) // page)))
        ctx = 1
        while ctx < need:
            ctx *= 2
        ctx = min(ctx, cache.pages_per_seq)
        dev = self.device
        toks, counts, _, dstate, lens = _verify_steps(
            self.params, _as_device(tokens, torch.int32, dev), dstate,
            *self._pools(cache), cache.page_table, cache.lengths,
            _as_device(act_host, torch.bool, dev),
            _as_device(caps, torch.int32, dev),
            drafter=self.drafter, n=n, spec_k=k, vocab=self.cfg.vocab,
            h=self.h, kvh=self.kvh, hd=self.hd, ctx_pages=ctx,
            impl=self.impl,
        )
        both = torch.cat([toks, counts[..., None]], dim=-1).cpu().numpy()
        toks_h, counts_h = both[..., :k], both[..., k]      # one sync
        cache = dataclasses.replace(
            cache, lengths=lens,
            lengths_host=(lens_host + counts_h.sum(axis=0)).astype(
                lens_host.dtype) if cache.lengths_host is not None else None,
        )
        return toks_h, counts_h, cache, dstate

    # -- prefill -------------------------------------------------------------

    def prefill_batch(self, tokens: np.ndarray, counts: np.ndarray,
                      slots: np.ndarray, starts: np.ndarray,
                      cache: PagedKVCache):
        """Advance all pending sequences by one chunk; returns (logits
        (R, vocab) on the device, cache).

        tokens (R, C) int32; counts/slots/starts (R,) host arrays.  Rows
        with ``counts == 0`` are padding.  The attention context is bounded
        by the pages the furthest row needs, rounded up to a power of two as
        in the reference.
        """
        counts = np.asarray(counts, np.int32)
        starts = np.asarray(starts, np.int32)
        slots = np.asarray(slots, np.int32)
        page = cache.page_size
        need = int(max(1, -(-int((starts + counts).max()) // page)))
        ctx = 1
        while ctx < need:
            ctx *= 2
        ctx = min(ctx, cache.pages_per_seq)
        dev = self.device
        logits, new_len = _prefill_batch(
            self.params, _as_device(tokens, torch.int32, dev),
            _as_device(counts, torch.int32, dev),
            _as_device(slots, torch.int32, dev),
            _as_device(starts, torch.int32, dev),
            *self._pools(cache), cache.page_table, cache.lengths,
            h=self.h, kvh=self.kvh, hd=self.hd, ctx_pages=ctx,
            impl=self.impl,
        )
        real = counts > 0
        lens_host = cache.lengths_host
        if lens_host is not None:
            lens_host = lens_host.copy()
            lens_host[slots[real]] = (starts + counts)[real]
        cache = dataclasses.replace(cache, lengths=new_len,
                                    lengths_host=lens_host)
        return logits, cache

    def prefill_chunk(self, tokens, count: int, seq: int, start: int,
                      cache: PagedKVCache):
        """Single-sequence chunked prefill (the R=1 row of the batched
        path)."""
        logits, cache = self.prefill_batch(
            np.asarray(tokens, np.int32)[None, :],
            np.asarray([count], np.int32),
            np.asarray([seq], np.int32),
            np.asarray([start], np.int32),
            cache,
        )
        return logits[0], cache


class PagedFamily(ServableFamily):
    """:class:`ServableFamily` over a :class:`PagedLM` + :class:`PagedKVCache`.

    Resource units are physical pages; traffic accounting is the indirect
    dialect (``page_table_streams`` / ``paged_decode_traffic``, and
    ``verify_table_streams`` / ``spec_verify_traffic`` for speculative
    launches).  The drafter state lives here, on the device, from the first
    verify launch on.
    """

    name = "paged"

    def __init__(self, model: PagedLM, cache: PagedKVCache):
        # Element width drives the traffic accounting AND the math the model
        # runs, so a model/cache width mismatch must fail loudly.
        if model.kv_dtype != cache.k_pages.dtype:
            raise ValueError(
                f"model kv_dtype ({model.kv_dtype}) does not match the cache "
                f"pool dtype ({cache.k_pages.dtype}): create both with the "
                "same kv_dtype"
            )
        if model.device != cache.device:
            raise ValueError(
                f"model on {model.device}, cache on {cache.device}"
            )
        self.model = model
        self.cache = cache
        self._drafter_state = None

    # -- geometry -----------------------------------------------------------

    @property
    def batch(self) -> int:
        return self.cache.page_table.shape[0]

    @property
    def vocab(self) -> int:
        return self.model.cfg.vocab

    @property
    def total_units(self) -> int:
        return self.cache.total_pages

    @property
    def free_units(self) -> int:
        return self.cache.n_free

    @property
    def slot_token_capacity(self) -> int:
        return self.cache.pages_per_seq * self.cache.page_size

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    @property
    def pool_bytes(self) -> int:
        return self.cache.pool_bytes

    def units_for(self, n_tokens: int) -> int:
        return self.cache.pages_for(n_tokens)

    def mapped_units(self, slot: int) -> int:
        return self.cache._mapped(slot)

    def token_capacity(self, slot: int) -> int:
        return self.cache._mapped(slot) * self.cache.page_size

    def state_bytes(self, n_tokens: int) -> int:
        return n_tokens * self.model.kv_token_bytes

    def lengths(self) -> np.ndarray:
        if self.cache.lengths_host is not None:
            return self.cache.lengths_host
        return self.cache.lengths.cpu().numpy()

    def _host_table(self) -> np.ndarray:
        if self.cache.page_table_host is not None:
            return self.cache.page_table_host
        return self.cache.page_table.cpu().numpy()

    # -- lifecycle ----------------------------------------------------------

    def alloc_state(self, slot: int, units: int) -> None:
        self.cache = self.cache.allocate(slot, units)

    def trim(self, slot: int, keep_units: int) -> None:
        self.cache = self.cache.trim(slot, keep_units)

    def release(self, slot: int) -> None:
        self.cache = self.cache.release(slot)

    # -- model compute ------------------------------------------------------

    def prefill_batch(self, tokens, counts, slots, starts):
        logits, self.cache = self.model.prefill_batch(
            tokens, counts, slots, starts, self.cache
        )
        return logits

    def decode_steps(self, tokens, active, n: int) -> np.ndarray:
        out, self.cache = self.model.decode_upto(
            tokens, self.cache, active, n
        )
        return out

    # -- speculative verify --------------------------------------------------

    @property
    def spec_k(self) -> int:
        return self.model.spec_k

    def verify_steps(self, tokens, active,
                     n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` draft → verify → accept steps over ``active`` slots.

        Returns ``(toks (n, B, spec_k), counts (n, B))`` host arrays, one
        sync at the boundary.  The drafter state is kept across launches;
        it only shapes the acceptance rate, so evictions and replays never
        reset it.
        """
        if self._drafter_state is None:
            self._drafter_state = self.model.drafter.init_state(
                self.batch, self.model.device)
        toks, counts, self.cache, self._drafter_state = \
            self.model.verify_upto(
                tokens, self.cache, active, n, self._drafter_state
            )
        return toks, counts

    def verify_account(self, lens0: np.ndarray, active,
                       counts: np.ndarray) -> List[Tuple[Traffic, tuple]]:
        """Per-step (Traffic, streams) of a verify run that just completed,
        rebuilt from the pre-launch length shadow ``lens0`` and the emitted
        ``counts`` (n, B); each step's scored count is re-derived with the
        ``clip(caps - len, 0, spec_k)`` clamp the device loop applied."""
        k = self.model.spec_k
        page = self.cache.page_size
        b = self.batch
        table = np.array(self._host_table())
        slots = np.nonzero(np.asarray(active))[0]
        caps = np.array(
            [self.cache._mapped(s) * page for s in range(b)], np.int64
        )
        lens = np.asarray(lens0, np.int64).copy()
        accounts: List[Tuple[Traffic, tuple]] = []
        for s in range(counts.shape[0]):
            scored = np.zeros((b,), np.int64)
            scored[slots] = np.clip(caps[slots] - lens[slots], 0, k)
            traffic = spec_verify_traffic(
                lens, scored, page, self.cache.pages_per_seq,
                self.model.kv_token_bytes,
                elem_bits=self.model.kv_elem_bits,
                scale_bytes_per_token=self.model.kv_scale_token_bytes,
            )
            streams = verify_table_streams(
                table, lens, scored, page, self.model.kv_token_bytes,
                kv_elem_bits=self.model.kv_elem_bits,
                scale_bytes_per_token=self.model.kv_scale_token_bytes,
            )
            accounts.append((traffic, streams))
            lens += np.asarray(counts[s], np.int64)
        return accounts

    # -- traffic accounting -------------------------------------------------

    def step_streams(self, active, n: int) -> List[Tuple[Traffic, tuple]]:
        """Per-step indirect accounting for the next ``n`` decode steps,
        from the host shadows: the page table before the launch and
        ``lens0 + s + 1`` per step ``s``."""
        b = self.batch
        lens0 = self.lengths().copy()
        table = np.array(self._host_table())
        slots = np.nonzero(np.asarray(active))[0]
        accounts: List[Tuple[Traffic, tuple]] = []
        for s in range(n):
            step_lens = np.zeros((b,), np.int64)
            for slot in slots:
                step_lens[slot] = int(lens0[slot]) + s + 1
            streams = page_table_streams(
                table, step_lens,
                self.cache.page_size, self.model.kv_token_bytes,
                kv_elem_bits=self.model.kv_elem_bits,
                scale_bytes_per_token=self.model.kv_scale_token_bytes,
            )
            traffic = paged_decode_traffic(
                step_lens[step_lens > 0], self.cache.page_size,
                self.cache.pages_per_seq, self.model.kv_token_bytes,
                elem_bits=self.model.kv_elem_bits,
                scale_bytes_per_token=self.model.kv_scale_token_bytes,
            )
            accounts.append((traffic, streams))
        return accounts

    def prefill_account(self, slots, starts, counts) -> Tuple[Traffic, tuple]:
        table = self._host_table()
        traffic = paged_prefill_traffic(
            starts, counts,
            self.cache.page_size, self.cache.pages_per_seq,
            self.model.kv_token_bytes,
            elem_bits=self.model.kv_elem_bits,
            scale_bytes_per_token=self.model.kv_scale_token_bytes,
        )
        streams = prefill_table_streams(
            table[slots],
            starts, counts,
            self.cache.page_size, self.model.kv_token_bytes,
            kv_elem_bits=self.model.kv_elem_bits,
            scale_bytes_per_token=self.model.kv_scale_token_bytes,
        )
        return traffic, streams

    # -- prefix sharing -----------------------------------------------------

    @property
    def supports_prefix_sharing(self) -> bool:
        return self.cache.refcounts is not None

    def share(self, slot: int, unit_ids: List[int]) -> None:
        self.cache = self.cache.share(slot, unit_ids)

    def retain_units(self, unit_ids: List[int]) -> None:
        self.cache = self.cache.retain_pages(unit_ids)

    def release_units(self, unit_ids: List[int]) -> None:
        self.cache = self.cache.release_pages(unit_ids)

    def unit_refcount(self, unit_id: int) -> int:
        return int(self.cache.refcounts[unit_id])

    def slot_unit_ids(self, slot: int) -> List[int]:
        row = self._host_table()[slot]
        return [int(p) for p in row[: self.cache._mapped(slot)]]

    def ensure_writable(self, slot: int, lo_token: int,
                        hi_token: int) -> int:
        self.cache, n_cow = self.cache.ensure_writable(
            slot, lo_token, hi_token
        )
        return n_cow

    def share_account(self, shared_tokens: int,
                      unit_ids: Sequence[int]) -> Tuple[Traffic, tuple]:
        page = self.cache.page_size
        traffic = prefix_share_traffic(
            shared_tokens, len(unit_ids), page,
            self.model.kv_token_bytes,
            elem_bits=self.model.kv_elem_bits,
            scale_bytes_per_token=self.model.kv_scale_token_bytes,
        )
        streams = share_table_streams(
            unit_ids, page, self.model.kv_token_bytes,
            kv_elem_bits=self.model.kv_elem_bits,
            scale_bytes_per_token=self.model.kv_scale_token_bytes,
        )
        return traffic, streams

    # -- invariants ---------------------------------------------------------

    def check_integrity(self, retained: int = 0) -> None:
        self.cache.check_integrity(retained=retained)


def static_batch_generate(
    model: PagedLM,
    cache: PagedKVCache,
    prompts: Sequence[np.ndarray],
    max_new: int,
    chunk: int = 8,
) -> Dict[int, List[int]]:
    """Reference: all prompts prefilled up front, then one static decode batch.

    Built from the same prefill/decode steps the scheduler uses (one-row
    ``prefill_batch`` calls, ``decode_step`` with a host argmax), so
    scheduled continuous batching must reproduce these tokens exactly.
    Requires a pool large enough to hold every sequence at once.
    """
    b = cache.page_table.shape[0]
    if len(prompts) > b:
        raise ValueError("static batch needs one slot per prompt")
    vocab = model.cfg.vocab
    out: Dict[int, List[int]] = {}
    for i, prompt in enumerate(prompts):
        cache = cache.allocate(i, cache.pages_for(len(prompt) + max_new))
        for start in range(0, len(prompt), chunk):
            count = min(chunk, len(prompt) - start)
            buf = np.zeros((chunk,), np.int32)
            buf[:count] = np.asarray(prompt)[start:start + count]
            logits, cache = model.prefill_chunk(buf, count, i, start, cache)
        out[i] = [int(np.argmax(logits.cpu().numpy()[:vocab]))]
    for _ in range(max_new - 1):
        tokens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i in range(len(prompts)):
            tokens[i] = out[i][-1]
            active[i] = True
        logits, cache = model.decode_step(tokens, cache, active)
        nxt = np.argmax(logits.cpu().numpy()[:, :vocab], axis=-1)
        for i in range(len(prompts)):
            out[i].append(int(nxt[i]))
    return out
