"""Paged KV pool: fixed-size physical pages + per-sequence page tables.

The port's ``PagedKVCache`` (``repro.serve.kv``).  The pools are device
tensors that the model **updates in place**: the JAX engine donates its
pools into every jitted call so XLA aliases the update into the resident
buffer, and an in-place update is the PyTorch form of that.  A cache
object derived from another (``allocate``, ``share``, ...) therefore shares
its pools, and only the newest one should be used.

The host bookkeeping is numpy and copied from the reference unchanged:
``allocate``/``trim``/``release``/``share``/``retain_pages``/
``release_pages``/``ensure_writable``/``check_integrity`` copy the host
state they touch before writing and return a new cache, and the scheduler
reads the host shadows (``lengths_host``/``page_table_host``) instead of
syncing the device on the hot path.  The page table is the AXI-Pack
indirect stream descriptor: the CUDA kernels resolve it on the card.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from .family import OutOfPages

__all__ = ["KV_DTYPES", "OutOfPages", "PagedKVCache", "resolve_kv_dtype"]

#: kv_dtype name → pool dtype.
KV_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "int8": torch.int8,
}


def resolve_kv_dtype(cfg: ArchConfig,
                     kv_dtype: Union[None, str, torch.dtype]) -> torch.dtype:
    """Pool dtype for ``kv_dtype``: a name from :data:`KV_DTYPES`, a torch
    dtype, or ``None`` for the config's compute dtype (bf16 for every
    full-size config, as in the reference)."""
    if kv_dtype is None:
        dt = cfg.compute_dtype
    elif isinstance(kv_dtype, str):
        if kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; have {sorted(KV_DTYPES)}"
            )
        dt = KV_DTYPES[kv_dtype]
    else:
        dt = kv_dtype
    if dt not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"unsupported KV pool dtype {dt}")
    return dt


@dataclasses.dataclass
class PagedKVCache:
    """Physical page pool + per-sequence page tables (one per layer stack).

    ``k_pages``/``v_pages`` are ``(L, P, page, KVH, hd)`` device tensors:
    fp32, bf16 (rows rounded once, when written), or int8 codes with
    ``(L, P, page, KVH)`` fp32 scale pools ``k_scale``/``v_scale``, one
    scale per page token slot per KV head.
    ``page_table`` ``(B, n_pages)`` and ``lengths`` ``(B,)`` are int32
    device tensors with numpy shadows on the host.

    ``refcounts`` makes pages shareable: each physical page counts its
    owners (page-table mappings plus prefix-index retentions) and is
    returned to ``free`` only when the count hits zero.  ``share`` maps
    another sequence's pages by refcount bump, ``ensure_writable`` copies a
    shared page before it is written, and ``retain_pages``/
    ``release_pages`` hold pages alive for a prompt-prefix index.
    """

    k_pages: torch.Tensor     # (L, P, page, KVH, hd)
    v_pages: torch.Tensor
    page_table: torch.Tensor  # (B, n_pages) int32 physical ids
    lengths: torch.Tensor     # (B,) int32
    free: List[int]
    mapped: Optional[np.ndarray] = None  # (B,) pages currently mapped per slot
    lengths_host: Optional[np.ndarray] = None      # (B,) int32 shadow
    page_table_host: Optional[np.ndarray] = None   # (B, n_pages) int32 shadow
    k_scale: Optional[torch.Tensor] = None  # (L, P, page, KVH) fp32, int8 mode
    v_scale: Optional[torch.Tensor] = None
    refcounts: Optional[np.ndarray] = None  # (P,) owners per physical page

    @classmethod
    def create(cls, cfg: ArchConfig, batch: int, max_len: int, page: int = 64,
               tp: int = 1, pool_pages: Optional[int] = None,
               kv_dtype=None, device=None):
        """``kv_dtype`` as in :func:`resolve_kv_dtype` (a
        :class:`repro_torch.serve.paged_lm.PagedLM`'s ``kv_dtype`` keeps the
        two in agreement).  ``device=None`` means ``cuda``."""
        dev = resolve_device(device)
        q_heads, kv_heads = cfg.heads_for_tp(tp)
        n_pages_seq = max_len // page
        pool = pool_pages if pool_pages is not None else batch * n_pages_seq
        dt = resolve_kv_dtype(cfg, kv_dtype)
        shape = (cfg.n_layers, pool, page, kv_heads, cfg.hd)
        quantized = dt == torch.int8
        # Scale init of 1.0 matches int8_quantize on all-zero rows, so an
        # unwritten page dequantizes to exact zeros either way.
        scales = (lambda: torch.ones(shape[:-1], dtype=torch.float32,
                                     device=dev)) if quantized else None
        return cls(
            k_pages=torch.zeros(shape, dtype=dt, device=dev),
            v_pages=torch.zeros(shape, dtype=dt, device=dev),
            page_table=torch.zeros((batch, n_pages_seq), dtype=torch.int32,
                                   device=dev),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
            free=list(range(pool)),
            mapped=np.zeros((batch,), np.int64),
            lengths_host=np.zeros((batch,), np.int32),
            page_table_host=np.zeros((batch, n_pages_seq), np.int32),
            k_scale=scales() if quantized else None,
            v_scale=scales() if quantized else None,
            refcounts=np.zeros((pool,), np.int64),
        )

    @property
    def device(self) -> torch.device:
        return self.k_pages.device

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def pool_bytes(self) -> int:
        """Device bytes held by the K/V pools (scale pools included)."""
        pools = [self.k_pages, self.v_pages]
        if self.quantized:
            pools += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in pools)

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    @property
    def total_pages(self) -> int:
        return self.k_pages.shape[1]

    @property
    def n_free(self) -> int:
        return len(self.free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _device_table(self, pt: np.ndarray) -> torch.Tensor:
        return torch.tensor(pt, dtype=torch.int32, device=self.device)

    def _mapped(self, seq: int) -> int:
        if self.mapped is not None:
            return int(self.mapped[seq])
        if self.lengths_host is not None:
            return self.pages_for(int(self.lengths_host[seq]))
        ln = int(self.lengths[seq])
        return self.pages_for(ln)

    def _host_table(self) -> np.ndarray:
        if self.page_table_host is not None:
            return np.array(self.page_table_host)
        return self.page_table.cpu().numpy()

    def _drop_ref(self, refs: Optional[np.ndarray], free: List[int],
                  page: int) -> None:
        """Drop one owner of ``page``; free it when no owners remain.

        With no refcount array (legacy caches built before sharing) every
        page has exactly one owner and the drop is an immediate free.
        """
        if refs is None:
            free.append(page)
            return
        refs[page] -= 1
        if refs[page] < 0:
            raise AssertionError(f"page {page} refcount went negative")
        if refs[page] == 0:
            free.append(page)

    def allocate(self, seq: int, n_pages: int) -> "PagedKVCache":
        """Map ``n_pages`` new physical pages after the slot's current ones."""
        if n_pages > len(self.free):
            raise OutOfPages(
                f"seq {seq} needs {n_pages} pages, {len(self.free)} free"
            )
        start = self._mapped(seq)
        if start + n_pages > self.pages_per_seq:
            raise OutOfPages(
                f"seq {seq}: {start}+{n_pages} pages exceeds the "
                f"{self.pages_per_seq}-page table row"
            )
        free = list(self.free)
        ids = [free.pop() for _ in range(n_pages)]
        refs = None if self.refcounts is None else self.refcounts.copy()
        if refs is not None:
            for p in ids:
                refs[p] = 1
        pt = self._host_table()
        pt[seq, start:start + n_pages] = ids
        mapped = None if self.mapped is None else self.mapped.copy()
        if mapped is not None:
            mapped[seq] = start + n_pages
        return dataclasses.replace(
            self, page_table=self._device_table(pt), page_table_host=pt,
            free=free, mapped=mapped, refcounts=refs,
        )

    def trim(self, seq: int, keep_pages: int) -> "PagedKVCache":
        """Unmap a slot's pages beyond ``keep_pages``.

        Only meaningful for pages past the written content (lookahead
        over-provisioning): trimmed pages hold no live KV *for this slot*,
        so remapping them later on demand is loss-free.  A trimmed page
        still referenced elsewhere (a prefix sibling or the prefix index)
        is only un-mapped here — it returns to the free pool when its last
        owner drops it.
        """
        used = self._mapped(seq)
        if keep_pages >= used:
            return self
        pt = self._host_table()
        free = list(self.free)
        refs = None if self.refcounts is None else self.refcounts.copy()
        for p in pt[seq, keep_pages:used]:
            self._drop_ref(refs, free, int(p))
        pt[seq, keep_pages:used] = 0
        mapped = None if self.mapped is None else self.mapped.copy()
        if mapped is not None:
            mapped[seq] = keep_pages
        return dataclasses.replace(
            self, page_table=self._device_table(pt), page_table_host=pt,
            free=free, mapped=mapped, refcounts=refs,
        )

    def release(self, seq: int) -> "PagedKVCache":
        """Drop a slot's page mappings (sequence exit / eviction).

        Each page loses this slot as an owner; pages with no remaining
        owners return to the free pool.
        """
        pt = self._host_table()
        used = self._mapped(seq)
        free = list(self.free)
        refs = None if self.refcounts is None else self.refcounts.copy()
        for p in pt[seq, :used]:
            self._drop_ref(refs, free, int(p))
        pt[seq, :] = 0
        if self.lengths_host is not None:
            lengths = self.lengths_host.copy()
        else:
            lengths = self.lengths.cpu().numpy()
        lengths[seq] = 0
        mapped = None if self.mapped is None else self.mapped.copy()
        if mapped is not None:
            mapped[seq] = 0
        return dataclasses.replace(
            self, page_table=self._device_table(pt), page_table_host=pt,
            lengths=torch.tensor(lengths, device=self.device),
            lengths_host=lengths if self.lengths_host is not None else None,
            free=free, mapped=mapped, refcounts=refs,
        )

    # -- prefix sharing ------------------------------------------------------

    def share(self, seq: int, page_ids: List[int]) -> "PagedKVCache":
        """Map already-populated physical pages into ``seq`` by refcount bump.

        The pages' KV contents are untouched — the new sequence reads the
        prefix another sequence prefilled.  Writes into a shared page must
        go through :meth:`ensure_writable` first.
        """
        if not page_ids:
            return self
        if self.refcounts is None:
            raise ValueError("share() requires a refcounted cache")
        start = self._mapped(seq)
        if start + len(page_ids) > self.pages_per_seq:
            raise OutOfPages(
                f"seq {seq}: {start}+{len(page_ids)} shared pages exceeds "
                f"the {self.pages_per_seq}-page table row"
            )
        refs = self.refcounts.copy()
        for p in page_ids:
            if refs[p] <= 0:
                raise AssertionError(f"cannot share unowned page {p}")
            refs[p] += 1
        pt = self._host_table()
        pt[seq, start:start + len(page_ids)] = page_ids
        mapped = None if self.mapped is None else self.mapped.copy()
        if mapped is not None:
            mapped[seq] = start + len(page_ids)
        return dataclasses.replace(
            self, page_table=self._device_table(pt), page_table_host=pt,
            mapped=mapped, refcounts=refs,
        )

    def retain_pages(self, page_ids: List[int]) -> "PagedKVCache":
        """Add one owner to each page (prefix-index retention)."""
        if not page_ids:
            return self
        if self.refcounts is None:
            raise ValueError("retain_pages() requires a refcounted cache")
        refs = self.refcounts.copy()
        for p in page_ids:
            if refs[p] <= 0:
                raise AssertionError(f"cannot retain unowned page {p}")
            refs[p] += 1
        return dataclasses.replace(self, refcounts=refs)

    def release_pages(self, page_ids: List[int]) -> "PagedKVCache":
        """Drop one owner from each page; zero-owner pages return to free."""
        if not page_ids:
            return self
        if self.refcounts is None:
            raise ValueError("release_pages() requires a refcounted cache")
        refs = self.refcounts.copy()
        free = list(self.free)
        for p in page_ids:
            self._drop_ref(refs, free, int(p))
        return dataclasses.replace(self, refcounts=refs, free=free)

    def check_integrity(self, retained: int = 0) -> None:
        """Assert the pool's host-side bookkeeping is self-consistent.

        ``retained`` is the number of out-of-table owners (prefix-index
        retentions) the refcount conservation law must account for.  Checks
        — all host-side, no device sync:

        * the free list holds no duplicates and only valid page ids;
        * no page is simultaneously free and owned, and free + owned
          partition the pool (refcounted caches);
        * conservation: ``refcounts.sum() == mapped.sum() + retained``;
        * every mapped page-table entry points at an owned page, and
          entries beyond ``mapped`` are zeroed (no orphaned host shadows);
        * ``lengths_host`` never exceeds the mapped capacity of its slot.

        Raises ``AssertionError`` on the first violation; the chaos suite
        (``repro.serve.faults``) calls this after every scheduler step.
        """
        free = list(self.free)
        assert len(free) == len(set(free)), "duplicate pages in free list"
        assert all(0 <= p < self.total_pages for p in free), \
            f"free list holds out-of-range page: {free}"
        refs = self.refcounts
        table = self.page_table_host
        if refs is not None:
            assert (refs >= 0).all(), "negative refcount"
            owned = {p for p in range(self.total_pages) if refs[p] > 0}
            overlap = owned & set(free)
            assert not overlap, f"pages both free and owned: {sorted(overlap)}"
            assert len(owned) + len(free) == self.total_pages, (
                f"free ({len(free)}) + owned ({len(owned)}) pages do not "
                f"partition the {self.total_pages}-page pool"
            )
            if self.mapped is not None:
                assert int(refs.sum()) == int(self.mapped.sum()) + retained, (
                    f"refcount conservation broken: refs {int(refs.sum())} "
                    f"!= mapped {int(self.mapped.sum())} + retained {retained}"
                )
        if table is not None and self.mapped is not None:
            for seq in range(table.shape[0]):
                used = int(self.mapped[seq])
                for p in table[seq, :used]:
                    assert int(p) not in set(free), \
                        f"seq {seq} maps free page {int(p)}"
                    if refs is not None:
                        assert refs[int(p)] >= 1, \
                            f"seq {seq} maps unowned page {int(p)}"
                assert not table[seq, used:].any(), (
                    f"seq {seq}: orphaned table entries beyond its "
                    f"{used} mapped pages"
                )
                if self.lengths_host is not None:
                    ln = int(self.lengths_host[seq])
                    assert ln <= used * self.page_size, (
                        f"seq {seq}: length shadow {ln} exceeds "
                        f"{used} mapped pages"
                    )

    def ensure_writable(self, seq: int, lo_token: int,
                        hi_token: int) -> Tuple["PagedKVCache", int]:
        """Copy-on-write any shared page covering tokens [lo, hi] of ``seq``.

        Pages in the token range with more than one owner are copied to
        fresh physical pages (K/V pools and, in int8 mode, the scale pools
        — the codes and scales move together, so replay never re-quantizes
        differently) and the slot's table is re-pointed at the private
        copy.  Returns ``(cache, n_copied)``.  The page copies update the
        pools in place (``pool[:, dst].copy_(pool[:, src])``), so the pools
        are shared with the cache this one was derived from.
        """
        if self.refcounts is None or lo_token > hi_token:
            return self, 0
        page = self.page_size
        p_lo = lo_token // page
        p_hi = min(hi_token // page, self._mapped(seq) - 1)
        if p_hi < p_lo:
            return self, 0
        table = (self.page_table_host if self.page_table_host is not None
                 else self.page_table.cpu().numpy())
        shared = [
            (pi, int(table[seq, pi]))
            for pi in range(p_lo, p_hi + 1)
            if self.refcounts[int(table[seq, pi])] > 1
        ]
        if not shared:
            return self, 0
        if len(shared) > len(self.free):
            raise OutOfPages(
                f"seq {seq}: copy-on-write needs {len(shared)} pages, "
                f"{len(self.free)} free"
            )
        refs = self.refcounts.copy()
        free = list(self.free)
        pt = self._host_table()
        pools = [self.k_pages, self.v_pages]
        if self.quantized:
            pools += [self.k_scale, self.v_scale]
        for pi, src in shared:
            dst = free.pop()
            for pool in pools:
                pool[:, dst].copy_(pool[:, src])
            self._drop_ref(refs, free, src)
            refs[dst] = 1
            pt[seq, pi] = dst
        return dataclasses.replace(
            self, page_table=self._device_table(pt), page_table_host=pt,
            free=free, refcounts=refs,
        ), len(shared)
