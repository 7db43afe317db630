"""Recurrent model families (RWKV6 / Mamba) behind the serving scheduler
(the port's ``repro.serve.recurrent_lm``).

Each sequence owns a fixed-size state, one slot per resident, laid out
``(layer, slot, *row)``, so a sequence's rows sit at a stride of ``batch``
rows in the flattened pool: recurrent serving is the strided-burst dialect
of AXI-Pack, and the stride in the descriptor is the whole address.

* :class:`RecurrentLM` — a tied-embedding LM over the port's
  :func:`~repro_torch.models.rwkv6.rwkv_block` /
  :func:`~repro_torch.models.mamba.mamba_fwd`.  Every token, prefill or
  decode, runs through one step function (:meth:`RecurrentLM._step`) over
  all ``batch`` rows; the reference's ``lax.scan`` over tokens is a Python
  loop that runs that same body for every trip count, so any chunking of a
  token stream gives the same bits.  Inactive rows keep their state through
  ``torch.where``, so batch composition never leaks between sequences.
* :class:`RecurrentStatePool` — the state tensors (updated in place, where
  the reference donates them) and the host bookkeeping.
* :class:`RecurrentFamily` — the scheduler-facing
  :class:`~repro_torch.serve.family.ServableFamily`: a slot is the
  resource unit, capacity is unbounded, and :meth:`RecurrentFamily.replay`
  zeroes the admitted slot's rows through the strided scatter kernel
  (:func:`~repro_torch.kernels.ops.recurrent_state_write`).
* :func:`recurrent_reference_generate` — the direct sequential forward the
  scheduler's output is held against, bitwise.
* :func:`recurrent_params_from_numpy` — the JAX model's weights for the
  port, so both packages serve the same model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.packing import (
    Traffic,
    recurrent_decode_traffic,
    recurrent_prefill_traffic,
)
from ..core.streams import recurrent_state_streams
from ..device import resolve_device
from ..kernels import ops as kops
from ..models import mamba as mamba_mod
from ..models import rwkv6 as rwkv_mod
from ..models.common import (
    Param,
    cast_tree,
    init_params,
    map_tree,
    rms_norm,
    stack_layer_defs,
)
from .family import OutOfPages, ServableFamily

__all__ = [
    "RecurrentFamily",
    "RecurrentLM",
    "RecurrentStatePool",
    "recurrent_params_from_numpy",
    "recurrent_reference_generate",
]

#: Recurrent slots never grow: the per-slot token capacity is unbounded,
#: so the scheduler's growth and lookahead machinery stays idle.
UNBOUNDED_TOKENS = 1 << 62


def recurrent_params_from_numpy(embed, layers, device=None
                                ) -> Dict[str, Any]:
    """The JAX ``RecurrentLM``'s ``embed`` (vocab, d) and stacked layer tree
    (nested dicts of ``(n_layers, ...)`` arrays) as float32 tensors on
    ``device`` (``None`` = ``cuda``): the ``params`` of a port
    :class:`RecurrentLM` serving the same weights."""
    dev = resolve_device(device)

    def conv(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)

    return {"embed": conv(embed), "layers": map_tree(conv, dict(layers))}


@dataclasses.dataclass
class RecurrentStatePool:
    """Per-sequence state pools and host-side slot bookkeeping.

    ``tensors`` maps a state name to an ``(n_layers, batch, *row)`` device
    tensor (the layer-major layout the strided accounting assumes).  The
    model updates them in place.
    """

    tensors: Dict[str, torch.Tensor]
    lengths_host: np.ndarray  # (batch,) int32 — tokens consumed per slot
    owned: np.ndarray         # (batch,) bool  — slot currently allocated

    @classmethod
    def create(cls, model: "RecurrentLM", batch: int) -> "RecurrentStatePool":
        tensors = {
            name: torch.zeros((model.cfg.n_layers, batch) + shape,
                              dtype=dtype, device=model.device)
            for name, (shape, dtype) in model.state_specs().items()
        }
        return cls(
            tensors=tensors,
            lengths_host=np.zeros((batch,), np.int32),
            owned=np.zeros((batch,), bool),
        )

    @property
    def batch(self) -> int:
        return int(self.lengths_host.shape[0])

    @property
    def n_layers(self) -> int:
        return int(next(iter(self.tensors.values())).shape[0])

    @property
    def n_free(self) -> int:
        return int(self.batch - self.owned.sum())

    @staticmethod
    def _nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    @property
    def row_bytes(self) -> Tuple[int, ...]:
        """Per-layer row footprint of each state tensor (stream elements)."""
        lb = self.n_layers * self.batch
        return tuple(self._nbytes(t) // lb for t in self.tensors.values())

    @property
    def state_slot_bytes(self) -> int:
        """Bytes of one sequence's full state (all layers, all tensors)."""
        return sum(self._nbytes(t) // self.batch
                   for t in self.tensors.values())

    @property
    def pool_bytes(self) -> int:
        return sum(self._nbytes(t) for t in self.tensors.values())


class RecurrentLM:
    """Tied-embedding LM over real RWKV6 / Mamba blocks.

    Float32 parameters, no final norm, greedy: every per-token computation
    is row-wise.  ``arch`` picks the block, ``'rwkv6'`` (wkv state per
    head) or ``'mamba'`` (SSM state and conv tail); ``None`` takes
    ``'rwkv6'`` for an rwkv6 config and ``'mamba'`` otherwise.  The
    activations run in ``cfg.compute_dtype`` (bf16 at the full configs,
    fp32 at the smoke ones) with the weights cast to it once, here.

    ``params`` (from :func:`recurrent_params_from_numpy`) serves given
    weights; otherwise they are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when ``None``) with the
    reference's scales: ``embed ~ N(0, 1) * 0.02`` and each layer leaf as
    its :class:`~repro_torch.models.common.Param` declares.  ``impl`` is
    the kernels' dispatch (``'cuda'`` or ``'ref'``); the state pools'
    strided reads and writes are the only kernels this model launches.
    ``device=None`` means ``cuda``.
    """

    def __init__(self, cfg: ArchConfig,
                 generator: Optional[torch.Generator] = None,
                 arch: Optional[str] = None, impl: str = "cuda",
                 device=None, params: Optional[Dict[str, Any]] = None):
        arch = arch or ("rwkv6" if cfg.ssm == "rwkv6" else "mamba")
        if arch not in ("rwkv6", "mamba"):
            raise ValueError(f"unknown recurrent arch: {arch!r}")
        if arch == "rwkv6" and cfg.d_model % rwkv_mod.HEAD_DIM:
            raise ValueError(
                f"rwkv6 needs d_model divisible by {rwkv_mod.HEAD_DIM}"
            )
        if arch == "mamba" and cfg.ssm_conv < 2:
            raise ValueError("mamba needs ssm_conv >= 2 (a conv state tail)")
        if impl not in ("cuda", "ref"):
            raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")
        self.cfg = cfg
        self.arch = arch
        self.impl = impl
        self.device = resolve_device(device)
        d = cfg.d_model
        norm = Param((d,), ("d_model",), init="zeros")
        if arch == "rwkv6":
            ldefs: Dict[str, Any] = {
                **rwkv_mod.rwkv_defs(cfg), "ln1": norm, "ln2": norm,
            }
        else:
            ldefs = {"mamba": mamba_mod.mamba_defs(cfg), "ln": norm}
        defs = stack_layer_defs(ldefs, cfg.n_layers)
        if params is None:
            gen = generator
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(0)
            embed = torch.randn((cfg.vocab, d), generator=gen,
                                device=self.device) * 0.02
            params = {"embed": embed,
                      "layers": init_params(defs, gen, self.device)}
        self._check_params(params, defs)
        self.embed = params["embed"]
        self.layers = params["layers"]
        dt = cfg.compute_dtype
        cast = cast_tree(self.layers, dt)
        # Per-layer views (no copies): float32 and compute-dtype trees.
        self._p = [map_tree(lambda a, i=i: a[i], self.layers)
                   for i in range(cfg.n_layers)]
        self._pf = [map_tree(lambda a, i=i: a[i], cast)
                    for i in range(cfg.n_layers)]

    def _check_params(self, params, defs) -> None:
        want_e = (self.cfg.vocab, self.cfg.d_model)
        e = params["embed"]
        if (tuple(e.shape) != want_e or e.dtype != torch.float32
                or e.device != self.device):
            raise ValueError(f"embed: want {want_e} float32 on {self.device}"
                             f", got {tuple(e.shape)} {e.dtype} on {e.device}")

        def walk(d, p, path):
            if isinstance(d, Param):
                if (not isinstance(p, torch.Tensor)
                        or tuple(p.shape) != d.shape
                        or p.dtype != torch.float32
                        or p.device != self.device):
                    got = (f"{tuple(p.shape)} {p.dtype} on {p.device}"
                           if isinstance(p, torch.Tensor) else repr(p))
                    raise ValueError(f"param {path}: want {d.shape} float32 "
                                     f"on {self.device}, got {got}")
                return
            if not isinstance(p, dict) or set(p) != set(d):
                raise ValueError(f"param {path}: want keys {sorted(d)}")
            for k in d:
                walk(d[k], p[k], f"{path}/{k}")

        walk(defs, params["layers"], "layers")

    def bind(self, pool: RecurrentStatePool) -> "RecurrentFamily":
        """Wrap this model + ``pool`` as the scheduler-facing family."""
        return RecurrentFamily(self, pool)

    def init_pool(self, batch: int) -> RecurrentStatePool:
        return RecurrentStatePool.create(self, batch)

    def state_specs(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """State name → (per-slot per-layer row shape, dtype)."""
        if self.arch == "rwkv6":
            return rwkv_mod.rwkv_state_specs(self.cfg)
        return mamba_mod.mamba_state_specs(self.cfg)

    def _layer_step(self, l: int, x, st_l):
        """One layer over a (B, 1, D) slice; returns (x, new layer state)."""
        p, pf = self._p[l], self._pf[l]
        if self.arch == "rwkv6":
            return rwkv_mod.rwkv_block(p, x, self.cfg, p, st_l, pf=pf)
        out, ns = mamba_mod.mamba_fwd(
            p["mamba"], rms_norm(x, p["ln"]), self.cfg, st_l,
            pf=pf["mamba"],
        )
        return x + out, ns

    def _step(self, pool: Dict[str, torch.Tensor], cur: torch.Tensor,
              tok_in: Optional[torch.Tensor], act: torch.Tensor):
        """One token for every row: the reference's scan body.

        ``tok_in`` (B,) int32 is the step's given token (prefill), or
        ``None`` to feed the carried greedy token ``cur`` (decode).  Runs
        every layer, writes the new state of the ``act`` rows into ``pool``
        in place (the others keep theirs bit for bit), and returns
        (logits (B, vocab) float32, the new carried token).
        """
        tok = cur if tok_in is None else tok_in
        x = self.embed[tok.long()][:, None, :].to(self.cfg.compute_dtype)
        for l in range(self.cfg.n_layers):
            st_l = {k: t[l] for k, t in pool.items()}
            x, ns = self._layer_step(l, x, st_l)
            for k, t in pool.items():
                keep = act.view((-1,) + (1,) * (t.dim() - 2))
                t[l] = torch.where(keep, ns[k], st_l[k])
        logits = x[:, 0].float() @ self.embed.T
        nxt = logits[:, : self.cfg.vocab].argmax(dim=-1).to(torch.int32)
        return logits, torch.where(act, nxt, cur)

    def prefill_chunk(self, tensors: Dict[str, torch.Tensor], toks, active):
        """Feed given tokens: toks (C, B) int32, active (C, B) bool (host
        arrays or tensors).  Returns (tensors, updated in place, and the
        per-step logits (C, B, vocab) on the device)."""
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.int32,
                               device=self.device)
        act = torch.as_tensor(np.asarray(active), dtype=torch.bool,
                              device=self.device)
        cur = torch.zeros((toks.shape[1],), dtype=torch.int32,
                          device=self.device)
        logits = []
        for i in range(toks.shape[0]):
            lg, cur = self._step(tensors, cur, toks[i], act[i])
            logits.append(lg)
        return tensors, torch.stack(logits)

    def decode_chain(self, tensors: Dict[str, torch.Tensor], tokens, active,
                     n: int):
        """Decode ``n`` greedy steps from the current tokens (B,); active
        (B,) bool.  The tokens stay on the device between steps and cross
        to the host once.  Returns (tensors, (n, B) host tokens)."""
        cur = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                              device=self.device)
        act = torch.as_tensor(np.asarray(active), dtype=torch.bool,
                              device=self.device)
        out = []
        for _ in range(int(n)):
            _, cur = self._step(tensors, cur, None, act)
            out.append(cur)
        return tensors, torch.stack(out).cpu().numpy()


class RecurrentFamily(ServableFamily):
    """Serve a :class:`RecurrentLM` out of a :class:`RecurrentStatePool`.

    The resource unit is the state slot: every sequence costs one unit
    whatever its length, capacity never binds, and grow/trim stay idle.
    Eviction and replay follow the paged protocol (release, re-admit,
    re-prefill), except that the device half of the reset is explicit:
    :meth:`replay` zeroes the slot's state rows through the strided scatter
    kernel, since pools recycle rows across occupants.
    """

    def __init__(self, model: RecurrentLM, pool: RecurrentStatePool):
        want = set(model.state_specs())
        have = set(pool.tensors)
        if want != have:
            raise ValueError(
                f"state pool tensors {sorted(have)} do not match the "
                f"model's state layout {sorted(want)}: create the pool "
                f"with RecurrentStatePool.create(model, batch)"
            )
        self.model = model
        self.pool = pool
        self.name = model.arch

    # -- geometry -----------------------------------------------------------

    @property
    def batch(self) -> int:
        return self.pool.batch

    @property
    def vocab(self) -> int:
        return self.model.cfg.vocab

    @property
    def total_units(self) -> int:
        return self.pool.batch

    @property
    def free_units(self) -> int:
        return self.pool.n_free

    @property
    def slot_token_capacity(self) -> int:
        return UNBOUNDED_TOKENS

    @property
    def pool_bytes(self) -> int:
        return self.pool.pool_bytes

    def units_for(self, n_tokens: int) -> int:
        return 1 if n_tokens > 0 else 0

    def mapped_units(self, slot: int) -> int:
        return 1 if self.pool.owned[slot] else 0

    def token_capacity(self, slot: int) -> int:
        return UNBOUNDED_TOKENS if self.pool.owned[slot] else 0

    def state_bytes(self, n_tokens: int) -> int:
        return self.pool.state_slot_bytes if n_tokens > 0 else 0

    def lengths(self) -> np.ndarray:
        return self.pool.lengths_host

    # -- slot lifecycle -----------------------------------------------------

    def alloc_state(self, slot: int, units: int) -> None:
        if units <= 0:
            return
        if self.pool.owned[slot]:
            raise OutOfPages(f"slot {slot} is already allocated")
        if units > 1 or self.pool.n_free < 1:
            raise OutOfPages(
                f"need {units} state slot(s), {self.pool.n_free} free"
            )
        self.pool.owned[slot] = True
        self.pool.lengths_host[slot] = 0

    def release(self, slot: int) -> None:
        # Host bookkeeping only; the stale device rows are zeroed by the
        # next occupant's replay() at admission.
        self.pool.owned[slot] = False
        self.pool.lengths_host[slot] = 0

    def replay(self, slot: int) -> None:
        """Zero the slot's state rows (one strided scatter per state
        tensor): fresh-prefill semantics for recycled rows; called at every
        admission."""
        for t in self.pool.tensors.values():
            zeros = torch.zeros((t.shape[0],) + tuple(t.shape[2:]),
                                dtype=t.dtype, device=t.device)
            kops.recurrent_state_write(t, int(slot), zeros,
                                       impl=self.model.impl)
        self.pool.lengths_host[slot] = 0

    # -- compute ------------------------------------------------------------

    def prefill_batch(self, tokens: np.ndarray, counts: np.ndarray,
                      slots: np.ndarray, starts: np.ndarray) -> torch.Tensor:
        """One prompt chunk for the pending rows; returns each row's last
        real token's logits (R, vocab) on the device."""
        b = self.batch
        n_rows, c = tokens.shape
        toks = np.zeros((c, b), np.int32)
        act = np.zeros((c, b), bool)
        for i in range(n_rows):
            ci, si = int(counts[i]), int(slots[i])
            toks[:ci, si] = tokens[i, :ci]
            act[:ci, si] = True
        self.pool.tensors, logits = self.model.prefill_chunk(
            self.pool.tensors, toks, act
        )
        dev = logits.device
        last = torch.as_tensor(
            np.maximum(np.asarray(counts, np.int64) - 1, 0), device=dev)
        rows = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        out = logits[last, rows]
        # Scalar loop: padding rows alias slot 0 with count 0, and fancy
        # `+=` drops duplicate-index updates instead of accumulating them.
        for i in range(n_rows):
            self.pool.lengths_host[int(slots[i])] += int(counts[i])
        return out

    def decode_steps(self, tokens: np.ndarray, active: np.ndarray,
                     n: int) -> np.ndarray:
        self.pool.tensors, out = self.model.decode_chain(
            self.pool.tensors, tokens, active, n
        )
        self.pool.lengths_host[np.asarray(active, bool)] += int(n)
        return out

    # -- accounting ---------------------------------------------------------

    def step_streams(self, active: np.ndarray,
                     n: int) -> List[Tuple[Traffic, tuple]]:
        slots = [int(s) for s in np.nonzero(np.asarray(active, bool))[0]]
        traffic = recurrent_decode_traffic(
            len(slots), self.batch, self.pool.state_slot_bytes
        )
        streams = recurrent_state_streams(
            slots, self.batch, self.pool.n_layers, self.pool.row_bytes
        )
        # State size is length-free, so every step moves identical bytes.
        return [(traffic, streams)] * int(n)

    def prefill_account(self, slots: np.ndarray, starts: np.ndarray,
                        counts: np.ndarray) -> Tuple[Traffic, tuple]:
        traffic = recurrent_prefill_traffic(
            counts, self.batch, self.pool.state_slot_bytes
        )
        streams = recurrent_state_streams(
            [int(s) for s in slots], self.batch, self.pool.n_layers,
            self.pool.row_bytes,
        )
        return traffic, streams

    # -- invariants ---------------------------------------------------------

    def check_integrity(self, retained: int = 0) -> None:
        if retained:
            raise ValueError(
                f"recurrent family cannot hold {retained} retained prefix "
                f"entries (no prefix sharing)"
            )
        pool = self.pool
        if pool.lengths_host.shape != (pool.batch,):
            raise ValueError("lengths shadow shape mismatch")
        bad = np.nonzero(~pool.owned & (pool.lengths_host != 0))[0]
        if bad.size:
            raise ValueError(
                f"free slots {bad.tolist()} have nonzero lengths"
            )
        if (pool.lengths_host < 0).any():
            raise ValueError("negative slot length")
        for name, t in pool.tensors.items():
            if tuple(t.shape[:2]) != (pool.n_layers, pool.batch):
                raise ValueError(
                    f"state tensor {name!r} has pool shape "
                    f"{tuple(t.shape[:2])}, want "
                    f"{(pool.n_layers, pool.batch)}"
                )


def recurrent_reference_generate(
    model: RecurrentLM,
    pool: RecurrentStatePool,
    prompts: Sequence[Sequence[int]],
    max_new: int,
    chunk: int = 8,
) -> List[List[int]]:
    """Direct sequential forward: the serving-free ground truth.

    Drives the same step function over the same batch shape (prompt
    tokens per position with row masks, then greedy decode) with no
    scheduler in the loop.  Any scheduler interleaving must give these
    tokens bit for bit.
    """
    b = pool.batch
    if len(prompts) > b:
        raise ValueError(f"{len(prompts)} prompts > batch {b}")
    plens = [len(p) for p in prompts]
    if min(plens, default=1) < 1:
        raise ValueError("empty prompt")
    tensors = pool.tensors
    vocab = model.cfg.vocab
    maxp = max(plens)
    last: List[Optional[torch.Tensor]] = [None] * len(prompts)
    pos = 0
    while pos < maxp:
        c = min(chunk, maxp - pos)
        toks = np.zeros((c, b), np.int32)
        act = np.zeros((c, b), bool)
        for i, p in enumerate(prompts):
            ci = min(max(plens[i] - pos, 0), c)
            if ci:
                toks[:ci, i] = np.asarray(p)[pos:pos + ci]
                act[:ci, i] = True
        tensors, logits = model.prefill_chunk(tensors, toks, act)
        for i in range(len(prompts)):
            if pos < plens[i] <= pos + c:
                last[i] = logits[plens[i] - pos - 1, i, :vocab]
        pos += c
    first = torch.stack(last).argmax(dim=-1).cpu().numpy()
    out = [[int(t)] for t in first]
    if max_new > 1:
        tokens = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for i, o in enumerate(out):
            tokens[i] = o[0]
            active[i] = True
        tensors, steps = model.decode_chain(tensors, tokens, active,
                                            max_new - 1)
        for i, o in enumerate(out):
            o.extend(int(steps[s, i]) for s in range(max_new - 1))
    pool.tensors = tensors
    return out
