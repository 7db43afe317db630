"""The port's ``PagedKVCache`` against the JAX reference's.

The same sequence of pool operations — allocate, write, share,
copy-on-write, retain, release, trim — runs on both caches.  After every
operation the host bookkeeping (free list, mapped counts, refcounts, host
shadows) must be identical and the device pools (codes and, in int8 mode,
scales) bitwise equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import OutOfPages, PagedKVCache  # noqa: E402

CFG = smoke_config("yi-6b")
GEOMETRY = dict(batch=3, max_len=16, page=4, pool_pages=10)


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs import smoke_config as jax_smoke
    from repro.kernels import ops as jops
    from repro.serve import PagedKVCache as JaxCache

    return jnp, jops, JaxCache, jax_smoke("yi-6b")


class Pair:
    """A JAX cache and a port cache driven through the same operations."""

    def __init__(self, jx, kv_dtype):
        self.jnp, self.jops, jax_cache, jcfg = jx
        self.j = jax_cache.create(jcfg, kv_dtype=kv_dtype, **GEOMETRY)
        self.t = PagedKVCache.create(CFG, kv_dtype=kv_dtype, device="cpu",
                                     **GEOMETRY)

    def apply(self, op, *args):
        """Run ``op`` on both caches; a refusal (``OutOfPages`` of either
        package) must come from both, with neither cache changed."""
        results = []
        for cache in (self.j, self.t):
            try:
                results.append(getattr(cache, op)(*args))
            except RuntimeError as err:
                assert type(err).__name__ == "OutOfPages", err
                results.append(None)
        refused = [r is None for r in results]
        assert refused[0] == refused[1], (op, args, refused)
        if refused[0]:
            self.check()
            raise OutOfPages(f"{op}{args} refused by both")
        self.j, self.t = results
        if op == "ensure_writable":
            (self.j, nj), (self.t, nt) = self.j, self.t
            assert nj == nt
        self.check()

    def write(self, rng, slot, start, count):
        """Write ``count`` random tokens at ``start`` of ``slot``, all
        layers, through each package's chunk write."""
        j, t, jnp = self.j, self.t, self.jnp
        shape = (CFG.n_layers, 1, count, t.k_pages.shape[3], CFG.hd)
        kn = rng.standard_normal(shape).astype(np.float32)
        vn = rng.standard_normal(shape).astype(np.float32)
        row = t.page_table_host[slot][None]
        st = np.array([start], np.int32)
        ct = np.array([count], np.int32)
        outs = []
        for l in range(CFG.n_layers):
            sc = (dict(k_scale=j.k_scale[l], v_scale=j.v_scale[l])
                  if j.k_scale is not None else {})
            outs.append(self.jops.paged_kv_write_chunk(
                j.k_pages[l], j.v_pages[l], jnp.asarray(kn[l]),
                jnp.asarray(vn[l]), jnp.asarray(row), jnp.asarray(st),
                jnp.asarray(ct), impl="ref", **sc))
            tsc = (dict(k_scale=t.k_scale[l], v_scale=t.v_scale[l])
                   if t.quantized else {})
            ops.paged_kv_write_chunk(
                t.k_pages[l], t.v_pages[l], torch.from_numpy(kn[l]),
                torch.from_numpy(vn[l]), torch.from_numpy(row),
                torch.from_numpy(st), torch.from_numpy(ct), **tsc)
        stacked = [jnp.stack([o[i] for o in outs])
                   for i in range(len(outs[0]))]
        names = ["k_pages", "v_pages", "k_scale", "v_scale"][:len(stacked)]
        self.j = dataclasses.replace(j, **dict(zip(names, stacked)))
        self.check()

    def check(self):
        j, t = self.j, self.t
        assert j.free == t.free
        for name in ("mapped", "lengths_host", "page_table_host",
                     "refcounts"):
            np.testing.assert_array_equal(getattr(j, name), getattr(t, name))
        np.testing.assert_array_equal(np.asarray(j.page_table),
                                      t.page_table.numpy())
        np.testing.assert_array_equal(np.asarray(j.lengths),
                                      t.lengths.numpy())
        pools = ["k_pages", "v_pages"] + (["k_scale", "v_scale"]
                                          if t.quantized else [])
        assert (j.k_scale is None) == (not t.quantized)
        for name in pools:
            np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                          getattr(t, name).numpy())
        t.check_integrity(retained=int(t.refcounts.sum() - t.mapped.sum()))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_scripted_lifecycle_matches_jax(jx, kv_dtype):
    rng = np.random.default_rng(0)
    pair = Pair(jx, kv_dtype)
    pair.apply("allocate", 0, 3)
    pair.write(rng, 0, 0, 4)
    pair.write(rng, 0, 4, 6)                       # straddles pages 1-2
    shared = [int(p) for p in pair.t.page_table_host[0, :2]]
    pair.apply("share", 1, shared)
    pair.apply("allocate", 1, 1)
    pair.apply("ensure_writable", 1, 5, 6)         # copy-on-write page 1
    pair.write(rng, 1, 5, 2)
    pair.apply("retain_pages", shared[:1])
    pair.apply("release", 0)
    pair.apply("allocate", 2, 2)
    pair.apply("trim", 1, 2)
    pair.apply("release_pages", shared[:1])
    pair.apply("release", 1)
    pair.apply("release", 2)
    assert sorted(pair.t.free) == list(range(GEOMETRY["pool_pages"]))


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_op_sequences_match_jax(jx, kv_dtype, seed):
    """A seeded walk over every operation; whatever one cache refuses with
    ``OutOfPages`` the other must refuse too."""
    rng = np.random.default_rng(seed)
    pair = Pair(jx, kv_dtype)
    retained = []
    for _ in range(25):
        t = pair.t
        slot = int(rng.integers(GEOMETRY["batch"]))
        mapped = int(t.mapped[slot])
        op = rng.choice(["allocate", "write", "share", "cow", "release",
                         "trim", "retain", "unretain"])
        try:
            if op == "allocate":
                pair.apply("allocate", slot, int(rng.integers(1, 3)))
            elif op == "write" and mapped:
                cap = mapped * GEOMETRY["page"]
                start = int(rng.integers(cap))
                pair.write(rng, slot, start, int(rng.integers(
                    1, min(4, cap - start) + 1)))
            elif op == "share":
                other = int(rng.integers(GEOMETRY["batch"]))
                n = int(t.mapped[other])
                if other != slot and n:
                    pair.apply("share", slot, [int(p) for p in
                                               t.page_table_host[other, :n]])
            elif op == "cow" and mapped:
                cap = mapped * GEOMETRY["page"]
                lo = int(rng.integers(cap))
                pair.apply("ensure_writable", slot, lo, cap - 1)
            elif op == "release":
                pair.apply("release", slot)
            elif op == "trim":
                pair.apply("trim", slot, int(rng.integers(mapped + 1)))
            elif op == "retain" and mapped:
                page = int(t.page_table_host[slot, 0])
                pair.apply("retain_pages", [page])
                retained.append(page)
            elif op == "unretain" and retained:
                pair.apply("release_pages", [retained.pop()])
        except OutOfPages:
            pass  # refused by both caches alike (see Pair.apply)
    pair.apply("release_pages", retained)
    for slot in range(GEOMETRY["batch"]):
        pair.apply("release", slot)
    assert sorted(pair.t.free) == list(range(GEOMETRY["pool_pages"]))
