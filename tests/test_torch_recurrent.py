"""Recurrent serving in the port (RWKV6, Mamba) against the JAX reference.

The JAX ``RecurrentLM(impl='ref')`` draws the weights;
``recurrent_params_from_numpy`` carries them into the port, so both
packages serve the same model, at the smoke configs of the reference's
own family tests (rwkv6-3b's for RWKV6, yi-6b's for Mamba).

* Per-step logits and states agree with JAX within rtol = atol = 1e-5 at
  the smoke configs' float32 (the two frameworks sum in other orders).
  At bf16 activations the logits agree within atol = 2e-2 (they are
  below 0.4 here and differ by a few bf16 steps, 2^-8 relative each, where
  the frameworks round a product or a sum differently), and every state
  tensor keeps the reference's dtype.
* Inside the port, the scheduler's output equals
  ``recurrent_reference_generate`` bit for bit, whatever the chunking,
  arrivals or evictions; and it equals the JAX scheduler's tokens.
* The strided accounting is the reference's, bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BurstKind,
    StridedStream,
    recurrent_decode_traffic,
    recurrent_prefill_traffic,
    recurrent_state_streams,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    OutOfPages,
    RecurrentLM,
    Request,
    RequestState,
    Scheduler,
    check_scheduler_invariants,
    recurrent_params_from_numpy,
    recurrent_reference_generate,
)

CPU = "cpu"
CFGS = {"rwkv6": smoke_config("rwkv6-3b"), "mamba": smoke_config("yi-6b")}
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_LOGIT_TOL = dict(rtol=0.0, atol=2e-2)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro import serve
    from repro.configs import smoke_config as jax_smoke

    return jax, serve, jax_smoke


def _jax_model(jx, arch, dtype=None):
    jax, serve, jax_smoke = jx
    cfg = jax_smoke("rwkv6-3b" if arch == "rwkv6" else "yi-6b")
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return serve.RecurrentLM(cfg, jax.random.PRNGKey(0), arch=arch,
                             impl="ref")


def _carried(jx, jm, arch, dtype=None):
    jax = jx[0]
    params = recurrent_params_from_numpy(
        np.asarray(jm.embed), jax.tree.map(np.asarray, jm.layers),
        device=CPU)
    cfg = CFGS[arch]
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return RecurrentLM(cfg, arch=arch, device=CPU, params=params)


@pytest.fixture(scope="module")
def pair(jx):
    """Per arch: the JAX model and the port model on its weights."""
    out = {}
    for arch in CFGS:
        jm = _jax_model(jx, arch)
        out[arch] = (jm, _carried(jx, jm, arch))
    return out


def _f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _steps(model, toks, act, decode_from, n_decode):
    pool = model.init_pool(toks.shape[1])
    tensors, logits = model.prefill_chunk(pool.tensors, toks, act)
    tensors, dec = model.decode_chain(tensors, decode_from, act[-1], n_decode)
    return _f32(logits), tensors, np.asarray(dec)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_logits_and_states_per_step_vs_jax(pair, arch):
    jm, pm = pair[arch]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, CFGS[arch].vocab, (6, 3)).astype(np.int32)
    act = np.ones((6, 3), bool)
    act[3:, 1] = False  # row 1 stops early: its state must stay put
    feed = toks[-1]
    jl, jt, jd = _steps(jm, toks, act, feed, 4)
    pl, pt, pd = _steps(pm, toks, act, feed, 4)
    np.testing.assert_allclose(pl, jl, **TOL)
    for k in jt:
        np.testing.assert_allclose(_f32(pt[k]), _f32(jt[k]), **TOL)
    np.testing.assert_array_equal(pd, jd)


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_bf16_activations_vs_jax(jx, arch):
    """The full configs compute in bf16: state dtypes and values follow
    the reference (wkv and SSM states float32, shifts and conv tails
    bf16)."""
    jm = _jax_model(jx, arch, dtype="bfloat16")
    pm = _carried(jx, jm, arch, dtype="bfloat16")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFGS[arch].vocab, (4, 2)).astype(np.int32)
    act = np.ones((4, 2), bool)
    jl, jt, _ = _steps(jm, toks, act, toks[-1], 1)
    pl, pt, _ = _steps(pm, toks, act, toks[-1], 1)
    np.testing.assert_allclose(pl, jl, **BF16_LOGIT_TOL)
    for name, (_, dtype) in pm.state_specs().items():
        assert pt[name].dtype == dtype
        assert str(np.asarray(jt[name]).dtype) == str(dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Scheduler-served output == direct sequential forward, bit for bit
# ---------------------------------------------------------------------------


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drive(sched, requests, max_steps=500):
    for r in requests:
        sched.submit(r)
    steps = 0
    while sched.queue or sched.resident:
        sched.step()
        check_scheduler_invariants(sched, requests)
        steps += 1
        assert steps < max_steps, "run failed to drain"
    return {rid: r.generated for rid, r in sorted(sched.finished.items())}


@pytest.mark.parametrize("arch,chunk", [("rwkv6", 4), ("rwkv6", 8),
                                        ("mamba", 4), ("mamba", 8)])
def test_scheduled_matches_direct_forward(pair, arch, chunk):
    pm = pair[arch][1]
    prompts = _prompts(chunk, CFGS[arch].vocab, (8, 7, 12))
    want = recurrent_reference_generate(pm, pm.init_pool(3), prompts, 8)
    sched = Scheduler(pm, pm.init_pool(3), chunk=chunk)
    out = _drive(sched, [Request(rid=i, prompt=p, max_new=8)
                         for i, p in enumerate(prompts)])
    assert out == dict(enumerate(want))
    assert sched.family.name == arch


def test_scheduled_matches_direct_forward_ragged_arrivals(pair):
    pm = pair["rwkv6"][1]
    prompts = _prompts(7, pm.cfg.vocab, (10, 3, 6))
    want = recurrent_reference_generate(pm, pm.init_pool(3), prompts, 6)
    sched = Scheduler(pm, pm.init_pool(3), chunk=4)
    reqs = [Request(rid=i, prompt=p, max_new=6)
            for i, p in enumerate(prompts)]
    sched.submit(reqs[0])
    sched.step()
    sched.submit(reqs[1])
    sched.step()
    out = _drive(sched, reqs[2:])
    assert out == dict(enumerate(want))


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_eviction_replay_round_trip(pair, arch):
    """Evict a mid-decode resident: replay re-prefills from the slot that
    ``replay`` zeroed and reproduces the fault-free tokens exactly."""
    pm = pair[arch][1]
    prompts = _prompts(11, pm.cfg.vocab, (9, 6))
    want = recurrent_reference_generate(pm, pm.init_pool(2), prompts, 8)
    sched = Scheduler(pm, pm.init_pool(2), chunk=4)
    reqs = [Request(rid=i, prompt=p, max_new=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    victim = None
    for _ in range(50):
        sched.step()
        victim = next((r for r in sched.resident
                       if r.rid == 1 and r.state is RequestState.RUNNING
                       and r.generated and not r.done), None)
        if victim is not None:
            break
    assert victim is not None, "rid 1 never reached mid-decode"
    partial = list(victim.generated)
    sched._evict(victim)
    check_scheduler_invariants(sched, reqs)
    out = _drive(sched, [])
    assert sched.stats.n_evictions >= 1
    assert out[1][:len(partial)] == partial
    assert out == dict(enumerate(want))


def test_out_of_slots_staggers_admission(pair):
    pm = pair["rwkv6"][1]
    prompts = _prompts(13, pm.cfg.vocab, (8, 7, 12, 5))
    sched = Scheduler(pm, pm.init_pool(2), chunk=4)
    out = _drive(sched, [Request(rid=i, prompt=p, max_new=5)
                         for i, p in enumerate(prompts)])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == 5 for v in out.values())
    assert sched.family.free_units == 2


def test_prefix_sharing_rejected_for_recurrent(pair):
    pm = pair["rwkv6"][1]
    with pytest.raises(ValueError, match="refcounted"):
        Scheduler(pm, pm.init_pool(2), prefix_sharing=True)


def test_state_pool_exhaustion_raises_typed(pair):
    pm = pair["rwkv6"][1]
    fam = pm.bind(pm.init_pool(2))
    fam.alloc_state(0, 1)
    fam.alloc_state(1, 1)
    with pytest.raises(OutOfPages):
        fam.alloc_state(0, 1)
    fam.release(0)
    fam.alloc_state(0, 1)
    assert fam.free_units == 0


def test_every_admission_zeroes_its_slot(pair, monkeypatch):
    """The scheduler resets each admitted slot through the strided write,
    one burst per state tensor."""
    pm = pair["mamba"][1]
    calls = []
    real = ops.recurrent_state_write

    def spy(pool, slot, value, impl="cuda"):
        calls.append((tuple(pool.shape), slot))
        return real(pool, slot, value, impl=impl)

    monkeypatch.setattr(ops, "recurrent_state_write", spy)
    prompts = _prompts(3, pm.cfg.vocab, (5, 4, 6))
    sched = Scheduler(pm, pm.init_pool(2), chunk=4)
    _drive(sched, [Request(rid=i, prompt=p, max_new=3)
                   for i, p in enumerate(prompts)])
    assert len(calls) == 3 * len(pm.state_specs())


# ---------------------------------------------------------------------------
# Against the JAX scheduler: tokens and accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_scheduler_streams_and_accounting_equal_jax(jx, pair, arch):
    serve = jx[1]
    jm, pm = pair[arch]
    prompts = _prompts(29, pm.cfg.vocab, (8, 5, 7))
    runs = []
    for sched_cls, req_cls, model in ((serve.Scheduler, serve.Request, jm),
                                      (Scheduler, Request, pm)):
        sched = sched_cls(model, model.init_pool(4), chunk=4)
        for i, p in enumerate(prompts):
            sched.submit(req_cls(rid=i, prompt=p, max_new=5))
        runs.append((sched.run(), sched.stats))
    (jout, jst), (out, st) = runs
    assert out == jout
    assert (st.useful_bytes, st.base_bytes, st.pack_bytes) == (
        jst.useful_bytes, jst.base_bytes, jst.pack_bytes)
    assert 0.9 <= st.pack_efficiency <= 1.0
    assert st.base_efficiency <= 0.75
    assert all(s.kind is BurstKind.STRIDED
               for rec in st.records for s in rec.streams)


def test_accounting_functions_equal_jax(jx):
    from repro.core.packing import (
        recurrent_decode_traffic as jdecode,
        recurrent_prefill_traffic as jprefill,
    )
    from repro.core.streams import recurrent_state_streams as jstreams

    for args in ((3, 8, 1000), (0, 8, 1000), (8, 8, 163840 * 4)):
        assert dataclasses.astuple(recurrent_decode_traffic(*args)) == \
            dataclasses.astuple(jdecode(*args))
    for counts in ([4, 0, 2], [0, 0], [32] * 8):
        assert dataclasses.astuple(
            recurrent_prefill_traffic(counts, 8, 1000)) == \
            dataclasses.astuple(jprefill(counts, 8, 1000))
    for slots, batch in (([1, 3], 4), ([0], 1)):
        mine = recurrent_state_streams(slots, batch, 2, (4096, 512))
        theirs = jstreams(slots, batch, 2, (4096, 512))
        assert [(s.base, s.elem_bits, s.count, s.stride) for s in mine] == \
            [(s.base, s.elem_bits, s.count, s.stride) for s in theirs]
        assert all(isinstance(s, StridedStream) for s in mine)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def test_generator_init_is_seeded_and_scaled():
    cfg = CFGS["rwkv6"]
    a = RecurrentLM(cfg, generator=torch.Generator().manual_seed(3),
                    device=CPU)
    b = RecurrentLM(cfg, generator=torch.Generator().manual_seed(3),
                    device=CPU)
    assert torch.equal(a.embed, b.embed)
    assert torch.equal(a.layers["tm"]["wr"], b.layers["tm"]["wr"])
    assert abs(a.embed.std().item() - 0.02) < 0.002
    wr = a.layers["tm"]["wr"]           # (L, d, h, 64): the reference's
    fan_in = wr.shape[0] * wr.shape[1] * wr.shape[2]  # stacked fan-in
    assert abs(wr.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert not a.layers["tm"]["u"].any()
    assert (a.layers["tm"]["lora_a"].std().item() - 0.01) < 0.001


def test_carried_params_are_checked(jx, pair):
    jm, _ = pair["mamba"]
    jax = jx[0]
    layers = jax.tree.map(np.asarray, jm.layers)
    layers["mamba"]["w_in"] = layers["mamba"]["w_in"][:, :, :-1]
    params = recurrent_params_from_numpy(np.asarray(jm.embed), layers,
                                         device=CPU)
    with pytest.raises(ValueError, match="w_in"):
        RecurrentLM(CFGS["mamba"], arch="mamba", device=CPU, params=params)
    with pytest.raises(ValueError, match="unknown recurrent arch"):
        RecurrentLM(CFGS["mamba"], arch="hymba", device=CPU)
