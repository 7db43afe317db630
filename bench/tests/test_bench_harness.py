"""The benchmark's harness on the CPU: each driver end to end on smoke
configurations through the program's plain path, the comparison failing
on a lower precision and on planted faults, and the module guard.

    PYTHONPATH=src python -m pytest bench/tests -q

The cells themselves run only on the card (``python3 bench/run.py``); the
test marked ``cuda`` checks there that a cell's result line is whole.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SMOKE = BENCH / "tests" / "smoke"
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

import run  # noqa: E402
from harness.common import forbidden_modules  # noqa: E402
from harness.traffic import Traffic, length_grid  # noqa: E402


def smoke(workload, seed=11, seconds=2.0, trace=0, control=""):
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    return run.run_cell(args, device="cpu", root=SMOKE)


def test_serve_closed_loop_runs_and_is_correct():
    r = smoke("tiny-paged.closed-smoke", seed=2**31 + 17)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"serve_tok_s", "ttft_p95_ms", "tpot_p95_ms",
                                 "setup_s"}
    assert r["attempted"] > 4 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["checks"]["kv_gap"]["value"] < 1e-5
    assert r["notes"]["residents_checked"] == 2


def test_serve_open_loop_reports_lateness():
    r = smoke("tiny-paged.poisson-smoke")
    assert r["correct"], r["checks"]
    assert "late_p95_ms" in r["notes"]
    assert r["metrics"]["serve_tok_s"]["value"] > 0


def test_serve_traced_run_reads_spans():
    r = smoke("tiny-paged.closed-smoke", trace=1)
    got = r["metrics"]
    assert got["decode_batch_mean"]["value"] > 1
    assert got["decode_step_ms"]["value"] > 0
    assert got["prefill_ms_per_ktok"]["value"] > 0
    assert r["correct"]


@pytest.mark.parametrize("control", ["tf32", "int8"])
def test_serve_control_is_not_correct(control):
    r = smoke("tiny-paged.closed-smoke", control=control)
    assert not r["correct"], r["checks"]


def test_train_runs_and_is_correct():
    r = smoke("tiny-moe.train-smoke", seconds=2.0)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_tok_s", "setup_s"}


@pytest.mark.parametrize("control", ["fp8", "half_batch"])
def test_train_control_is_not_correct(control):
    r = smoke("tiny-moe.train-smoke", seconds=1.0, control=control)
    assert not r["correct"], r["checks"]


def _patched_run(workload, patch, seconds=2.0):
    """A smoke run with ``patch(module)`` applied to the program first."""
    code = f"""
import argparse, json, sys
sys.path.insert(0, {str(BENCH)!r}); sys.path.insert(1, {str(ROOT / 'src')!r})
import run
{patch}
args = argparse.Namespace(workload={workload!r}, seed=3, seconds={seconds},
                          trace=0, control="")
r = run.run_cell(args, device="cpu", root=__import__("pathlib").Path({str(SMOKE)!r}))
print(json.dumps({{"correct": r["correct"], "checks": r["checks"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


ALTERED_TOKEN = """
from repro_torch.serve import paged_lm
orig = paged_lm.PagedFamily.decode_steps
def decode_steps(self, tokens, active, n):
    out = orig(self, tokens, active, n)
    out[-1] = (out[-1] + 1) % self.vocab   # every active slot's last token
    return out
paged_lm.PagedFamily.decode_steps = decode_steps
"""

SKIPPED_KV_WRITE = """
from repro_torch.kernels import ops
ops.paged_kv_write = lambda *a, **k: None   # the append leaves the pool as it was
"""

UNCHANGED_STATE = """
from repro_torch.optim import optimizers
orig = optimizers._adamw
def adamw(cfg):
    opt = orig(cfg)
    def update(grads, state, params, step):
        return params, state, {"grad_norm": optimizers.global_norm(grads)}
    return optimizers.Optimizer(opt.init, update)
optimizers._adamw = adamw
"""

HALF_BATCH = """
from repro_torch.train import train_step
orig = train_step.make_loss_fn
def make_loss_fn(cfg, impl="cuda", rules=None):
    fn = orig(cfg, impl, rules)
    def loss_fn(params, batch):
        half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
        return fn(params, half)
    return loss_fn
train_step.make_loss_fn = make_loss_fn
"""


@pytest.mark.parametrize("workload,patch", [
    ("tiny-paged.closed-smoke", ALTERED_TOKEN),
    ("tiny-paged.closed-smoke", SKIPPED_KV_WRITE),
    ("tiny-moe.train-smoke", UNCHANGED_STATE),
    ("tiny-moe.train-smoke", HALF_BATCH),
], ids=["token-altered", "kv-write-skipped", "state-unchanged",
        "half-batch"])
def test_planted_fault_is_not_correct(workload, patch):
    r = _patched_run(workload, patch)
    assert r["correct"] is False, r["checks"]


def test_no_jax_or_reference_package_after_a_cell():
    code = f"""
import argparse, sys
sys.path.insert(0, {str(BENCH)!r}); sys.path.insert(1, {str(ROOT / 'src')!r})
import run
from harness.common import forbidden_modules
args = argparse.Namespace(workload="tiny-paged.closed-smoke", seed=1,
                          seconds=1.0, trace=0, control="")
run.run_cell(args, device="cpu", root=__import__("pathlib").Path({str(SMOKE)!r}))
print(forbidden_modules(), "repro_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_modules_import_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(BENCH)!r})
import reference.paged_lm, reference.olmoe
print(sorted({{m.split('.')[0] for m in sys.modules}}
             & {{'repro_torch', 'repro', 'jax'}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in forbidden_modules()


def test_traffic_sizes_do_not_depend_on_the_seed():
    params = json.loads((BENCH / "traffic" / "long-decode.json").read_text())
    blocks, orders = [], []
    for seed in (1, 2**40 + 3):
        streams = Traffic(params, seed, 64000).client_streams()
        got = [next(streams[i % len(streams)]).max_new for i in range(4096)]
        blocks.append([sorted(got[i:i + 64]) for i in range(0, 4096, 64)])
        orders.append(got)
    assert blocks[0] == blocks[1]          # every block of 64: same sizes
    assert orders[0] != orders[1]          # in another order
    grid = length_grid(params["output"])
    assert grid.min() >= 256 and grid.max() <= 3072
    assert abs(np.median(grid) - 1536) <= 1


def test_residual_first_requests_fit_the_slots():
    for name in ("long-decode", "rag-prefill"):
        params = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
        firsts, _ = Traffic(params, 7, 64000).first_requests()
        cap = params["serve"]["max_len"]
        assert all(len(f.prompt) + f.max_new - 1 <= cap for f in firsts)
        assert all(f.max_new >= 1 for f in firsts)


@pytest.mark.cuda
def test_cell_result_line_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "yi-6b-paged.rag-prefill", "--seed", "5", "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
