"""The port's boundary: what it imports, where it runs, how it builds.

``src/repro_torch`` and ``chip_smoke.py`` import ``torch``, numpy and the
standard library only — never ``jax``, nothing of the JAX package
``repro`` and nothing of ``benchmarks`` (which imports both).  Every entry point defaults to the GPU and raises where there
is none, and the kernel build raises, naming the command, where ``nvcc``
is missing or fails; nothing falls back to the CPU quietly.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.lm import (init_model,  # noqa: E402
                                   lm_params_from_numpy)
from repro_torch.serve import (  # noqa: E402
    PagedKVCache, PagedLM, RecurrentLM, params_from_numpy,
    recurrent_params_from_numpy)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    """Absolute module names a file imports (relative imports skipped)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
            f"{path}: {name}"


def test_port_files_are_scanned():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]} | {PORT_FILES[-1].name}
    assert {"kernels/ops.py", "kernels/ref.py", "serve/paged_lm.py",
            "serve/scheduler.py", "serve/drafter.py",
            "serve/recurrent_lm.py", "models/common.py", "models/rwkv6.py",
            "models/mamba.py", "configs/rwkv6_3b.py", "core/packing.py",
            "core/streams.py", "core/busmodel.py", "core/banksim.py",
            "workloads/impls.py", "workloads/paper.py",
            "workloads/__main__.py", "models/attention.py", "models/mlp.py",
            "models/lm.py", "optim/optimizers.py", "train/train_step.py",
            "data/pipeline.py", "checkpoint/manager.py",
            "runtime/fault_tolerance.py", "launch/train.py",
            "launch/mesh.py", "launch/specs.py", "launch/dryrun.py",
            "parallel/__init__.py", "parallel/sharding.py",
            "chip_smoke.py"} <= names


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.serve, repro_torch.core, "
            "repro_torch.models.rwkv6, repro_torch.models.mamba, "
            "repro_torch.serve.drafter, repro_torch.serve.recurrent_lm, "
            "repro_torch.kernels.ops, repro_torch.kernels.build, "
            "repro_torch.workloads.impls, repro_torch.workloads.paper, "
            "repro_torch.workloads.__main__, repro_torch.models.lm, "
            "repro_torch.optim, repro_torch.train, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.dryrun, "
            "repro_torch.parallel, repro_torch.parallel.sharding; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = smoke_config("yi-6b")
    with pytest.raises(RuntimeError, match="GPU"):
        PagedLM(cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        PagedKVCache.create(cfg, batch=2, max_len=16, page=4)
    with pytest.raises(RuntimeError, match="GPU"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="GPU"):
        RecurrentLM(smoke_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="GPU"):
        recurrent_params_from_numpy(np.zeros((2, 2)), {})
    with pytest.raises(RuntimeError, match="GPU"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        lm_params_from_numpy({}, cfg)
    # Asked for by name, the CPU works.
    PagedKVCache.create(cfg, batch=2, max_len=16, page=4, device="cpu")


def test_workloads_entry_point_raises_without_a_card():
    """``python -m repro_torch.workloads`` runs on the GPU unless asked for
    the CPU: with no card it fails, naming the GPU, before any output."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.workloads"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "GPU" in res.stderr and "device='cpu'" in res.stderr
    assert res.stdout == ""


def test_train_launcher_raises_without_a_card(tmp_path):
    """``python -m repro_torch.launch.train`` trains on the GPU unless asked
    for the CPU: with no card it fails, naming the GPU, before any output
    and before it writes a corpus or a checkpoint."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--smoke", "--data-dir", str(tmp_path / "data"), "--ckpt-dir",
         str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "GPU" in res.stderr and "device='cpu'" in res.stderr
    assert res.stdout == "" and not list(tmp_path.iterdir())


def test_build_sources_name_every_kernel_file():
    assert set(build.SOURCES) == {
        "stream_converters", "paged_decode", "paged_prefill", "spmv",
        "transpose", "flash_attention"}
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.SOURCES)


def test_fp32_numerics_are_pinned():
    PagedKVCache.create(smoke_config("yi-6b"), 2, 16, page=4, device="cpu")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(build.KernelBuildError, match="nvcc") as err:
        build.build_all()
    assert "-gencode arch=compute_90a,code=sm_90a" in str(err.value)
    assert not (tmp_path / "out").exists()


def test_failed_build_raises_naming_the_command(monkeypatch, tmp_path):
    failing = tmp_path / "nvcc"
    failing.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 3\n")
    failing.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(failing))
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "out")
    with pytest.raises(build.KernelBuildError) as err:
        build.build_all()
    msg = str(err.value)
    assert f"$ {failing}" in msg and "no such target" in msg
    assert "paged_decode.cu" in msg
    assert not list((tmp_path / "out").glob("*.so"))
