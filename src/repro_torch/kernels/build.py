"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
into a shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>-<hash>.so
         src/repro_torch/kernels/csrc/<name>.cu

The library name carries a hash of its source, so an edited kernel is
never served from a stale build.  All missing libraries are compiled at
once, one ``nvcc`` per source started together, the first time any kernel
is launched; nothing is built when the module is imported.  The output
goes to ``build/repro_torch/`` at the root of the checkout, and ptxas's
register and shared-memory report for each library sits beside it as
``lib<name>-<hash>.log``.

Libraries are loaded with :mod:`ctypes`; the wrappers in :mod:`.ops` pass
every pointer and the CUDA stream as ``c_void_p``.  A missing ``nvcc`` or
a failed build raises :class:`KernelBuildError` naming the command.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["KernelBuildError", "SOURCES", "build_all", "build_dir", "library"]

CSRC = Path(__file__).resolve().parent / "csrc"
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")
SOURCES = ("stream_converters", "paged_decode", "paged_prefill", "spmv",
           "transpose")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or a kernel source failed to compile."""


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return CSRC.parents[3] / "build" / "repro_torch"


def nvcc_path() -> str:
    """The ``nvcc`` on ``PATH``, else the CUDA toolkit's default one."""
    found = shutil.which("nvcc")
    if found:
        return found
    if TOOLKIT_NVCC.exists():
        return str(TOOLKIT_NVCC)
    raise KernelBuildError(
        f"nvcc not found on PATH or at {TOOLKIT_NVCC}; the CUDA "
        f"kernels are built with: nvcc {' '.join(NVCC_FLAGS)} -o <lib>.so "
        f"{CSRC}/<name>.cu"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: library path}``.  Each library is written under a
    temporary name and renamed into place, so a concurrent build of the
    same source never leaves a half-written file behind.
    """
    out = {name: _lib_path(name) for name in SOURCES}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd: List[str] = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")]
        procs.append((path, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for path, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, path)
    if failed:
        raise KernelBuildError(
            "CUDA kernel build failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; have {SOURCES}")
    return ctypes.CDLL(str(build_all()[name]))
