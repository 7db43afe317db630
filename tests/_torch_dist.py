"""Process spawning for the port's mesh-parallel tests on the CPU.

The port's side runs as ``world`` processes of ``python <test file>
<case> <rank> <world> <dir>``: each joins a ``gloo`` group through a file
store in ``<dir>`` (no TCP port, so parallel test workers cannot
collide), runs the test file's worker for ``<case>`` and saves what it
returns as ``<dir>/<case>_<rank>.pt``.  The reference's side runs as one
subprocess with 8 fake CPU devices, as ``tests/test_distributed.py``
runs it.  Every spawn has one timeout, so a hang fails a test instead of
the suite.
"""
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300


def keyed(prefix: str, tree) -> dict:
    """A JAX tree's leaves as numpy arrays under ``prefix + keystr``."""
    import jax
    import numpy as np

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def nest(flat: dict, prefix: str) -> dict:
    """The entries of ``flat`` under ``prefix`` (``keyed``'s form) as the
    nested dict."""
    tree = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            names = re.findall(r"\['([^']+)'\]", key[len(prefix):])
            node = tree
            for name in names[:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = val
    return tree


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]]
                                          if env.get("PYTHONPATH") else []))
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **extra)
    return env


def start_ranks(script, case: str, world: int, work: Path):
    """Start the ``world`` ranks of ``case``; returns their processes."""
    store = work / f"store_{case}"
    store.mkdir(parents=True)
    procs = []
    for rank in range(world):
        log = open(work / f"{case}_{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), case, str(rank), str(world),
             str(work)], stdout=log, stderr=subprocess.STDOUT, cwd=work,
            env=_env()))
    return procs


def start_reference(code: str, work: Path, name: str = "reference"):
    """Start the reference's side: ``code`` with 8 fake CPU devices."""
    body = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n" + code)
    log = open(work / f"{name}.log", "w")
    return [subprocess.Popen([sys.executable, "-c", body], stdout=log,
                             stderr=subprocess.STDOUT, cwd=work,
                             env=_env(JAX_PLATFORMS="cpu"))]


def wait_all(procs, work: Path, timeout_s: float = TIMEOUT_S) -> None:
    """Wait for every process; on a failure or at the timeout, kill the
    rest and raise with the logs."""
    deadline = time.monotonic() + timeout_s
    failed = None
    for p in procs:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc != 0:
            failed = (p.args, rc)
            break
    if failed is None:
        return
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    logs = "\n".join(f"--- {f.name}\n{f.read_text()[-3000:]}"
                     for f in sorted(work.glob("*.log")))
    raise AssertionError(f"{failed[0]} ended with {failed[1]}\n{logs}")


def worker_main(workers: dict) -> None:
    """Entry of a rank: ``<case> <rank> <world> <dir>`` from argv."""
    import torch

    from repro_torch.parallel import collectives

    case, rank, world, work = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), Path(sys.argv[4])
    torch.set_num_threads(1)
    collectives.init_group(str(work / f"store_{case}"), rank, world,
                           device_type="cpu")
    try:
        out = workers[case](rank, world, work)
        torch.save(out, work / f"{case}_{rank}.pt")
    finally:
        collectives.destroy_group()
