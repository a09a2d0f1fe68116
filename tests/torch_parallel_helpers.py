"""Spawning the ranks of the port's data-parallel CPU tests: each rank is a
process of ``tests/torch_parallel_worker.py`` (or any command) on a gloo
group over 127.0.0.1, with a wall-clock timeout that fails the test."""

import os
import pickle
import subprocess
import sys

import torch

from titanet_torch.parallel.distributed import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT_S = 180


def rank_env(**extra) -> dict:
    """The environment of a rank: one thread, JAX kept off the card, and a
    60 s bound on every collective."""
    env = dict(os.environ, OMP_NUM_THREADS="1", TITANET_DIST_TIMEOUT="60", JAX_PLATFORMS="cpu")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def communicate(procs, timeout: float = TIMEOUT_S):
    """Wait for every process, each within ``timeout``; on a timeout kill
    them all and fail. Returns ``[(returncode, output)]``."""
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=timeout)[0], p))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"a rank did not finish within {timeout} s")
    return [(p.returncode, out) for out, p in outs]


def start_worker_ranks(task: str, inputs: dict, tmp_path, world: int = 2, **env):
    """Start ``task`` of the worker on ``world`` ranks (``env``: more
    environment for each); returns the processes and their output files."""
    inp = tmp_path / f"{task}_inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    outs = [tmp_path / f"{task}_rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, task, str(r), str(world), str(port), str(inp), str(outs[r])],
                              cwd=REPO, env=rank_env(**env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    return procs, outs


def run_worker_ranks(task: str, inputs: dict, tmp_path, world: int = 2, **env):
    """Run ``task`` of the worker on ``world`` ranks; returns each rank's
    saved results (asserts every rank exited 0)."""
    procs, outs = start_worker_ranks(task, inputs, tmp_path, world, **env)
    for rc, log in communicate(procs):
        assert rc == 0, log[-4000:]
    return [torch.load(o, weights_only=False) for o in outs]
