"""The data-parallel steps' capture (``titanet_torch.parallel`` on an NCCL
group, ``titanet_torch.train.capture``), the parts a CPU can hold. Two gloo
ranks (spawned once for the module) and this process:

- the global-batch BatchNorm's frame count, now made on the device, gives
  the bits the host-made count gave, masked and unmasked;
- the ``shard_map`` step's persistent rank generators, reseeded before each
  step, draw the dropout and SpecAugment masks that a fresh generator of
  that step and rank draws;
- the ``shard_map`` step split for capture (the optimizer's host scalars
  outside the step, its device side inside) equals the former step, which
  called ``optimizer.update`` and drew from fresh generators, to the bit
  over 3 steps, and still equals JAX's ``shard_map`` step (loss rtol 2e-5,
  as ``tests/test_torch_parallel.py`` holds it);
- on a gloo group a step told it runs on the card stays eager with
  ``capture=None`` (no graph is asked for; equal bits to ``capture=False``)
  and raises with ``capture=True``, naming NCCL;
- the collective counts a capture records are added back by each replay,
  the replay watchdog fails the process once a replay's collectives
  outlast the timeout, and the graphs that hold collectives are dropped
  before their process group.

The graphs themselves run on NCCL ranks, one card each
(``tests/test_torch_cuda.py -k nccl``, ``chip_smoke.py`` phase 20).
"""

import gc
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import N_CLASSES, SM, _loader_batches, _shard_map_inputs
from tests.test_torch_parallel_norm import CASES
from tests.torch_parallel_helpers import run_worker_ranks
from titanet_torch.ops.augment import spec_augment
from titanet_torch.ops.norm import FastDropout
from titanet_torch.parallel import distributed as pd
from titanet_torch.parallel.mesh import Mesh
from titanet_torch.parallel.shard_map_step import _rank_seed
from titanet_torch.train import capture
from titanet_torch.train import state as ts
from titanet_tpu.losses import heads as jh
from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.parallel import make_mesh as jax_make_mesh
from titanet_tpu.parallel.shard_map_step import make_shard_map_train_step, replicate_state
from titanet_tpu.train import state as js


@pytest.fixture(scope="module")
def inputs():
    return {"bn": {k: CASES[k] for k in ("masked", "unmasked")}, "shard_map": _shard_map_inputs(),
            "batches": _loader_batches()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return run_worker_ranks("capture", inputs, tmp_path_factory.mktemp("capture"))


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


@pytest.mark.parametrize("case", ["masked", "unmasked"])
def test_device_made_frame_count_gives_the_former_bits(ranks, case):
    for r in ranks:
        got, former = r["bn/" + case]
        assert got.keys() == former.keys()
        for k in got:
            assert torch.equal(got[k], former[k]), (case, k)


class _State:
    def __init__(self, step):
        self.step = step
        self.generator = torch.Generator().manual_seed(3)


@pytest.mark.parametrize("rank", [0, 1])
def test_reseeded_rank_generators_draw_a_fresh_generators_masks(rank):
    """One generator a stream, reseeded before each step, against a fresh
    generator made each step: the same dropout and SpecAugment masks at
    every step."""
    mesh = Mesh(size=2, rank=rank, device=torch.device("cpu"))
    drop = FastDropout(0.5).train()
    x = torch.zeros(4, 30, 16)
    mel = torch.randn(4, 50, 80, generator=torch.Generator().manual_seed(0))
    kept = {1: torch.Generator(), 2: torch.Generator()}
    seen = []
    for step in range(3):
        st = _State(step)
        for stream, gen in kept.items():
            gen.manual_seed(_rank_seed(st, mesh, stream))
        fresh = {s: torch.Generator().manual_seed(_rank_seed(st, mesh, s)) for s in (1, 2)}
        for gens in (kept, fresh):
            with mesh.active(global_batch=False):
                masks = (spec_augment(gens[1], mel, probability=0.5), drop.keep_mask(x, gens[2]),
                         drop.keep_mask(x, gens[2]))
            seen.append(masks)
        assert all(torch.equal(a, b) for a, b in zip(seen[-2], seen[-1])), step
    # the steps draw apart
    assert not torch.equal(seen[0][1], seen[2][1])


def test_split_shard_map_step_equals_the_former_step_to_the_bit(ranks):
    """Dropout 0.5, SpecAugment, Adam with clipping, 3 steps on each rank:
    losses, predictions, every parameter, running statistic, Adam moment,
    the counters and the generators' states."""
    for r in ranks:
        got, former = r["shard_map/split"], r["shard_map/former"]
        assert got["state"]["counters"] == (3, 3, 0)
        assert _equal(got, former)


def test_split_shard_map_step_matches_jax_on_a_two_device_mesh(inputs, ranks):
    sm = inputs["shard_map"]
    model = JaxTitaNet(dropout=0.0, axis_name="data", **SM)
    head = jh.build_head("ce", 16, N_CLASSES)
    opt = js.make_optimizer(start_lr=1e-3, grad_clip_norm=1.0)
    plain = JaxTitaNet(dropout=0.0, **SM)
    state = js.create_train_state(jax.random.key(0), plain, head, opt, jnp.zeros((2, 101, 80)), N_CLASSES)
    mesh = jax_make_mesh(2)
    step = make_shard_map_train_step(mesh, model=model, head=head, optimizer=opt, frontend=JaxFrontend.from_ms())
    shard = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    state = replicate_state(state, mesh)
    losses = []
    for _ in range(3):
        state, m = step(state, *(jax.device_put(sm[k], shard) for k in ("wav", "lengths", "speakers")))
        losses.append(float(m["loss"]))
    for r in ranks:
        got = r["shard_map/jax"]
        assert got["state"]["counters"] == (3, 3, 0)
        np.testing.assert_allclose([x.item() for x in got["losses"]], losses, rtol=2e-5)


def test_capture_none_under_a_gloo_mesh_runs_eagerly(ranks):
    for r in ranks:
        g = r["gloo"]
        assert g["graph_calls"] == []
        assert _equal(g["train_step"][None], g["train_step"][False])
        assert _equal(g["shard_map"][None], g["shard_map"][False])


@pytest.mark.parametrize("step", ["train_step", "shard_map"])
def test_capture_true_under_a_gloo_mesh_raises_naming_nccl(ranks, step):
    for r in ranks:
        msg = r["gloo"]["errors"][step]
        assert msg is not None and "NCCL" in msg and "gloo" in msg


def test_wanted_under_mesh_follows_the_backend_rule():
    """Without a group (or at P = 1) the single-card rule; on the CPU
    ``capture=True`` raises as there."""
    one = Mesh(size=1, rank=0, device=torch.device("cpu"))
    assert ts.wanted_under_mesh(None, torch.device("cuda"), one)
    assert not ts.wanted_under_mesh(None, torch.device("cpu"), one)
    assert not ts.wanted_under_mesh(False, torch.device("cuda"), None)
    with pytest.raises(ValueError, match="CUDA"):
        ts.wanted_under_mesh(True, torch.device("cpu"), None)


def test_replayed_collectives_are_counted_as_eager_ones():
    """What a capture records (and takes back) is what each replay adds:
    N replays after one warm-up read as N + 1 eager steps."""
    def eager_step():
        pd.add_stats({"batchnorm": (3, 300), "gradients": (1, 4096)})

    pd.reset_collective_stats()
    for _ in range(4):
        eager_step()
    eager = pd.collective_stats()

    pd.reset_collective_stats()
    eager_step()  # the warm-up call
    snap = pd.stats_snapshot()
    eager_step()  # the capture
    delta = pd.stats_since(snap)
    assert delta == {"batchnorm": (3, 300), "gradients": (1, 4096)}
    assert pd.collective_stats()["count"] == 4  # the warm-up's
    for _ in range(3):
        pd.add_stats(delta)
    assert pd.collective_stats() == eager
    pd.reset_collective_stats()


class _Event:
    def __init__(self, done=True):
        self.done = done

    def query(self):
        return self.done


def test_replay_watchdog_passes_completed_replays_and_fails_a_stuck_one():
    aborted, exited = [], threading.Event()
    dog = capture.ReplayWatchdog(abort=lambda: aborted.append(True), exit=lambda code: exited.set(), grace_s=0.0,
                                 poll_s=0.005)
    for _ in range(3):
        dog.watch(_Event(True), 0.2)
    time.sleep(0.1)
    assert dog.pending() == 0 and dog.error is None and not exited.is_set()
    stuck = _Event(False)
    t0 = time.monotonic()
    dog.watch(stuck, 0.3)
    assert exited.wait(5.0)
    assert 0.3 <= time.monotonic() - t0 < 5.0
    assert aborted == [True] and "TITANET_DIST_TIMEOUT" in dog.error
    with pytest.raises(RuntimeError, match="a rank is lost"):
        dog.watch(_Event(True), 0.2)


def test_replay_watchdog_clock_starts_when_the_replay_before_completes():
    """A replay queued behind a slow one is not timed from its recording."""
    exited = threading.Event()
    dog = capture.ReplayWatchdog(abort=lambda: None, exit=lambda code: exited.set(), grace_s=0.0, poll_s=0.005)
    slow, queued = _Event(False), _Event(True)
    dog.watch(slow, 1.0)
    dog.watch(queued, 0.2)
    time.sleep(0.5)  # longer than the queued replay's timeout
    slow.done = True
    time.sleep(0.1)
    assert not exited.is_set() and dog.pending() == 0


def test_release_collectives_drops_only_the_graphs_that_hold_collectives():
    """The graphs whose replays issue collectives go before the process
    group does (a graph must not outlive its communicators); the others
    stay."""
    graphs = capture.StepGraphs()
    make = lambda coll: capture.StepGraph(None, (), [], None, (), 0.0, (), (), coll)  # noqa: E731
    graphs._graphs.update({"dp": make({"gradients": (1, 4)}), "serving": make({})})
    assert graphs.release_collectives() == 1
    assert list(graphs._graphs) == ["serving"]
    assert graphs.release_collectives() == 0


def test_leaving_the_group_drops_the_held_graphs_first_and_pins_no_cache(monkeypatch):
    """``destroy_process_group`` drops every registered cache's graphs that
    hold collectives before the group goes; the registry is weak."""
    graphs = capture.StepGraphs()
    make = lambda coll: capture.StepGraph(None, (), [], None, (), 0.0, (), (), coll)  # noqa: E731
    graphs._graphs.update({"dp": make({"gradients": (1, 4)}), "serving": make({})})
    pd.hold_collectives(graphs)
    seen = []
    monkeypatch.setattr(pd.dist, "destroy_process_group", lambda: seen.append(sorted(graphs._graphs)))
    pd.destroy_process_group()
    assert seen == [["serving"]]
    ref = weakref.ref(graphs)
    del graphs
    gc.collect()
    assert ref() is None and pd.release_collectives() == 0

