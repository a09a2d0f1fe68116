"""The port's spans (``titanet_torch.utils.profiling.span``) on the CPU at
toy widths: off without a profiler, the embedder's and the trainer's span
trees and counts under ``profiling.trace``; on the card the step graphs'
spans and ``StepTimer``'s device time.

Imports neither JAX nor the JAX package, so the card's cases also run
where only the port is installed:

    python -m pytest tests/test_torch_tracing.py --noconftest -q

Without a CUDA device those cases skip.
"""

import json
import os

import numpy as np
import pytest
import torch

from titanet_torch.data.loader import Batch, device_prefetch
from titanet_torch.losses import build_head
from titanet_torch.models.titanet import TitaNet
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train import state as ts
from titanet_torch.train.capture import GRAPHS, owned_tensors
from titanet_torch.train.extractor import SpeakerEmbedder
from titanet_torch.utils import profiling
from titanet_torch.utils.logging import StepTimer

FE = FrontendConfig.from_ms()
BUCKETS = [4000, 8000]
BATCH = 2
# 3000, 3500 and 2000 in the first bucket (a full batch and a partial one),
# 7000 in the second, and 17000 past the last bucket: windows of 8000 every
# 4000 (0, 4000, 8000) and the one ending at the end (9000)
LENGTHS = [3000, 7000, 3500, 17000, 2000]


def _model(device="cpu"):
    torch.manual_seed(0)
    return TitaNet(n_mega_blocks=1, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
                   attention_hidden_size=8, dropout=0.0).to(device)


def _waves(lengths=LENGTHS):
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture
def no_record_function(monkeypatch):
    """Fails any profiler region the program opens."""
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"a profiler region {name!r} opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)


def _train_state(model):
    head = build_head("ce", 16, 3, device="cpu")
    return ts.create_train_state(model, head, ts.make_optimizer("adam", start_lr=1e-3), seed=0)


def _feed(rows=2, t=4000, steps=2):
    rng = np.random.default_rng(1)
    return [Batch((0.1 * rng.standard_normal((rows, t))).astype(np.float32), np.full(rows, t, np.int32),
                  rng.integers(0, 3, rows).astype(np.int32)) for _ in range(steps)]


def _train(state, feed):
    for tensors, _ in device_prefetch(feed, device="cpu"):
        state, _ = ts.train_step(state, tensors["waveform"], None, tensors["speaker_ids"], frontend=FE)
    return state


def test_span_without_a_profiler_is_the_shared_null_context(no_record_function):
    before = len(profiling.spans())
    a, b = profiling.span("x", rows=3), profiling.span("y")
    assert a is b and not a
    with a as sp:
        sp.count(rows=4)
    assert len(profiling.spans()) == before


def test_no_record_function_on_the_serving_and_training_paths_without_a_profiler(model, no_record_function):
    before = len(profiling.spans())
    SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu").embed(_waves())
    _train(_train_state(_model()), _feed())
    assert len(profiling.spans()) == before


def _traced_embed(model, logdir):
    embedder = SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
    with profiling.trace(logdir):
        embedder.embed(_waves())
    (request,) = [s for s in profiling.spans() if s["name"] == "embed.request"][-1:]
    return request, [s for s in profiling.spans() if s["root"] == request["root"] and s is not request]


def test_embedder_logs_its_span_tree_under_one_request_id(model, tmp_path):
    request, inner = _traced_embed(model, str(tmp_path))
    assert request["parent"] is None and request["root"] is not None
    assert request["counts"] == {"waveforms": 5, "windows": 8, "samples": sum(LENGTHS)}
    by_name = {}
    for s in inner:
        by_name.setdefault(s["name"], []).append(s)
        assert s["root"] == request["root"]
        assert request["start_ns"] <= s["start_ns"] <= s["end_ns"] <= request["end_ns"]
    # 4 windows and 7000 in the 8000 bucket (batches of 2, 2, 1); 3000, 3500, 2000 in 4000 (2, 1)
    assert {n: len(v) for n, v in by_name.items()} == {"embed.plan": 1, "embed.pad": 5, "embed.step": 5,
                                                      "embed.upload": 5, "embed.readback": 5, "embed.merge": 1}
    steps = {s["seq"]: s for s in by_name["embed.step"]}
    for s in inner:  # the upload under its step, every other span directly under the request
        parent = steps[s["parent"]] if s["name"] == "embed.upload" else request
        assert s["parent"] == parent["seq"] and parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    order = [s["name"] for s in sorted(inner, key=lambda s: s["start_ns"])]
    assert order[0] == "embed.plan" and order[-1] == "embed.merge"
    # each batch after the first is padded and launched before the one before it is read back
    batch = ["embed.pad", "embed.step", "embed.upload"]
    assert order[1:-1] == batch + (batch + ["embed.readback"]) * 4 + ["embed.readback"]


def test_embedder_pad_counts_equal_hand_counts(model, tmp_path):
    _, inner = _traced_embed(model, str(tmp_path))
    pads = [s["counts"] for s in sorted(inner, key=lambda s: s["start_ns"]) if s["name"] == "embed.pad"]
    windows = [8000, 8000, 8000, 8000]  # 17000: starts 0, 4000, 8000, then 9000
    want = [(4000, [3000, 3500]), (4000, [2000]), (8000, [7000] + windows[:1]), (8000, windows[1:3]),
            (8000, windows[3:])]
    assert pads == [{"bucket": b, "rows": BATCH, "real_rows": len(real), "computed_samples": BATCH * b,
                     "real_samples": sum(real), "in_flight": int(k > 0)} for k, (b, real) in enumerate(want)]
    uploads = [s["counts"] for s in inner if s["name"] == "embed.upload"]
    assert uploads == [{"bytes": BATCH * b * 4 + BATCH * 4, "pinned": False} for b, _ in want]


def test_trace_writes_the_span_names_and_log_beside_the_chrome_trace(model, tmp_path):
    _traced_embed(model, str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 2 and names[0].startswith("spans_") and names[1].startswith("trace_")
    text = open(tmp_path / names[1]).read()
    for name in ("embed.request", "embed.plan", "embed.pad", "embed.step", "embed.upload", "embed.readback",
                 "embed.merge"):
        assert f'"{name}"' in text
    logged = [json.loads(line) for line in open(tmp_path / names[0])]
    assert sorted({s["name"] for s in logged}) == ["embed.merge", "embed.pad", "embed.plan", "embed.readback",
                                                   "embed.request", "embed.step", "embed.upload"]
    assert len(logged) == 23


def test_trainer_logs_feed_step_and_prepare(tmp_path):
    state = _train_state(_model())
    first, mark = state.step, len(profiling.spans())
    with profiling.trace(str(tmp_path)):
        _train(state, _feed(steps=2))
    logged = profiling.spans()[mark:]
    assert sorted(s["name"] for s in logged) == ["feed.gather"] * 2 + ["train.prepare"] * 2 + ["train.step"] * 2
    steps = [s for s in logged if s["name"] == "train.step"]
    assert [s["root"] for s in steps] == [first, first + 1]
    for s in steps:
        (prep,) = [p for p in logged if p["name"] == "train.prepare" and p["parent"] == s["seq"]]
        assert prep["root"] == s["root"] and s["start_ns"] <= prep["start_ns"] <= prep["end_ns"] <= s["end_ns"]
    gathers = [s for s in logged if s["name"] == "feed.gather"]
    assert len(gathers) == 2 and all(g["parent"] is None for g in gathers)
    assert [g["counts"] for g in gathers] == [{"rows": 2}] * 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (step graphs and CUDA events)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_graph_spans_on_a_captured_embed_step(cuda_device, tmp_path):
    model = _model(cuda_device)
    wav, lens = np.zeros((BATCH, 6000), np.float32), np.full(BATCH, 6000, np.int32)
    logged = []
    for _ in range(2):
        with profiling.trace(str(tmp_path)) as prof:
            ts.embed_step(model, wav, lens, frontend=FE, device=cuda_device)
            torch.cuda.synchronize()
        logged.append([s for s in profiling.spans() if s["name"].startswith(("graph.", "embed."))][-4:])
        # a span marks the host's row only: nothing of it is counted as the device's work
        assert not [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and e.name.startswith(("graph.", "embed."))]
    walked = len(owned_tensors(model))
    for call, last in zip(logged, ("graph.capture", "graph.replay")):
        # in the order they ended: the step last, over the others
        assert [s["name"] for s in call] == ["embed.upload", "graph.key", last, "embed.step"]
        assert all(s["parent"] == call[3]["seq"] for s in call[:3])
        assert call[1]["counts"] == {"tensors": walked}
        assert call[2]["counts"] == {"step": "embed_step"}


@pytest.mark.cuda
def test_a_replay_logs_no_span_of_the_step_body(cuda_device, tmp_path):
    x = torch.ones(8, device=cuda_device)

    def body(x):
        with profiling.span("body"):
            return x * 2

    names = []
    for _ in range(2):
        with profiling.trace(str(tmp_path)):
            mark = len(profiling.spans())
            GRAPHS.run("span_body", None, (), body, (x,))
            torch.cuda.synchronize()
        names.append([s["name"] for s in profiling.spans()[mark:]])
    # the body runs at the warm-up and the capture only
    assert names == [["graph.key", "body", "body", "graph.capture"], ["graph.key", "graph.replay"]]


@pytest.mark.cuda
def test_step_timer_reads_the_device_time_of_each_step(cuda_device):
    """No step waits for the card: the host's time in "model" is the
    enqueue, the timer's the device's."""
    a = torch.randn(4096, 4096, device=cuda_device)
    timer = StepTimer(cuda_device)
    pairs = []
    for _ in range(3):
        timer.start("data")
        timer.start("model")
        pairs.append((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        for _ in range(20):
            b = a @ a
        pairs[-1][1].record()
    timer.stop()
    got = timer.epoch_metrics("train")
    device = 1e-3 * sum(t0.elapsed_time(t1) for t0, t1 in pairs)
    assert b.shape == a.shape and device > 0.01
    assert got["train/total_model_time"] == pytest.approx(device, rel=0.05)
    assert got["train/avg_model_time"] == pytest.approx(device / 3, rel=0.05)
    assert set(got) == {"train/total_data_time", "train/avg_data_time", "train/total_model_time",
                        "train/avg_model_time"}
