"""The yardstick's counts: model FLOPs against a hand count and against
torch's own FLOP counter on the plain reference, each kernel's least work
by hand, and no share above 100% for any time at or above its least."""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core.bench import Cell
from perfbench.core.trace import Trace
from perfbench.core.weights import draw_weights
from perfbench.metrics import _counts
from perfbench.core import bench
from perfbench.reference import titanet as ref_titanet
from perfbench.tests import toy

SMALL = dict(toy._load(toy.PERFBENCH, "configs", "titanet_s.json"), n_mega_blocks=2, hidden_size=32,
             kernel_size=5, output_size=48, attention_hidden_size=8, embedding_size=16,
             frontend=dict(toy._load(toy.PERFBENCH, "configs", "titanet_s.json")["frontend"], n_mels=10))


def test_flops_by_hand():
    # prolog 3*10*32, per block 3*(5*32 + 32*32) + 32*32, epilog 32*48, pool 2*48*8
    per_frame = 2 * (3 * 10 * 32 + 2 * (3 * (5 * 32 + 32 * 32) + 32 * 32) + 32 * 48 + 2 * 48 * 8)
    assert _counts.forward_flops_per_frame(SMALL) == per_frame
    # SE: 2 blocks x (32*2 + 2*32); decoder linear 96*16
    assert _counts.forward_flops_per_row(SMALL) == 2 * (2 * (32 * 2 + 2 * 32) + 96 * 16)
    assert _counts.train_step_flops(SMALL, 4, 1600, 7) == 3 * (
        4 * (11 * per_frame + _counts.forward_flops_per_row(SMALL)) + 4 * 2 * 16 * 7)


@pytest.mark.parametrize("name", ["titanet_s", "titanet_l"])
def test_published_flops(name):
    cfg = toy._load(toy.PERFBENCH, "configs", f"{name}.json")
    # 10.69 and 46.70 MFLOP a frame; within 5% of the paper's 6.4 M and 25.3 M parameters
    expect = {"titanet_s": 10_686_976, "titanet_l": 46_704_640}[name]
    assert _counts.forward_flops_per_frame(cfg) == expect
    params = sum(math.prod(s) for _, s, _, _ in ref_titanet.param_spec(cfg)) / 1e6
    assert abs(params / cfg["paper"]["params_m"] - 1) < 0.05


def test_flops_match_torch_counter():
    weights = draw_weights(ref_titanet.param_spec(SMALL), 3, "cpu")
    for name, c in ref_titanet.norm_sites(SMALL):
        weights[f"{name}.running_mean"], weights[f"{name}.running_var"] = torch.zeros(c), torch.ones(c)
    mel = torch.randn(3, 57, 10)
    with FlopCounterMode(display=False) as counter:
        ref_titanet.Net(weights, SMALL)(mel)
    assert counter.get_total_flops() == 3 * (57 * _counts.forward_flops_per_frame(SMALL)
                                             + _counts.forward_flops_per_row(SMALL))


def test_embed_flops():
    buckets = [100, 200, 400]
    # 900 -> windows 0, 200, 400 and 500 (ends at the end), all of 400
    cfg = dict(SMALL, frontend=dict(SMALL["frontend"], hop_length=10))
    f = _counts.forward_flops_per_frame(cfg)
    r = _counts.forward_flops_per_row(cfg)
    assert _counts.embed_flops(cfg, [50, 900], buckets, 0.5) == (6 * f + r) + 4 * (41 * f + r)


def test_logmel_least_by_hand():
    cfg = toy._load(toy.PERFBENCH, "configs", "titanet_s.json")
    frames = 1 + 48000 // 160
    nnz = 503  # non-zeros of the 257 x 80 HTK filterbank
    per_frame = 2.5 * 512 * 9 + 400 + 3 * 257 + 2 * nnz + 80 + 240
    ops, nbytes = 128 * frames * per_frame, 4 * 128 * 48000 + 4 * 128 * frames * 80
    assert _counts.logmel_least_s(cfg, 128, 48000) == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))
    assert nbytes / 3.35e12 > ops / 67e12  # bytes bound it


def test_attn_pool_least_by_hand():
    cfg = toy._load(toy.PERFBENCH, "configs", "titanet_s.json")
    ops = 12 * 128 * 301 * 1536 * 128
    assert _counts.attn_pool_train_least_s(cfg, 128, 48000) == pytest.approx(
        max(ops / 989e12, 4 * 128 * 301 * 1536 / 3.35e12))


def _cell(config_name):
    cfg = toy._load(toy.PERFBENCH, "configs", f"{config_name}.json")
    return Cell("c", 1, cfg, toy._load(toy.PERFBENCH, "traffic", "train_b128.json"), {}, [], [])


TRAIN = {"kind": "train", "window_s": 1.0, "steps": 10, "rows_per_step": 128, "ranks": 1, "crop_samples": 48000}


@settings(max_examples=40, deadline=None)
@given(st.floats(min_value=1.0, max_value=1e4), st.integers(min_value=1, max_value=20))
def test_no_share_above_100(stretch, steps):
    """Any time at or above a kernel's least time reads at most 100%."""
    cell = _cell("titanet_s")
    counts = dict(TRAIN, steps=steps)
    logmel = _counts.logmel_least_s(cell.config, 128, 48000) * stretch
    pool = _counts.attn_pool_train_least_s(cell.config, 128, 48000) * stretch / 7
    ops = [("logmel_dmma_kernel", 10.0 * i, 10.0 * i + logmel) for i in range(steps)]
    ops += [(k, 10.0 * i + 1, 10.0 * i + 1 + pool) for i in range(steps) for k in
            ("pool_onepass_kernel", "pool_onepass_kernel", "tc_atb_kernel", "tc_de_kernel", "tc_dh_kernel",
             "sum_parts_kernel", "pool_merge_kernel")]
    trace = Trace(window_s=10.0 * steps, busy_s=1.0, ops=ops, spans=[], units=steps)
    for metric in ("logmel_roofline.train", "attn_pool_roofline.train"):
        assert 0 < bench.reader(cell, metric)(cell, counts, trace) <= 100.0 * (1 + 1e-9)
    flops = steps * _counts.train_step_flops(cell.config, 128, 48000, cell.traffic["corpus"]["speakers"])
    window = flops / 989e12 * stretch
    assert bench.reader(cell, "mfu.train")(cell, dict(counts, window_s=window), None) <= 100.0 * (1 + 1e-9)


def test_readers_return_nothing_without_their_data():
    cell = _cell("titanet_s")
    trace = Trace(window_s=1.0, busy_s=0.5, ops=[("other_kernel", 0.0, 0.5)], spans=[], units=3)
    for metric in ("logmel_roofline.train", "attn_pool_roofline.train", "nccl_ms_per_step.dp",
                   "logmel_roofline.embed", "idle_share.embed", "mfu.embed", "pad_efficiency.embed"):
        assert bench.reader(cell, metric)(cell, TRAIN, trace) is None
    assert bench.reader(cell, "idle_share.train")(cell, TRAIN, trace) == pytest.approx(50.0)


def test_pad_efficiency_counts():
    cell = _cell("titanet_l")
    counts = {"kind": "embed", "waveforms": [[50, 150, 150], [390]], "computed_samples": [2 * 100 + 2 * 200, 2 * 400]}
    real = 50 + 300 + 390
    computed = 100 * 2 + 200 * 2 + 400 * 2
    assert bench.reader(cell, "pad_efficiency.embed")(cell, counts, None) == pytest.approx(100 * real / computed)


def test_embed_readers_read_the_program_calls():
    """The embedder's launches, as the serving generator records them:
    pad_efficiency moves with the embedder's batching, the log-mel's share
    takes one launch a recorded batch."""
    from titanet_torch.train.extractor import SpeakerEmbedder

    from perfbench.core import program
    from perfbench.generators import embed as embed_gen

    cfg = dict(toy._load(toy.PERFBENCH, "configs", "titanet_l.json"), compute_dtype="float32", **toy.TOY_MODEL)
    cell = Cell("toy", 1, cfg, {}, {}, [], [])
    waves = [np.zeros(n, np.float32) for n in (9000, 4000, 4000, 20000)]
    got = {}
    for batch_size in (2, 4):
        serving = embed_gen.Serving.__new__(embed_gen.Serving)
        serving.pool, serving.calls, serving.computed = [waves], [], []
        serving.outputs, serving.latency_s = [], []
        model = program.titanet(cfg, draw_weights(ref_titanet.param_spec(cfg), 1, "cpu"), "cpu")
        serving.embedder = SpeakerEmbedder(model, program.frontend(cfg), buckets=[8000, 16000, 32000],
                                           batch_size=batch_size, device="cpu")
        with serving.counting():
            serving.request(0)
        assert serving.calls == [(batch_size, 8000), (batch_size, 16000), (batch_size, 32000)]
        counts = {"kind": "embed", "waveforms": [[len(w) for w in waves]], "computed_samples": serving.computed}
        got[batch_size] = bench.reader(cell, "pad_efficiency.embed")(cell, counts, None)
        assert got[batch_size] == pytest.approx(100 * 37000 / (batch_size * 56000))
    assert got[2] == pytest.approx(2 * got[4])
    calls = [(2, 8000), (2, 16000)]
    least = sum(_counts.logmel_least_s(cfg, r, n) for r, n in calls)
    trace = Trace(window_s=1.0, busy_s=0.5, ops=[("logmel_dmma_kernel", 0.0, least), ("logmel_dmma_kernel", 1.0, 1.0 + least)],
                  spans=[], units=1)
    counts = {"kind": "embed", "trace_calls": calls}
    assert bench.reader(cell, "logmel_roofline.embed")(cell, counts, trace) == pytest.approx(50.0)
    assert bench.reader(cell, "logmel_roofline.embed")(cell, dict(counts, trace_calls=calls[:1]), trace) is None


def test_nccl_reader_reads_every_rank_trace():
    cell = _cell("titanet_s")
    ranks = [Trace(window_s=1.0, busy_s=0.9, ops=[("ncclDevKernel_AllReduce", 0.0, 0.002 * (r + 1)),
                                                  ("other", 0.5, 0.6)], spans=[], units=2) for r in range(4)]
    counts = dict(TRAIN, ranks=4, trace_ranks=ranks)
    assert bench.reader(cell, "nccl_ms_per_step.dp")(cell, counts, ranks[0]) == pytest.approx(1e3 * 0.005 / 2)
    assert bench.reader(cell, "idle_share.train")(cell, counts, ranks[0]) == pytest.approx(10.0)
