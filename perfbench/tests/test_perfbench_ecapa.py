"""The ECAPA-TDNN cell (``ecapa_tdnn_1024.embed_vox_zoo``): its parts found
by name, its generator repeating per seed, its counts against a hand count
and torch's FLOP counter, its two readers, its reference against the
program at toy widths, and whole CPU runs with the two planted faults of
its pooling. On a card, ``-k card -s`` prints each seed's readings that the
cell's limits are set from: the program, the reference in fp8 at every
bf16 rounding point (the control) and the two faults planted in the
reference (``PERFBENCH_CONTROL_SEEDS`` seeds, 3 by default)."""

import gc
import io
import json
import math
import os
import shutil
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from perfbench import run as run_module
from perfbench.core import bench
from perfbench.core.bench import Cell
from perfbench.core.trace import Trace
from perfbench.core.weights import draw_weights, synth
from perfbench.generators import embed_zoo
from perfbench.metrics import _counts_ecapa
from perfbench.reference import ecapa as ref_ecapa
from perfbench.reference.lowp import fp8
from perfbench.tests import toy

CELL = "ecapa_tdnn_1024.embed_vox_zoo"
FULL = toy._load(toy.PERFBENCH, "configs", "ecapa_tdnn_1024.json")
SMALL = dict(FULL, channels=32, scale=4, mfa_channels=48, attention_hidden_size=8, embedding_size=16,
             se_bottleneck=8, frontend=dict(FULL["frontend"], n_mels=10))
TOY = dict(FULL, compute_dtype="float32", channels=64, mfa_channels=128, attention_hidden_size=128,
           embedding_size=32, se_bottleneck=16)
SEEDS = (2**31 + 5, 7)


def _reader(name):
    return bench.reader(None, name)


def test_cell_parts_found_by_name():
    cell = bench.load_cell(toy.CHECKOUT, CELL)
    assert bench.generator(cell) is embed_zoo and cell.chips == 1
    assert cell.traffic == dict(toy._load(toy.PERFBENCH, "traffic", "embed_vox.json"), generator="embed_zoo")
    assert set(cell.limits) == {"stated_gap_max", "stated_gap_median"}
    names = {m["name"] for m in cell.per_layer}
    assert {"mfu.embed_ecapa", "ctx_pool_roofline.embed_ecapa", "pad_efficiency.embed", "idle_share.embed",
            "logmel_roofline.embed", "overlap_share.embed", "pad_ms_per_batch.embed", "filler_share.embed",
            "idle_in_embedder_share.embed", "idle_in_step_share.embed"} == names
    assert {m["name"] for m in cell.end_to_end} == {"embed_audio_s_per_s", "setup_s"}
    assert cell.config["reduced"] == [] and cell.config["model"] == "ecapa_tdnn"
    params = sum(math.prod(s) for _, s, _, _ in ref_ecapa.param_spec(cell.config)) / 1e6
    assert abs(params / cell.config["paper"]["params_m"] - 1) < 0.01  # 14.65 M against 14.7 M


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_repeats_per_seed(seed):
    other = SEEDS[0] + SEEDS[1] - seed
    a, b, c = (embed_zoo.draw(SMALL, s, "cpu") for s in (seed, seed, other))
    for name, shape, init, fan_in in ref_ecapa.param_spec(SMALL):
        assert a[name].shape == shape and torch.equal(a[name], b[name])
        bound = SMALL["init_gain"].get(name, 1.0) / np.sqrt(fan_in) if init == "uniform" else 1.0
        assert float(a[name].abs().max()) <= bound + 1e-7
        if init == "uniform":
            assert not torch.equal(a[name], c[name])
    tr = toy._shrink("toy.vox", toy._load(toy.PERFBENCH, "traffic", "embed_vox_zoo.json"), 1)
    for w in (a, b):
        embed_zoo.calibrate(w, SMALL, tr, seed, "cpu")
    for name, _ in ref_ecapa.norm_sites(SMALL):
        assert torch.equal(a[f"{name}.running_var"], b[f"{name}.running_var"])


def test_flops_by_hand():
    # prolog 5*10*32; a block 2*32*32 + 3 groups x 3*8*8; MFA 3*32*48; attention 2*48*8
    assert _counts_ecapa.forward_flops_per_frame(SMALL) == 2 * (1600 + 3 * (2048 + 576) + 4608 + 768)
    # SE 3 x 2*32*8; the context's product 2*48*8; the head 96*16
    assert _counts_ecapa.forward_flops_per_row(SMALL) == 2 * (1536 + 768 + 1536)
    # C = 1024: 25.69 MFLOP a frame
    assert _counts_ecapa.forward_flops_per_frame(FULL) == 25_690_112


def test_flops_match_torch_counter():
    weights = draw_weights(ref_ecapa.param_spec(SMALL), 3, "cpu")
    for name, c in ref_ecapa.norm_sites(SMALL):
        weights[f"{name}.running_mean"], weights[f"{name}.running_var"] = torch.zeros(c), torch.ones(c)
    mel = torch.randn(3, 57, 10)
    with FlopCounterMode(display=False) as counter:
        ref_ecapa.Net(weights, SMALL)(mel)
    assert counter.get_total_flops() == 3 * (57 * _counts_ecapa.forward_flops_per_frame(SMALL)
                                             + _counts_ecapa.forward_flops_per_row(SMALL))


def _trace(ops):
    return Trace(window_s=1.0, busy_s=1.0, ops=ops, spans=[], units=1)


def test_ctx_pool_roofline_reader():
    read = _reader("ctx_pool_roofline.embed_ecapa")
    cell = Cell(CELL, 1, FULL, {}, {}, [], [])
    calls = [(64, 615093), (64, 16000)]
    lengths = [[615093] * 10 + [1] * 54, [16000, 9000, 1] + [1] * 61]
    least = sum(_counts_ecapa.ctx_pool_least_s(FULL, lens, n) for (_, n), lens in zip(calls, lengths))
    counts = {"kind": "embed", "trace_calls": calls, "trace_lengths": lengths}
    names = ("void ctx_stats_kernel(...)", "void ctx_finish_kernel(...)",
             "void pool_onepass_kernel<false, true>(...)", "void pool_merge_kernel(...)")
    for scale in (1.0, 1.7, 40.0):
        ops, t = [], 0.0
        for _ in calls:
            for n in names:  # each batch's least time spread over its four launches
                ops.append((n, t, t + scale * least / 8))
                t += scale * least / 8
        ops.append(("void other_kernel(...)", t, t + 5.0))
        share = read(cell, counts, _trace(ops))
        assert share == pytest.approx(100.0 / scale) and share <= 100.0 + 1e-9
    # a program that pools in plain torch, or without the lengths, reads nothing
    assert read(cell, counts, _trace([("void other_kernel(...)", 0.0, 1.0)])) is None
    assert read(cell, counts, _trace(ops[:4])) is None  # the launches of one batch of two
    assert read(cell, {k: v for k, v in counts.items() if k != "trace_lengths"}, _trace(ops)) is None
    assert read(cell, counts, None) is None
    # counted over the valid frames only: a row of one frame is one frame
    assert _counts_ecapa.valid_frames(FULL, [1, 160, 10 ** 9], 16000) == 1 + 2 + 101


def test_mfu_reader():
    read = _reader("mfu.embed_ecapa")
    counts = {"kind": "embed", "window_s": 2.0, "waveforms": [[48000, 20000]], "buckets": [16000, 32000],
              "window_overlap": 0.5}
    want = 100.0 * _counts_ecapa.embed_flops(FULL, [48000, 20000], [16000, 32000], 0.5) / (2.0 * 989e12)
    assert read(Cell(CELL, 1, FULL, {}, {}, [], []), counts, None) == pytest.approx(want)
    assert read(Cell(CELL, 1, dict(FULL, model="titanet"), {}, {}, [], []), counts, None) is None
    assert read(Cell(CELL, 1, FULL, {}, {}, [], []), {"kind": "train"}, None) is None


def test_reference_matches_program():
    w = embed_zoo.draw(TOY, 11, "cpu")
    gen = torch.Generator().manual_seed(11)
    for name, c in ref_ecapa.norm_sites(TOY):
        w[f"{name}.running_mean"] = 0.1 * torch.randn(c, generator=gen)
        w[f"{name}.running_var"] = 0.5 + torch.rand(c, generator=gen)
    model = embed_zoo.build_model(TOY, w, "cpu")
    mel = torch.randn(3, 60, 80)
    mask = torch.ones(3, 60)
    mask[1, 40:] = 0
    mask[2, 21:] = 0
    with torch.no_grad():
        got = model(mel, mask=mask)
        ref = ref_ecapa.Net(w, TOY)(mel, mask)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def _no_context(self, x, mask, dt):
    """The plain route with the context term left out of the attention."""
    from titanet_torch.models import ecapa

    ch = x.shape[-1]
    w1 = self.in_linear.weight.to(dt)
    e = torch.tanh(F.linear(x.to(dt), w1[:, :ch]) + self.in_linear.bias.to(dt))
    return ecapa.attentive_stats(x, self.out_linear(e), mask=mask, eps=self.eps)


def _padded_context(self, x, mask, dt):
    """The plain route with the context's mean and std over every frame,
    the padded ones too."""
    from titanet_torch.models import ecapa

    ch = x.shape[-1]
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    std = torch.sqrt(torch.clamp(xf.var(dim=1, unbiased=False, keepdim=True), min=self.eps))
    w1 = self.in_linear.weight.to(dt)
    bias = F.linear(mean.to(dt), w1[:, ch:2 * ch]) + F.linear(std.to(dt), w1[:, 2 * ch:]) + self.in_linear.bias.to(dt)
    e = torch.tanh(F.linear(x.to(dt), w1[:, :ch]) + bias)
    return ecapa.attentive_stats(x, self.out_linear(e), mask=mask, eps=self.eps)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark root of one toy cell of the ECAPA cell's generator,
    readers and limits, on a small ECAPA-TDNN in float32."""
    tmp = str(tmp_path_factory.mktemp("bench_ecapa"))
    with open(os.path.join(toy.CHECKOUT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    toy._dump(TOY, tmp, "perfbench", "configs", "toy_ecapa.json")
    toy._dump(toy._shrink("toy.vox", toy._load(toy.PERFBENCH, "traffic", "embed_vox_zoo.json"), 1),
              tmp, "perfbench", "traffic", "toy_ecapa.json")
    os.makedirs(os.path.join(tmp, "perfbench", "limits"))
    shutil.copy(os.path.join(toy.PERFBENCH, "limits", f"{CELL}.json"),
                os.path.join(tmp, "perfbench", "limits", "toy.ecapa.json"))

    def only(metrics):
        return [dict(m, workloads=["toy.ecapa"]) for m in metrics if CELL in m.get("workloads", ())] + [
            m for m in metrics if "workloads" not in m]

    toy._dump(dict(spec, configs=[{"name": "toy_ecapa", "source": "toy", "file": "perfbench/configs/toy_ecapa.json",
                                   "reduced": [], "why": "toy"}],
                   workloads=[{"name": "toy.ecapa", "config": "toy_ecapa", "traffic": "toy_ecapa", "chips": 1,
                               "why": "toy"}],
                   end_to_end=only(spec["end_to_end"]), per_layer=only(spec["per_layer"])), tmp, "BENCHMARK.json")
    return tmp


def _run(root, trace=0):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_module.main(["--workload", "toy.ecapa", "--seed", str(2**31 + 11), "--seconds", "0.5",
                              "--trace", str(trace), "--device", "cpu", "--root", root])
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct(root):
    line = _run(root, trace=1)
    assert line["correct"] and line["failed"] == 0
    assert {"mfu.embed_ecapa", "pad_efficiency.embed", "filler_share.embed"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", [_no_context, _padded_context], ids=["no_context", "padded_context"])
def test_pooling_faults_are_caught(root, fault, monkeypatch):
    from titanet_torch.models import ecapa

    monkeypatch.setattr(ecapa.ChannelContextAttentivePooling, "_plain_route", fault)
    assert not _run(root)["correct"]


def _gaps(got, ref):
    d = np.linalg.norm(got - ref, axis=-1)
    return {"stated_gap_max": float(d.max()), "stated_gap_median": float(np.median(d))}


def card_readings(cell, seed, device):
    """``{"program": ..., "control_fp8": ..., "no_context": ...,
    "padded_context": ...}``: every request of the pool once through the
    program's embedder, the seed's sample of answers against the stated
    reference, and each planted reference against it."""
    from titanet_torch.train.capture import GRAPHS

    serving = embed_zoo.ZooServing(cell, seed, device)
    serving.warm()
    for k in range(len(serving.pool)):
        serving.request(k)
    picks = serving.sample(cell.traffic["check"]["answers"])
    answers = serving.outputs
    del serving.model, serving.embedder
    gc.collect()
    GRAPHS._collect_dead()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    refs = serving.references(picks)
    out = {"program": serving.numbers(picks, answers, refs)}
    planted = {"control_fp8": dict(rnd=fp8, act=fp8), "no_context": dict(fault="no_context"),
               "padded_context": dict(fault="padded_context")}
    for name, kw in planted.items():
        out[name] = _gaps(serving.references(picks, ("stated",), **kw)["stated"], refs["stated"])
    return out


@pytest.mark.cuda
def test_card_control_and_faults_over_limits_program_under():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench.load_cell(toy.CHECKOUT, CELL)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from titanet_torch.utils import enable_compilation_cache

    enable_compilation_cache(os.path.join(bench.PERFBENCH, ".cache", "kernels"))
    seen = []
    for i in range(int(os.environ.get("PERFBENCH_CONTROL_SEEDS", "3"))):
        seed = 3_000_000_000 + 7919 * i
        readings = card_readings(cell, seed, device)
        print(json.dumps({"cell": CELL, "seed": seed, **readings}), flush=True)
        seen.append(readings)
    for readings in seen:
        assert all(readings["program"][k] <= v for k, v in cell.limits.items())
        for name in ("control_fp8", "no_context", "padded_context"):
            assert any(readings[name][k] > v for k, v in cell.limits.items()), name
