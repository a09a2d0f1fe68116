"""The embedder's batch staging (``titanet_torch/train/extractor.py``: two
reused slots, batch k + 1 launched before batch k is read back, each batch
at the smallest row class that holds it) against the serial path it
replaced, a fresh zeros batch a step: on the CPU at toy widths, and on the
card at the mixed lengths of ``test_torch_cuda.py``'s embedder tests and
at TitaNet-L's widths.

Imports neither JAX nor the JAX package, so the card's cases also run
where only the port is installed:

    python -m pytest tests/test_torch_staging.py --noconftest -q

Without a CUDA device those cases skip.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from titanet_torch.models.titanet import TitaNet
from titanet_torch.ops.frontend import FrontendConfig
from titanet_torch.train import extractor
from titanet_torch.train import state as ts
from titanet_torch.train.extractor import SpeakerEmbedder
from titanet_torch.utils import profiling

FE = FrontendConfig.from_ms()
BUCKETS = [4000, 8000]
BATCH = 2


def _class_rows(n, batch_size):
    """The rows a batch of ``n`` real rows is handed to the step with: the
    smallest of ``batch_size``, ``batch_size / 2``, ... (none under 8 rows)
    that holds them."""
    rows = batch_size
    while rows // 2 >= max(n, 8):
        rows //= 2
    return rows


class SerialEmbedder(SpeakerEmbedder):
    """The same plan, each batch padded into a fresh zeros array of its
    row class and embedded and read back before the next is padded."""

    fixed_rows = False  # pad every batch to batch_size rows instead (FixedEmbedder)

    def _embed_batches(self, batches):
        out = []
        for bucket, group in batches:
            rows = self.batch_size if self.fixed_rows else _class_rows(len(group), self.batch_size)
            batch = np.zeros((rows, bucket), np.float32)
            lengths = np.ones(rows, np.int32)
            for j, w in enumerate(group):
                batch[j, : len(w)] = w
                lengths[j] = len(w)
            emb = ts.embed_step(self.model, batch, lengths, frontend=self.frontend, masked=True,
                                device=self.device, capture=self.capture)
            out.append(emb.float().cpu().numpy()[: len(group)])
        return out


class FixedEmbedder(SerialEmbedder):
    """The serial path at ``batch_size`` rows a batch, the JAX package's
    extractor's shapes."""

    fixed_rows = True


def _waves(lengths, seed):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return TitaNet(n_mega_blocks=1, encoder_hidden_size=32, encoder_output_size=48, embedding_size=16,
                   attention_hidden_size=8, dropout=0.0)


def _checked_steps(monkeypatch, fail_at=None):
    """Holds every batch handed to ``extractor.embed_step`` to a fresh
    zeros pad of its rows (zeros past each length, filler rows zeros of
    length 1); the call numbered ``fail_at`` raises instead."""
    real, calls = extractor.embed_step, []

    def step(model, wav, lengths, **kwargs):
        calls.append(wav.shape)
        w, n = wav.numpy().copy(), lengths.numpy().copy()
        fresh = np.zeros_like(w)
        for j, m in enumerate(n):
            fresh[j, :m] = w[j, :m]
        np.testing.assert_array_equal(w, fresh)
        if len(calls) == fail_at:
            raise RuntimeError("step failed")
        return real(model, wav, lengths, **kwargs)

    monkeypatch.setattr(extractor, "embed_step", step)
    return calls


# requests, each a list of waveform lengths, at buckets 4000 and 8000, batch 2
CASES = {
    # both slots filled with long rows, then the same rows shorter: their tails must go
    "shorter_rows_after_longer": [[7000, 7500, 7200, 7900], [5000, 5100, 4500, 6000]],
    # slot 0 at 4000, then 8000 in the same request, then 4000 again in the next
    "bucket_change_on_a_slot": [[7000, 3000, 7500, 3500, 2000], [3900, 1000, 3990]],
    "partial_batches": [[3000], [7000, 7100, 7200], [100, 3999, 5]],
    # windows of 8000 every 4000 past the largest bucket
    "windows_past_the_largest_bucket": [[17000, 3000], [9000], [25000, 8000]],
    # the request's second batch raises; the next request finds the slots clean
    "a_step_raises_mid_request": [[7000, 7500, 7200, 7900, 6000], [5000, 5100, 4500]],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_answers_equal_fresh_zeros_batches(model, monkeypatch, case):
    staged = SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
    serial = SerialEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
    requests = [_waves(lengths, seed) for seed, lengths in enumerate(CASES[case])]
    if case == "a_step_raises_mid_request":
        calls = _checked_steps(monkeypatch, fail_at=2)
        with pytest.raises(RuntimeError, match="step failed"):
            staged.embed(requests[0])
        assert len(calls) == 2
        requests = requests[1:]
        fresh = SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
        np.testing.assert_array_equal(staged.embed(requests[0]), fresh.embed(requests[0]))
    calls = _checked_steps(monkeypatch)
    for request in requests:
        np.testing.assert_array_equal(staged.embed(request), serial.embed(request))
    assert calls  # the staged embedder's batches, checked as handed over


# (batch_size, real rows of one bucket): one under, at and over each row class
ROW_CASES = [(bs, n) for bs in (16, 32) for n in sorted({1, 7, 8, 9, 17, bs - 1, bs, bs + 1})]


def _rows_request(n, seed):
    """``n`` waveforms of the 8000 bucket and 3 of the 4000 one."""
    rng = np.random.default_rng(seed)
    return _waves(list(rng.integers(4001, 8001, n)) + [3000, 3500, 2000], seed)


@pytest.mark.parametrize("batch_size,n", ROW_CASES)
def test_partial_batches_run_at_their_row_class(model, monkeypatch, batch_size, n):
    """Each batch reaches the step as ``[class, bucket]``, the class the
    smallest of ``batch_size``, ``batch_size / 2``, ... (down to 8) that
    holds its rows; the answers equal a serial embedder's that pads to the
    same class, bit for bit, and one's that pads to ``batch_size``, within
    1e-5. Between two such requests a full batch of shorter rows, whose
    tails the next fill must zero at another row count; after them a full
    batch of the other bucket on the slot that last held 8 of its rows,
    past which the old width's rows must have been zeroed."""
    kw = dict(buckets=BUCKETS, batch_size=batch_size, device="cpu")
    staged, serial, fixed = SpeakerEmbedder(model, FE, **kw), SerialEmbedder(model, FE, **kw), FixedEmbedder(
        model, FE, **kw)
    requests = [_rows_request(n, seed=n), _waves([4100 + 13 * i for i in range(batch_size)], seed=1),
                _rows_request(n, seed=n + 1), _waves([2500 + 17 * i for i in range(batch_size)], seed=2)]
    calls = _checked_steps(monkeypatch)
    got = [staged.embed(r) for r in requests]
    want = []
    for long_rows, short_rows in ((n, 3), (batch_size, 0), (n, 3), (0, batch_size)):
        want += [(_class_rows(short_rows, batch_size), 4000)] if short_rows else []
        want += [(_class_rows(min(batch_size, long_rows - i), batch_size), 8000)
                 for i in range(0, long_rows, batch_size)]
    assert [tuple(c) for c in calls] == want
    for request, answer in zip(requests, got):
        np.testing.assert_array_equal(answer, serial.embed(request))
        np.testing.assert_allclose(answer, fixed.embed(request), rtol=0, atol=1e-5)


def test_warmup_hands_the_step_every_bucket_and_row_class_largest_first(model, monkeypatch):
    calls = _checked_steps(monkeypatch)
    SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=32, device="cpu").warmup()
    assert [tuple(c) for c in calls] == [(rows, bucket) for bucket in (8000, 4000) for rows in (32, 16, 8)]


def test_pad_spans_count_the_rows_handed_to_the_step(model, monkeypatch, tmp_path):
    """``embed.pad``'s rows and computed samples are those of the batch the
    step received (``filler_share.embed`` reads them)."""
    embedder = SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=16, device="cpu")
    calls = _checked_steps(monkeypatch)
    with profiling.trace(str(tmp_path)):
        embedder.embed(_rows_request(19, seed=3))
    (root,) = [s["root"] for s in profiling.spans() if s["name"] == "embed.request"][-1:]
    pads = [s["counts"] for s in profiling.spans() if s["root"] == root and s["name"] == "embed.pad"]
    assert [tuple(c) for c in calls] == [(8, 4000), (16, 8000), (8, 8000)]
    assert [(p["rows"], p["real_rows"], p["computed_samples"]) for p in pads] == [
        (8, 3, 8 * 4000), (16, 16, 16 * 8000), (8, 3, 8 * 8000)]


def test_concurrent_calls_on_one_embedder_keep_their_answers(model):
    """More threads than cores call one embedder at once, with the
    interpreter switching threads every microsecond: each call's answers
    equal the serial ones (one call at a time fills the slots)."""
    staged = SpeakerEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
    serial = SerialEmbedder(model, FE, buckets=BUCKETS, batch_size=BATCH, device="cpu")
    requests = [_waves(lengths, seed) for seed, lengths in enumerate(CASES["bucket_change_on_a_slot"]
                                                                     + CASES["shorter_rows_after_longer"])]
    want = [serial.embed(r) for r in requests]
    got, errors = [], []

    def work(i):
        try:
            for k in range(len(requests)):
                j = (i + k) % len(requests)
                got.append((j, staged.embed(requests[j])))
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range((os.cpu_count() or 1) + 4)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == len(threads) * len(requests)
    for j, answer in got:
        np.testing.assert_array_equal(answer, want[j])


# the card: test_torch_cuda.py's mixed lengths (0.3, 1.2, 7, 40 s and 0.7, 1.6, 2.5 s), enough of them
# that buckets hold several batches of 4 and the 40 s one is cut into windows
CARD_SECONDS = [[0.3, 1.2, 7.0, 40.0, 0.7, 1.6, 2.5, 1.2, 0.3, 7.0, 2.5, 1.6], [2.5, 0.7, 40.0, 1.2, 0.3],
                [7.0, 7.0, 1.6, 0.3, 0.7, 2.5, 1.2]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned staging and the step graphs)")
    return torch.device("cuda")


def _card_embedders(device, seed):
    from titanet_torch.models import get_titanet

    model = get_titanet(n_mega_blocks=2, dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(seed)).eval()
    fe = FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    return (SpeakerEmbedder(model, fe, batch_size=4, device=device),
            SerialEmbedder(model, fe, batch_size=4, device=device))


def _card_requests(seed=11):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32) for s in secs] for secs in CARD_SECONDS]


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [True, False])
def test_staged_embedder_equals_serial_fresh_batches_on_the_card(cuda_device, warm):
    """Bit for bit, request after request; without ``warmup()`` each
    bucket's graph is captured mid-request while a batch is in flight."""
    staged, serial = _card_embedders(cuda_device, seed=int(warm))
    if warm:
        staged.warmup()
    for request in _card_requests():
        np.testing.assert_array_equal(staged.embed(request), serial.embed(request))
    assert staged._slots[0].wav.is_pinned() and staged._slots[0].out.is_pinned()


@pytest.mark.cuda
def test_staged_uploads_are_pinned_and_the_batch_loop_never_syncs(cuda_device, tmp_path):
    """Every ``embed.upload`` of a request counts pinned host memory, and
    under ``set_sync_debug_mode("error")`` the request runs: no blocking
    copy, ``.cpu()`` or ``.item()``; the one wait a batch is its readback
    event's."""
    staged, serial = _card_embedders(cuda_device, seed=2)
    staged.warmup()
    request = _card_requests(seed=5)[0]
    with profiling.trace(str(tmp_path)):
        staged.embed(request)
    (root,) = [s["root"] for s in profiling.spans() if s["name"] == "embed.request"][-1:]
    uploads = [s["counts"] for s in profiling.spans() if s["root"] == root and s["name"] == "embed.upload"]
    pads = [s["counts"] for s in profiling.spans() if s["root"] == root and s["name"] == "embed.pad"]
    assert len(uploads) == len(pads) > 2 and all(u["pinned"] for u in uploads)
    assert [p["in_flight"] for p in pads] == [0] + [1] * (len(pads) - 1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = staged.embed(request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(got, serial.embed(request))


@pytest.mark.cuda
def test_row_classes_on_the_card_at_titanet_l_widths(cuda_device):
    """bf16 at C = 1024, k = 11, batch 64: after ``warmup()``, which
    captures every (bucket, row class) shape, a request captures nothing,
    and each row embedded at its class (a bucket's tail of 6 rows at 8, a
    group of 21 at 32) agrees with the same row in a 64-row batch (cosine
    > 0.9999)."""
    from titanet_torch.models import get_titanet
    from titanet_torch.train.capture import GRAPHS

    model = get_titanet(model_size="l", n_mega_blocks=2, dtype=torch.bfloat16, device=cuda_device,
                        generator=torch.Generator().manual_seed(3)).eval()
    fe = FrontendConfig.from_ms(precision="default", use_pallas_fused=True)
    kw = dict(buckets=[24000, 48000], batch_size=64, device=cuda_device)
    staged, fixed = SpeakerEmbedder(model, fe, **kw), FixedEmbedder(model, fe, **kw)
    rng = np.random.default_rng(7)
    lengths = list(rng.integers(24001, 48001, 70)) + list(rng.integers(8000, 24001, 21))
    request = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]
    before = GRAPHS.captures
    staged.warmup()
    assert GRAPHS.captures - before == 2 * 4  # two buckets, rows 64, 32, 16 and 8
    before = GRAPHS.captures
    got = staged.embed(request)
    assert GRAPHS.captures == before
    cosines = (got * fixed.embed(request)).sum(-1)  # unit rows
    assert got.shape == (91, 192) and np.isfinite(got).all() and cosines.min() > 0.9999, cosines.min()
