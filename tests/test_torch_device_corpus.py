"""The port's device-resident corpus (titanet_torch/data/device_corpus.py and
the loader's device mode) vs the JAX package's on the CPU: the same flat
int16 corpus and tables, the same descriptor batches (starts, lengths,
bucket, speakers) at epochs 0 and 3 with chunking and for whole-utterance
eval loaders, the same static shards, windows bit-equal to JAX's gather
and to the port's own int16 host batches; the refusals, the cache and the
2^31-sample limit; one f32 train step fed from descriptors vs JAX's; and
``cli.train`` on the cut ``configs/bench22_easy_eer.yml`` with
``device_corpus: true``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from titanet_torch import cli
from titanet_torch.config import Config
from titanet_torch.data import device_corpus as tdc
from titanet_torch.data import loader as tld
from titanet_torch.data.dataset import Subset as TSubset
from titanet_torch.data.dataset import SyntheticSpeakerDataset as TSynth
from titanet_torch.train import checkpoint as ckpt
from titanet_tpu.data import device_corpus as jdc
from titanet_tpu.data import loader as jld
from titanet_tpu.data.dataset import Subset as JSubset
from titanet_tpu.data.dataset import SyntheticSpeakerDataset as JSynth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = dict(n_speakers=6, utterances_per_speaker=5, seed=7, min_seconds=1.0, max_seconds=3.4)
CHUNK = dict(enabled=True, max_length=2.0, lengths=(1.0, 1.5, 2.0))


def _corpora(root_indices=None):
    """(port dataset, JAX dataset, port corpus on the CPU, JAX corpus)."""
    tds, jds = TSynth(**CORPUS), JSynth(**CORPUS)
    tc = tdc.DeviceCorpus.build(tds, 16000, device="cpu", root_indices=root_indices)
    jc = jdc.DeviceCorpus.build(jds, 16000, root_indices=root_indices)
    return tds, jds, tc, jc


def _assert_same_corpus(tc, jc):
    np.testing.assert_array_equal(tc.offsets, jc.offsets)
    np.testing.assert_array_equal(tc.lengths, jc.lengths)
    np.testing.assert_array_equal(tc.speaker_ids, jc.speaker_ids)
    assert tc.flat.dtype == torch.int16 and tc.n_owned == jc.n_owned
    np.testing.assert_array_equal(tc.flat.numpy(), np.asarray(jc.flat))


def _assert_same_descriptors(tb, jb):
    assert isinstance(tb, tdc.DeviceBatch) and isinstance(jb, jdc.DeviceBatch)
    assert tb.t == jb.t
    for f in ("starts", "lengths", "speaker_ids"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
    wav, lengths, speakers = tb.gather()
    jwav, jlengths, jspeakers = jb.gather()
    assert wav.dtype == torch.int16 and wav.shape == (len(tb), tb.t)
    np.testing.assert_array_equal(wav.numpy(), np.asarray(jwav))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
    np.testing.assert_array_equal(speakers.numpy(), np.asarray(jspeakers))
    return wav


@pytest.mark.parametrize("case", ["train-epoch0", "train-epoch3", "eval-whole"])
def test_descriptor_batches_match_jax_and_the_host_route(case):
    """Corpus, descriptors and gathered windows equal JAX's; the windows
    equal the port's int16 host batches bit for bit and its f32 batches
    within one int16 step."""
    tds, jds, tc, jc = _corpora()
    _assert_same_corpus(tc, jc)
    if case == "eval-whole":
        split = tds.get_splits(val=True, val_utterances_per_speaker=1, test=True, test_speakers=2,
                               test_utterances_per_speaker=3)[2]
        tsrc, jsrc = TSubset(tds, split), JSubset(jds, split)
        kw, epoch = dict(batch_size=4, shuffle=False, drop_last=False), 0
        tchunk, jchunk = tld.ChunkConfig(enabled=False), jld.ChunkConfig(enabled=False)
    else:
        tsrc, jsrc = tds, jds
        kw, epoch = dict(batch_size=4, shuffle=True, seed=11), int(case[-1])
        tchunk, jchunk = tld.ChunkConfig(**CHUNK), jld.ChunkConfig(**CHUNK)
    port = tld.DataLoader(tsrc, chunk=tchunk, prefetch=0, **kw)
    port.attach_device_corpus(tc)
    ref = jld.DataLoader(jsrc, chunk=jchunk, prefetch=0, **kw)
    ref.attach_device_corpus(jc)
    host16 = tld.DataLoader(tsrc, chunk=tchunk, prefetch=0, transport_dtype="int16", **kw)
    host32 = tld.DataLoader(tsrc, chunk=tchunk, prefetch=0, **kw)
    for loader in (port, ref, host16, host32):
        loader.set_epoch(epoch)
    batches = list(zip(port, ref, host16, host32))
    assert len(batches) == len(port) == len(host16) > 0
    for tb, jb, h16, h32 in batches:
        wav = _assert_same_descriptors(tb, jb)
        np.testing.assert_array_equal(wav.numpy(), h16.waveform)
        np.testing.assert_array_equal(tb.lengths, h16.lengths)
        np.testing.assert_array_equal(tb.speaker_ids, h16.speaker_ids)
        np.testing.assert_allclose(wav.numpy() / 32768.0, h32.waveform, rtol=0, atol=1.0 / 32768.0)


@pytest.mark.parametrize("shard_id", [0, 1])
def test_static_shards_match_jax(shard_id):
    """``num_shards = 2``: each shard's corpus holds its own utterances
    only, and its epoch (``_iter_device_static_shard``) equals JAX's."""
    kw = dict(batch_size=4, shuffle=True, seed=5, shard_id=shard_id, num_shards=2, prefetch=0)
    tds, jds = TSynth(**CORPUS), JSynth(**CORPUS)
    port = tld.DataLoader(tds, chunk=tld.ChunkConfig(**CHUNK), **kw)
    ref = jld.DataLoader(jds, chunk=jld.ChunkConfig(**CHUNK), **kw)
    owned = port.device_shard_root_indices()
    np.testing.assert_array_equal(owned, ref.device_shard_root_indices())
    _, _, tc, jc = _corpora(root_indices=owned)
    _assert_same_corpus(tc, jc)
    assert tc.n_owned == len(owned) < len(tds)
    port.attach_device_corpus(tc)
    ref.attach_device_corpus(jc)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        pairs = list(zip(port, ref))
        assert len(pairs) == len(port) == len(ref) == (len(tds) // 2) // 4
        for tb, jb in pairs:
            _assert_same_descriptors(tb, jb)
    other = tld.DataLoader(tds, batch_size=4, shard_id=1 - shard_id, num_shards=2)
    with pytest.raises(ValueError, match="missing"):
        other.attach_device_corpus(tc)


def test_refusals_cache_and_the_size_limit():
    tds = TSynth(**CORPUS)
    corpus = tdc.DeviceCorpus.build(tds, 16000, device="cpu", cache_key=tdc.corpus_cache_key(tds))
    for kw in (dict(speed=tld.SpeedConfig(enabled=True)),
               dict(reverb=tld.ReverbConfig(rir_paths=("x.wav",), enabled=True)),
               dict(noise=tld.NoiseMixConfig(paths=("x.wav",), enabled=True))):
        with pytest.raises(ValueError, match="host-side"):
            tld.DataLoader(tds, batch_size=4, **kw).attach_device_corpus(corpus)
    # the cache: the key is JAX's; an identical synthetic corpus is reused
    assert tdc.corpus_cache_key(tds) == jdc.corpus_cache_key(JSynth(**CORPUS))
    assert tdc.corpus_cache_key(tds)[0] == "synthetic"
    again = TSynth(**CORPUS)
    assert tdc.DeviceCorpus.build(again, 16000, device="cpu", cache_key=tdc.corpus_cache_key(again)) is corpus
    assert tdc.corpus_cache_key(object())[0] == "id"
    # the 2^31-sample limit, on a stubbed length table
    lengths = np.array([2**30, 2**30 - 400_000, 5], np.int64)
    with pytest.raises(ValueError, match="too large for device residency"):
        tdc.corpus_layout(lengths, np.arange(3), 400_000)
    offsets, size = tdc.corpus_layout(lengths, np.array([0, 2]), 400_000)
    assert offsets.tolist() == [0, -1, 2**30] and size == 2**30 + 5 + 400_000
    # gather_global: this rank's rows at the width the ranks agree on (a
    # mesh of one rank: its own width, or the one passed), as gather() gives
    from titanet_torch.parallel import make_mesh

    desc = tdc.DeviceBatch(corpus, np.array([0, 9000], np.int64), np.array([8000, 5], np.int32),
                           np.array([1, 2], np.int32), 8000)
    mesh = make_mesh(device="cpu")
    for got, want in zip(desc.gather_global(mesh), desc.gather()):
        assert torch.equal(got, want)
    wide, lengths, speakers = desc.gather_global(mesh, t=9000)
    assert torch.equal(wide[:, :8000], desc.gather()[0]) and not wide[:, 8000:].any()
    assert lengths.tolist() == [8000, 5] and speakers.tolist() == [1, 2]


def test_descriptor_fed_f32_train_step_matches_jax():
    """Descriptors -> the loop's staging -> one f32 train step, from the
    same weights as JAX's step on JAX's gathered windows: the loss within
    the f32 step tolerance of tests/test_torch_train.py; and the port's
    host-fed int16 step gives the same loss."""
    from titanet_torch.losses import heads as th
    from titanet_torch.models.titanet import TitaNet as TorchTitaNet
    from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
    from titanet_torch.train import state as ts
    from titanet_torch.train.loop import _staged_batches
    from titanet_torch.utils.weights import load_jax_train_state
    from titanet_tpu.losses import heads as jh
    from titanet_tpu.models.titanet import TitaNet as JaxTitaNet
    from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
    from titanet_tpu.train import state as js

    small = dict(n_mega_blocks=1, encoder_hidden_size=64, encoder_output_size=64, dropout=0.0)
    tds, jds, tc, jc = _corpora()
    kw = dict(batch_size=4, shuffle=True, seed=3, prefetch=0)
    port = tld.DataLoader(tds, chunk=tld.ChunkConfig(enabled=True, max_length=1.0, lengths=(1.0,)), **kw)
    port.attach_device_corpus(tc)
    ref = jld.DataLoader(jds, chunk=jld.ChunkConfig(enabled=True, max_length=1.0, lengths=(1.0,)), **kw)
    ref.attach_device_corpus(jc)
    host = tld.DataLoader(tds, chunk=tld.ChunkConfig(enabled=True, max_length=1.0, lengths=(1.0,)),
                          transport_dtype="int16", **kw)

    jm, jhd = JaxTitaNet(**small), jh.build_head("ce", 192, 6)
    jopt = js.make_optimizer(name="sgd", start_lr=3e-4)
    jst = js.create_train_state(jax.random.key(0), jm, jhd, jopt, jnp.zeros((2, 101, 80)), 6)
    tree = jax.tree_util.tree_map(np.asarray, (jst.params, jst.batch_stats))

    def port_state():
        tm, thd = TorchTitaNet(**small), th.build_head("ce", 192, 6, device="cpu")
        load_jax_train_state(tm, thd, *tree)
        return ts.create_train_state(tm, thd, ts.make_optimizer(name="sgd", start_lr=3e-4))

    (wav, lengths, speakers), batch = next(_staged_batches(port, torch.device("cpu")))
    assert isinstance(batch, tdc.DeviceBatch) and wav.dtype == torch.int16 and wav.shape == (4, 16000)
    _, tmet = ts.train_step(port_state(), wav, lengths, speakers, frontend=TorchFrontend.from_ms())
    jwav, jlengths, jspeakers = next(iter(ref)).gather()
    np.testing.assert_array_equal(wav.numpy(), np.asarray(jwav))
    _, jmet = js.train_step(jst, jwav, jlengths, jspeakers, model=jm, head=jhd, optimizer=jopt,
                            frontend=JaxFrontend.from_ms())
    loss = tmet["loss"].item()
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(jmet["loss"]), rtol=1e-4)
    hb = next(iter(host))
    _, hmet = ts.train_step(port_state(), hb.waveform, hb.lengths, hb.speaker_ids, frontend=TorchFrontend.from_ms())
    assert hmet["loss"].item() == loss


def test_cli_trains_the_device_corpus_config_on_the_cpu(tmp_path, monkeypatch):
    """``configs/bench22_easy_eer.yml`` cut to 4 speakers x 6 utterances,
    one mega-block and one epoch keeps ``device_corpus: true``, the
    chunking and SpecAugment; ``cli.train`` builds one corpus for the
    train, validation and test loaders, every batch of the epoch is
    gathered from it, and the run ends with a finite loss and a
    checkpoint."""
    import yaml

    raw = yaml.safe_load(open(os.path.join(REPO, "configs", "bench22_easy_eer.yml")))
    assert raw["generic"]["device_corpus"] is True
    assert raw["augmentation"]["enable"] == ["chunk", "specaugment"]
    raw["dataset"].update(synthetic_speakers=4, synthetic_utterances=6)
    raw["training"].update(batch_size=4, epochs=1, checkpoints_path=str(tmp_path / "ck"), run_name="dc")
    raw["titanet"].update(n_mega_blocks=1)
    raw["validation"].update(every=1, batch_size=4, num_utterances_per_speaker=1)
    raw["test"].update(num_speakers=2, num_utterances_per_speaker=2)
    raw["generic"].update(compilation_cache_dir="", workers=0)
    cfg = Config.from_dict(raw)
    builds, gathers = [], []
    build, gather = tdc.DeviceCorpus.build.__func__, tdc.gather_windows
    monkeypatch.setattr(tdc.DeviceCorpus, "build",
                        classmethod(lambda cls, *a, **k: builds.append(1) or build(cls, *a, **k)))
    monkeypatch.setattr(tdc, "gather_windows", lambda *a, **k: gathers.append(a[3]) or gather(*a, **k))
    tdc._CORPUS_CACHE.clear()
    state = cli.train(cfg, device="cpu")
    assert state.step >= 1 and len(builds) == 1
    assert len(gathers) >= state.step  # train steps + validation and test batches
    run = tmp_path / "ck" / "dc"
    assert ckpt.latest_epoch(str(run)) == 1
    import json

    rows = [json.loads(line) for line in open(run / "metrics.jsonl")]
    train = [r for r in rows if "train/avg_loss" in r]
    assert train and np.isfinite(train[0]["train/avg_loss"])
    assert any("test/eer" in r for r in rows)
