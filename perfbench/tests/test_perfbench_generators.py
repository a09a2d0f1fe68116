"""The generators repeat for a seed, differ across seeds, and give every
seed the same amount of work."""

import numpy as np
import pytest
import torch

from perfbench.core.bench import derive
from perfbench.core.weights import draw_weights, synth
from perfbench.generators import embed, train
from perfbench.reference import titanet as ref_titanet
from perfbench.tests import toy

SEEDS = (2**31 + 5, 7)


def test_derive_streams_repeat_and_differ():
    assert derive(SEEDS[0], "a") == derive(SEEDS[0], "a")
    assert len({derive(s, k) for s in SEEDS for k in ("a", "b")}) == 4
    assert all(0 <= derive(s, "a") < 2**63 for s in (0, 2**31 + 5, 2**40))


def test_weights_repeat_per_seed():
    cfg = dict(toy._load(toy.PERFBENCH, "configs", "titanet_l.json"), **toy.TOY_MODEL)
    spec = ref_titanet.param_spec(cfg)
    a, b, c = (draw_weights(spec, s, "cpu") for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    for name, shape, init, fan_in in spec:
        assert a[name].shape == shape and torch.equal(a[name], b[name])
        if init == "uniform":
            assert not torch.equal(a[name], c[name])
            assert float(a[name].abs().max()) <= 1.0 / np.sqrt(fan_in)


def test_synth_repeats_and_rows_differ():
    lengths, spk = np.array([4000, 3000, 5000]), np.array([0, 1, 0])
    a, b, c = (synth(lengths, spk, 4, s, "cpu") for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert a.shape == (12000,) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0 and float(a[:4000].std()) > 0.01
    assert not torch.allclose(a[:3000], a[4000:7000], atol=1e-2)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_crops_fixed_sizes(seed):
    t = toy._shrink("toy.train", toy._load(toy.PERFBENCH, "traffic", "train_b128.json"), 1)
    l1, s1 = train.corpus_plan(t["corpus"], seed)
    l2, s2 = train.corpus_plan(t["corpus"], seed)
    l3, _ = train.corpus_plan(t["corpus"], SEEDS[0] + SEEDS[1] - seed)
    assert np.array_equal(l1, l2) and np.array_equal(s1, s2)
    assert not np.array_equal(l1, l3) and np.array_equal(np.sort(l1), np.sort(l3))
    assert np.bincount(s1).min() == np.bincount(s1).max() or np.ptp(np.bincount(s1)) <= 1


def test_production_corpus_fits_the_device_corpus():
    t = toy._load(toy.PERFBENCH, "traffic", "train_b128.json")
    lengths, speakers = train.corpus_plan(t["corpus"], SEEDS[0])
    assert lengths.sum() + train.TAIL_PAD < 2**31
    assert abs(lengths.mean() / t["corpus"]["sample_rate"] - t["corpus"]["mean_s"]) < 0.05
    assert len(set(speakers.tolist())) == t["corpus"]["speakers"]


@pytest.mark.parametrize("traffic", ["embed_vox", "diarize_callhome"])
def test_requests_fixed_sizes(traffic):
    t = toy._load(toy.PERFBENCH, "traffic", f"{traffic}.json")
    a, b, c = (embed.request_plan(t, s, 16000) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    # the same requests, in another order: the seed does not change the work
    assert sorted(map(lambda x: tuple(np.sort(x)), a)) == sorted(map(lambda x: tuple(np.sort(x)), c))
    secs = np.concatenate(a) / 16000
    assert secs.min() >= t["request"]["min_s"] - 1e-3 and secs.max() <= t["request"]["max_s"] + 1e-3
    if t["request"]["kind"] == "utterances":
        assert abs(secs.mean() - t["request"]["mean_s"]) < 0.01


def test_pool_repeats_per_seed():
    t = toy._shrink("toy.vox", toy._load(toy.PERFBENCH, "traffic", "embed_vox.json"), 1)
    (a, sa), (b, sb), (c, _) = (embed.make_pool(t, s, "cpu", 16000) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert sa == sb and all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not all(len(x) == len(y) and np.array_equal(x, y) for p, q in zip(a, c) for x, y in zip(p, q))


def test_diarizer_windows_match_the_diarizer():
    n, win, hop = 16000 * 7 + 123, 24000, 12000
    w = embed.diarizer_windows(n, win, hop)
    assert w[0] == (0, win) and w[-1] == (n - win, win) and all(length == win for _, length in w)
    assert [s for s, _ in w[:-1]] == list(range(0, n - win + 1, hop))
