"""The port's diarization module (titanet_torch/train/diarize.py) on the
CPU: every public function against the JAX package's on the same inputs
(identical labels, segments, DER and RTTM text), and the expected values
of tests/test_diarize.py with its stub embedders on the port's module."""

import numpy as np
import pytest

from titanet_torch.train import diarize as td
from titanet_tpu.train import diarize as jd


def _gaussian_clusters(k, per, dim=16, sep=6.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)) * sep
    emb = np.concatenate([centers[i] + rng.standard_normal((per, dim)) for i in range(k)])
    return emb, np.repeat(np.arange(k), per)


def _cluster_accuracy(pred, true):
    from scipy.optimize import linear_sum_assignment

    k = max(pred.max(), true.max()) + 1
    m = np.zeros((k, k))
    for p, t in zip(pred, true):
        m[p, t] += 1
    ri, cj = linear_sum_assignment(-m)
    return m[ri, cj].sum() / len(pred)


class _ToneEmbedder:
    """Spectral band energies: windows dominated by different tones
    separate perfectly (tests/test_diarize.py's stand-in)."""

    def embed(self, windows):
        out = []
        for w in windows:
            e = np.array([b.sum() for b in np.array_split(np.abs(np.fft.rfft(w)), 8)])
            out.append(e / max(np.linalg.norm(e), 1e-12))
        return np.stack(out)


def _tones(sr, *freqs, seconds=2):
    t = np.arange(sr * seconds) / sr
    return np.concatenate([np.sin(2 * np.pi * f * t) for f in freqs]).astype(np.float32)


def _segs(segs):
    return [(s.start, s.end, s.speaker) for s in segs]


def _overlapped(sr):
    t = np.arange(sr * 2) / sr
    wav = np.zeros(int(3.5 * sr), np.float32)
    wav[: 2 * sr] += np.sin(2 * np.pi * 200 * t).astype(np.float32)
    wav[int(1.5 * sr): int(3.5 * sr)] += np.sin(2 * np.pi * 1500 * t).astype(np.float32)
    return wav, [(0.0, 2.0, 0), (1.5, 3.5, 1)]


# -- the port against the JAX module ---------------------------------------------


@pytest.mark.parametrize("k,known", [(2, True), (3, True), (5, True), (2, False), (3, False), (4, False)])
def test_clustering_equals_jax(k, known):
    emb, _ = _gaussian_clusters(k, 12, seed=k)
    a = td.cosine_affinity(emb)
    np.testing.assert_array_equal(a, jd.cosine_affinity(emb))
    np.testing.assert_array_equal(td.refine_affinity(a, 90.0), jd.refine_affinity(a, 90.0))
    kt, bt = td.nme_estimate(a, max_speakers=8)
    kj, bj = jd.nme_estimate(a, max_speakers=8)
    assert kt == kj
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(td._kmeans(emb, k, seed=3), jd._kmeans(emb, k, seed=3))
    n = k if known else None
    np.testing.assert_array_equal(td.spectral_cluster(emb, n_speakers=n, seed=1),
                                  jd.spectral_cluster(emb, n_speakers=n, seed=1))
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    for th in (0.3, 0.8):
        labels = td.ahc_cluster(unit, th, max_speakers=6)
        np.testing.assert_array_equal(labels, jd.ahc_cluster(unit, th, max_speakers=6))
        for margin in (0.1, 0.5):
            np.testing.assert_array_equal(td.overlap_assign(unit, labels, 0.2, margin),
                                          jd.overlap_assign(unit, labels, 0.2, margin))


def test_windows_vad_der_and_rttm_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 3, 12)
    t0 = list(np.arange(12) * 0.75)
    t1 = [s + 1.5 for s in t0]
    assert _segs(td.merge_windows(labels, t0, t1)) == _segs(jd.merge_windows(labels, t0, t1))
    sec = np.where(rng.random(12) < 0.4, rng.integers(0, 3, 12), -1)
    assert _segs(td._secondary_segments(sec, labels, t0, t1)) == _segs(jd._secondary_segments(sec, labels, t0, t1))
    sr = 8000
    wav = np.concatenate([_tones(sr, 300, seconds=1), np.zeros(sr, np.float32), _tones(sr, 700, seconds=1),
                          0.001 * rng.standard_normal(sr // 2).astype(np.float32)])
    for kw in ({}, {"threshold_db": -20.0, "hangover_s": 0.05}):
        assert td.energy_vad(wav, sr, **kw) == jd.energy_vad(wav, sr, **kw)
    ref = [(0.0, 2.0, 0), (1.5, 3.5, 1), (3.0, 6.0, 2)]
    hyp = [(0.0, 2.2, 5), (2.2, 4.0, 3), (3.9, 6.1, 5), (1.0, 1.5, 3)]
    assert td.diarization_error_rate(ref, hyp) == jd.diarization_error_rate(ref, hyp)
    segs = [td.Segment(*s) for s in hyp]
    td.write_rttm(segs, str(tmp_path / "t.rttm"), uri="conv")
    jd.write_rttm([jd.Segment(*s) for s in hyp], str(tmp_path / "j.rttm"), uri="conv")
    assert (tmp_path / "t.rttm").read_text() == (tmp_path / "j.rttm").read_text()
    mine, theirs = td.read_rttm(str(tmp_path / "j.rttm")), jd.read_rttm(str(tmp_path / "t.rttm"))
    assert {u: _segs(v) for u, v in mine.items()} == {u: _segs(v) for u, v in theirs.items()}


@pytest.mark.parametrize("kw", [
    dict(n_speakers=2), dict(max_speakers=4), dict(n_speakers=2, vad=True),
    dict(clustering="ahc", ahc_threshold=0.6), dict(n_speakers=2, overlap_threshold=0.5, overlap_margin=0.4),
])
def test_diarize_equals_jax(kw):
    sr = 8000
    wav = np.concatenate([_tones(sr, 200, 1500), np.zeros(sr, np.float32), _tones(sr, 200)])
    if "overlap_threshold" in kw:
        wav = _overlapped(sr)[0]
    args = (wav, sr, _ToneEmbedder())
    assert _segs(td.diarize(*args, window_s=1.0, hop_s=0.5, **kw)) == \
        _segs(jd.diarize(*args, window_s=1.0, hop_s=0.5, **kw))


def test_online_diarizer_and_calibration_equal_jax():
    sr = 8000
    wav = _tones(sr, 200, 1500, 200)
    online = []
    for mod in (td, jd):
        dia = mod.OnlineDiarizer(_ToneEmbedder(), sr, window_s=1.0, hop_s=0.5, threshold=0.8, max_speakers=4)
        for piece in np.array_split(wav, 7):
            dia.feed(piece)
        online.append(_segs(dia.finish()))
    assert online[0] == online[1]
    dev = [(wav, [(0, 2, 0), (2, 4, 1), (4, 6, 0)]),
           (_tones(sr, 1500, 600, 1500), [(0, 2, 0), (2, 4, 1), (4, 6, 0)])]
    kw = dict(thresholds=(0.2, 0.5, 0.8, 0.99), window_s=1.0, hop_s=0.5)
    assert td.calibrate_ahc_threshold(dev, _ToneEmbedder(), sr, **kw) == \
        jd.calibrate_ahc_threshold(dev, _ToneEmbedder(), sr, **kw)
    dev = [_overlapped(sr)]
    kw = dict(thresholds=(0.4, 0.5, 0.6), margins=(0.1, 0.4), window_s=1.0, hop_s=0.5, n_speakers=2)
    assert td.calibrate_overlap_threshold(dev, _ToneEmbedder(), sr, **kw) == \
        jd.calibrate_overlap_threshold(dev, _ToneEmbedder(), sr, **kw)


# -- the expected values of tests/test_diarize.py on the port ---------------------


@pytest.mark.parametrize("k", [2, 3, 5])
def test_spectral_cluster_known_k(k):
    emb, true = _gaussian_clusters(k, 20)
    assert _cluster_accuracy(td.spectral_cluster(emb, n_speakers=k), true) == 1.0


@pytest.mark.parametrize("k", [2, 3, 4])
def test_eigengap_estimates_speaker_count(k):
    emb, true = _gaussian_clusters(k, 20, seed=k)
    pred = td.spectral_cluster(emb, n_speakers=None, max_speakers=8)
    assert len(np.unique(pred)) == k and _cluster_accuracy(pred, true) == 1.0


def test_single_cluster_merge_windows_and_der():
    emb, _ = _gaussian_clusters(1, 10)
    assert set(td.spectral_cluster(emb, n_speakers=1)) == {0}
    assert td.spectral_cluster(emb[:1]).tolist() == [0]
    segs = td.merge_windows([0, 0, 1, 1, 0], [0.0, 0.75, 1.5, 2.25, 3.0], [1.5, 2.25, 3.0, 3.75, 4.5])
    assert [s.speaker for s in segs] == [0, 1, 0] and segs[0].start == 0.0 and segs[-1].end == 4.5
    assert all(abs(a.end - b.start) < 1e-9 for a, b in zip(segs, segs[1:]))
    ref = [(0.0, 2.0, 0), (2.0, 4.0, 1)]
    assert td.diarization_error_rate(ref, ref) == 0.0
    assert td.diarization_error_rate(ref, [(0.0, 2.0, 7), (2.0, 4.0, 3)]) == 0.0
    assert abs(td.diarization_error_rate(ref, [(0.0, 2.0, 0), (2.0, 3.0, 0), (3.0, 4.0, 1)]) - 0.25) < 0.01
    assert abs(td.diarization_error_rate(ref, [(0.0, 2.0, 0)]) - 0.5) < 0.01
    ref = [(0.0, 2.0, 0), (1.0, 3.0, 1)]
    assert td.diarization_error_rate(ref, ref) == 0.0
    assert abs(td.diarization_error_rate(ref, [(0.0, 2.0, 0), (2.0, 3.0, 1)]) - 0.25) < 0.01
    assert abs(td.diarization_error_rate(ref, [(0.0, 3.0, 0), (0.0, 3.0, 1)]) - 0.5) < 0.01


def test_diarize_tones_nmesc_ahc_and_vad():
    sr = 8000
    wav = _tones(sr, 200, 1500, 200)
    ref = [(0, 2, 0), (2, 4, 1), (4, 6, 0)]
    segs = td.diarize(wav, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, n_speakers=2)
    assert len(segs) == 3 and segs[0].speaker == segs[2].speaker != segs[1].speaker
    assert abs(segs[0].end - 2.0) <= 0.5 and abs(segs[1].end - 4.0) <= 0.5 and abs(segs[-1].end - 6.0) < 1e-6
    assert td.diarization_error_rate(ref, segs) < 0.15
    auto = td.diarize(wav, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, max_speakers=4)
    assert len({s.speaker for s in auto}) in (2, 3) and td.diarization_error_rate(ref, auto) < 0.25
    ahc = td.diarize(wav, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, clustering="ahc", ahc_threshold=0.6)
    assert td.diarization_error_rate(ref, ahc) < 0.25
    gap = np.concatenate([_tones(sr, 200), np.zeros(sr * 2, np.float32), _tones(sr, 1500)])
    segs = td.diarize(gap, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, n_speakers=2, vad=True)
    assert all(s.end <= 2.05 or s.start >= 3.95 for s in segs)
    spk_a = {s.speaker for s in segs if s.end <= 2.05}
    spk_b = {s.speaker for s in segs if s.start >= 3.95}
    assert spk_a and spk_b and spk_a.isdisjoint(spk_b)


def test_energy_vad_regions():
    sr = 8000
    tone = np.sin(2 * np.pi * 300 * np.arange(sr) / sr)
    regions = td.energy_vad(np.concatenate([tone, np.zeros(sr), tone]).astype(np.float32), sr)
    assert len(regions) == 2
    (a0, a1), (b0, b1) = regions
    assert abs(a0) < 0.1 and abs(a1 - 1.0) < 0.1 and abs(b0 - 2.0) < 0.1 and abs(b1 - 3.0) < 0.1
    assert len(td.energy_vad(np.concatenate([tone, np.zeros(sr // 10), tone]).astype(np.float32), sr)) == 1
    assert isinstance(td.energy_vad(np.zeros(100, np.float32), sr), list)


def test_online_diarizer_stable_ids_and_speaker_cap():
    sr = 8000
    wav = _tones(sr, 200, 1500, 200)
    dia = td.OnlineDiarizer(_ToneEmbedder(), sr, window_s=1.0, hop_s=0.5, threshold=0.8, max_speakers=4)
    for piece in np.array_split(wav, 7):
        dia.feed(piece)
    segs = dia.finish()
    assert td.diarization_error_rate([(0, 2, 0), (2, 4, 1), (4, 6, 0)], segs) < 0.30
    labels = [s.speaker for s in segs]
    assert labels[0] == labels[-1]
    dia2 = td.OnlineDiarizer(_ToneEmbedder(), sr, window_s=1.0, hop_s=0.5, threshold=0.8, max_speakers=4)
    dia2.feed(wav)
    assert [s.speaker for s in dia2.finish()] == labels

    class _RandomEmbedder:
        rng = np.random.default_rng(0)

        def embed(self, windows):
            return self.rng.standard_normal((len(windows), 16))

    dia = td.OnlineDiarizer(_RandomEmbedder(), 8000, window_s=0.5, hop_s=0.25, threshold=0.99, max_speakers=3)
    dia.feed(np.zeros(8000 * 5, np.float32))
    assert len({s.speaker for s in dia.segments}) <= 3


def test_ahc_structure_threshold_and_cap():
    rng = np.random.default_rng(2)
    emb = np.concatenate([np.eye(3, 16)[i] + 0.05 * rng.standard_normal((15, 16)) for i in range(3)])
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    pred = td.ahc_cluster(emb, threshold=0.5, max_speakers=8)
    assert len(np.unique(pred)) == 3 and _cluster_accuracy(pred, np.repeat(np.arange(3), 15)) == 1.0
    emb, _ = _gaussian_clusters(3, 10, seed=4)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert len(np.unique(td.ahc_cluster(emb, threshold=1.01, max_speakers=30))) == 30
    assert len(np.unique(td.ahc_cluster(emb, threshold=-1.0, max_speakers=8))) == 1
    emb, _ = _gaussian_clusters(6, 5, seed=5)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    assert len(np.unique(td.ahc_cluster(emb, threshold=1.01, max_speakers=4))) == 4


def test_overlap_emission_and_calibration():
    e0, e1 = np.eye(8)[0], np.eye(8)[1]
    mid = (e0 + e1) / np.linalg.norm(e0 + e1)
    emb = np.stack([e0] * 5 + [e1] * 5 + [mid, mid])
    labels = np.array([0] * 5 + [1] * 5 + [0, 1])
    sec = td.overlap_assign(emb, labels, overlap_threshold=0.6, overlap_margin=0.3)
    assert (sec[:10] == -1).all() and sec[10] == 1 and sec[11] == 0
    assert (td.overlap_assign(emb, labels, overlap_threshold=0.95, overlap_margin=0.3) == -1).all()
    assert (td.overlap_assign(emb[:5], np.zeros(5, np.int64), 0.1, 1.0) == -1).all()
    t0, t1 = [0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0]
    (seg,) = td._secondary_segments(np.array([-1, 1, -1, -1]), [0, 0, 1, 1], t0, t1)
    assert (seg.start, seg.end, seg.speaker) == (1.5, 2.0, 1)
    (seg,) = td._secondary_segments(np.array([-1, -1, 0, -1]), [0, 0, 1, 1], t0, t1)
    assert (seg.start, seg.end, seg.speaker) == (2.0, 2.5, 0)
    segs = td._secondary_segments(np.array([-1, 1, 1, -1]), [0, 0, 0, 1], t0, t1)
    assert len(segs) == 1 and segs[0].speaker == 1
    sr = 8000
    wav, ref = _overlapped(sr)
    best, sweep = td.calibrate_overlap_threshold([(wav, ref)], _ToneEmbedder(), sr, thresholds=(0.4, 0.5, 0.6),
                                                 margins=(0.1, 0.4), window_s=1.0, hop_s=0.5, n_speakers=2)
    assert best is not None and sweep[best] < sweep[None]
    blind = td.diarize(wav, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, n_speakers=2)
    aware = td.diarize(wav, sr, _ToneEmbedder(), window_s=1.0, hop_s=0.5, n_speakers=2,
                       overlap_threshold=best[0], overlap_margin=best[1])
    assert td.diarization_error_rate(ref, aware) < td.diarization_error_rate(ref, blind)
    assert len(aware) >= len(blind)
    best, sweep = td.calibrate_ahc_threshold(
        [(_tones(sr, 200, 1500, 200), [(0, 2, 0), (2, 4, 1), (4, 6, 0)]),
         (_tones(sr, 1500, 600, 1500), [(0, 2, 0), (2, 4, 1), (4, 6, 0)])],
        _ToneEmbedder(), sr, thresholds=(0.2, 0.5, 0.8, 0.99), window_s=1.0, hop_s=0.5)
    assert set(sweep) == {0.2, 0.5, 0.8, 0.99} and sweep[best] == min(sweep.values()) and sweep[best] < 0.3


def test_rttm_round_trip(tmp_path):
    path = str(tmp_path / "out.rttm")
    a = [td.Segment(0.0, 2.5, 0), td.Segment(2.0, 4.0, 1)]
    b = [td.Segment(0.5, 1.5, 3)]
    td.write_rttm(a, path, uri="conv_a")
    td.write_rttm(b, path, uri="conv_b")
    back = td.read_rttm(path)
    assert set(back) == {"conv_a", "conv_b"}
    for orig, got in ((a, back["conv_a"]), (b, back["conv_b"])):
        assert len(got) == len(orig)
        for s0, s1 in zip(orig, got):
            assert abs(s0.start - s1.start) < 1e-3 and abs(s0.end - s1.end) < 1e-3 and s0.speaker == s1.speaker
    with open(path, "w") as f:
        f.write("SPEAKER m 1 0.000 1.000 <NA> <NA> alice <NA> <NA>\n")
        f.write("SPEAKER m 1 1.000 1.000 <NA> <NA> bob <NA> <NA>\n")
        f.write("SPEAKER m 1 2.000 1.000 <NA> <NA> alice <NA> <NA>\n")
    assert [s.speaker for s in td.read_rttm(path)["m"]] == [0, 1, 0]
