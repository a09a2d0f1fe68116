"""The port's verification back ends (titanet_torch/train/{plda,trials,
enroll}.py) on the CPU: every function against the JAX package's on the
same seeded numpy inputs (equal arrays: both are the same numpy), the
expected values of tests/test_{plda,trials,enroll}.py on the port's
modules, and ``evaluate_trials`` through the port's ``SpeakerEmbedder``
against the JAX one on the same weights."""

import os
import wave

import numpy as np
import pytest

from tests.torch_port_helpers import small_titanet_pair
from titanet_torch.ops.frontend import FrontendConfig as TorchFrontend
from titanet_torch.train import enroll as te
from titanet_torch.train import plda as tp
from titanet_torch.train import trials as tt
from titanet_torch.train.calibration import LogisticCalibration as TorchCalibration
from titanet_torch.train.extractor import SpeakerEmbedder as TorchEmbedder
from titanet_torch.train.metrics import compute_eer, cross_cosine_scores, snorm_scores
from titanet_tpu.ops.frontend import FrontendConfig as JaxFrontend
from titanet_tpu.train import enroll as je
from titanet_tpu.train import plda as jp
from titanet_tpu.train import trials as jt
from titanet_tpu.train.calibration import LogisticCalibration as JaxCalibration
from titanet_tpu.train.extractor import SpeakerEmbedder as JaxEmbedder


def _sample(n_speakers, per, between_std, within_std, dim, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n_speakers, dim)) * between_std
    x = np.repeat(y, per, axis=0) + rng.standard_normal((n_speakers * per, dim)) * within_std
    return x, np.repeat(np.arange(n_speakers), per)


def _pair_scores_labels(scores, spk):
    labels = np.asarray(spk)[:, None] == np.asarray(spk)[None, :]
    iu = np.triu_indices(len(spk), k=1)
    return scores[iu], labels[iu].astype(int)


# -- PLDA ----------------------------------------------------------------


@pytest.mark.parametrize("rank", [None, 5])
def test_plda_equals_jax(rank):
    x, spk = _sample(8, 6, 1.0, 0.5, 16, seed=3)
    mine, ref = tp.PLDA.fit(x, spk, rank=rank), jp.PLDA.fit(x, spk, rank=rank)
    for name in ("mu", "v", "psi"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))
    np.testing.assert_array_equal(mine.score_pairs(x[:7], x[7:]), ref.score_pairs(x[:7], x[7:]))
    np.testing.assert_array_equal(mine.llr(x[:5], x[5:10]), ref.llr(x[:5], x[5:10]))
    np.testing.assert_array_equal(tp.length_norm(x), jp.length_norm(x))


def test_plda_length_norm_and_scoring_consistency():
    x = np.random.default_rng(0).standard_normal((5, 16)) * 3.0
    np.testing.assert_allclose(np.linalg.norm(tp.length_norm(x), axis=1), np.sqrt(16), rtol=1e-12)
    x, spk = _sample(6, 5, 1.0, 0.5, 12)
    plda = tp.PLDA.fit(x, spk, n_iter=5)
    s = plda.score_pairs(x)
    np.testing.assert_allclose(s, plda.score_pairs(x, x).T, rtol=1e-10)
    np.testing.assert_allclose(plda.llr(x[:3], x[3:6]), plda.score_pairs(x[:3], x[3:6]).diagonal(), rtol=1e-10)
    ps, labels = _pair_scores_labels(s, spk)
    assert ps[labels == 1].mean() > ps[labels == 0].mean()


def test_plda_generative_recovery_and_rank_truncation():
    x, spk = _sample(30, 10, 1.0, 0.3, 24, seed=1)
    plda = tp.PLDA.fit(x[:200], spk[:200])
    ps, labels = _pair_scores_labels(plda.score_pairs(x[200:]), spk[200:])
    assert compute_eer(ps, labels) < 0.05
    x, spk = _sample(6, 8, 1.0, 0.5, 20, seed=3)
    plda = tp.PLDA.fit(x, spk, rank=5)
    assert np.sum(plda.psi > 0) <= 5
    ps, labels = _pair_scores_labels(plda.score_pairs(x), spk)
    assert ps[labels == 1].mean() > ps[labels == 0].mean()


def test_plda_beats_cosine_under_nuisance_noise():
    rng = np.random.default_rng(2)
    n_spk, per, d_spk, d_noise = 24, 12, 6, 26
    y = rng.standard_normal((n_spk, d_spk))
    speaker_part = np.repeat(y, per, axis=0) + 0.25 * rng.standard_normal((n_spk * per, d_spk))
    x = np.concatenate([speaker_part, 2.0 * rng.standard_normal((n_spk * per, d_noise))], axis=1)
    spk = np.repeat(np.arange(n_spk), per)
    half = n_spk * per // 2
    plda = tp.PLDA.fit(x[:half], spk[:half])
    ps_p, labels = _pair_scores_labels(plda.score_pairs(x[half:]), spk[half:])
    xn = x[half:] / np.linalg.norm(x[half:], axis=1, keepdims=True)
    ps_c, _ = _pair_scores_labels(xn @ xn.T, spk[half:])
    eer_plda, eer_cos = compute_eer(ps_p, labels), compute_eer(ps_c, labels)
    assert eer_plda < eer_cos - 0.05 and eer_plda < 0.10, (eer_plda, eer_cos)


# -- trial lists -------------------------------------------------------------


def _write(path, text):
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(text)


def test_parse_trial_list_both_formats_equal_jax(tmp_path):
    vox, kaldi = tmp_path / "veri.txt", tmp_path / "trials"
    _write(vox, "# comment\n1 a/x.wav b/y.wav\n\n0 a/x.wav c/z.wav\n")
    _write(kaldi, "e1.wav t1.wav target\ne2.wav t2.wav nontarget\ne3.wav t3.wav IMP\n")
    labels, enrolls, tests = tt.parse_trial_list(str(vox))
    np.testing.assert_array_equal(labels, [1, 0])
    assert enrolls == ["a/x.wav", "a/x.wav"] and tests == ["b/y.wav", "c/z.wav"]
    labels, enrolls, tests = tt.parse_trial_list(str(kaldi))
    np.testing.assert_array_equal(labels, [1, 0, 0])
    assert enrolls[0] == "e1.wav" and tests[2] == "t3.wav"
    for p in (vox, kaldi):
        mine, ref = tt.parse_trial_list(str(p)), jt.parse_trial_list(str(p))
        np.testing.assert_array_equal(mine[0], ref[0])
        assert mine[1:] == ref[1:]


@pytest.mark.parametrize("bad", ["1 only-two-fields\n", "e.wav t.wav maybe\n", ""])
def test_parse_trial_list_rejects_malformed(tmp_path, bad):
    p = tmp_path / "bad.txt"
    _write(p, bad)
    with pytest.raises(ValueError):
        tt.parse_trial_list(str(p))


def _fake_embeddings(n=6, e=8, seed=0):
    embs = np.random.default_rng(seed).standard_normal((n, e))
    return {f"u{i}.wav": embs[i] for i in range(n)}


def test_trial_scores_cosine_and_snorm_expected_values():
    emb = _fake_embeddings()
    enrolls, tests = ["u0.wav", "u1.wav", "u0.wav"], ["u2.wav", "u3.wav", "u0.wav"]
    s = tt.trial_scores(emb, enrolls, tests)
    for i, (a, b) in enumerate(zip(enrolls, tests)):
        x, y = emb[a], emb[b]
        np.testing.assert_allclose(s[i], x @ y / (np.linalg.norm(x) * np.linalg.norm(y)), rtol=1e-12)
    np.testing.assert_allclose(s[2], 1.0, rtol=1e-12)
    emb = _fake_embeddings(n=5)
    cohort = np.random.default_rng(1).standard_normal((16, 8))
    names = list(emb)
    enrolls, tests = names[:3], [names[3], names[4], names[3]]
    stack = np.stack([emb[n] for n in names])
    full, coh = cross_cosine_scores(stack, stack), cross_cosine_scores(stack, cohort)
    idx = {n: i for i, n in enumerate(names)}
    for topk in (None, 7):
        got = tt.trial_scores(emb, enrolls, tests, cohort_embeddings=cohort, cohort_topk=topk)
        mat = snorm_scores(full, coh, coh, topk=topk)
        np.testing.assert_allclose(got, [mat[idx[a], idx[b]] for a, b in zip(enrolls, tests)], rtol=1e-10)


@pytest.mark.parametrize("backend,cohort,topk", [
    ("cosine", False, None), ("cosine", True, None), ("cosine", True, 5),
    ("plda", False, None), ("plda", True, None), ("plda", True, 5),
])
def test_trial_scores_equal_jax(backend, cohort, topk):
    rng = np.random.default_rng(4)
    means = rng.standard_normal((6, 12)) * 3.0
    embs = (means[:, None] + rng.standard_normal((6, 5, 12))).reshape(-1, 12)
    spk = np.repeat(np.arange(6), 5)
    emb = {f"u{i}.wav": embs[i] for i in range(len(embs))}
    names = list(emb)
    enrolls = [names[i] for i in rng.integers(0, len(names), 20)]
    tests = [names[i] for i in rng.integers(0, len(names), 20)]
    kw = dict(backend=backend, cohort_embeddings=rng.standard_normal((11, 12)) if cohort else None,
              cohort_topk=topk)
    mine = tt.trial_scores(emb, enrolls, tests, plda=tp.PLDA.fit(embs, spk) if backend == "plda" else None, **kw)
    ref = jt.trial_scores(emb, enrolls, tests, plda=jp.PLDA.fit(embs, spk) if backend == "plda" else None, **kw)
    np.testing.assert_array_equal(mine, ref)
    if backend == "plda" and not cohort:
        np.testing.assert_allclose(mine, tp.PLDA.fit(embs, spk).llr(
            np.stack([emb[p] for p in enrolls]), np.stack([emb[p] for p in tests])), rtol=1e-10)


def test_trial_scores_backend_validation_and_write_scores(tmp_path):
    emb = _fake_embeddings(n=2)
    with pytest.raises(ValueError):
        tt.trial_scores(emb, ["u0.wav"], ["u1.wav"], backend="euclid")
    with pytest.raises(ValueError):
        tt.trial_scores(emb, ["u0.wav"], ["u1.wav"], backend="plda")
    p = tmp_path / "s.txt"
    tt.write_scores(str(p), ["e.wav"], ["t.wav"], np.asarray([0.25]))
    assert open(p).read() == "e.wav t.wav 0.250000\n"


class _CountingEmbedder:
    def __init__(self):
        self.n_embedded = 0

    def embed(self, wavs):
        self.n_embedded += len(wavs)
        return np.stack([np.random.default_rng(len(w)).standard_normal(8) for w in wavs])


def _write_pcm(path, wav, sr=16000):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(wav, -1, 1) * 8000).astype(np.int16).tobytes())


def test_embed_trial_files_dedups_and_resolves_root(tmp_path):
    for i in range(3):
        _write_pcm(tmp_path / "spk" / f"u{i}.wav", np.random.default_rng(i).standard_normal(8000 + 100 * i) * 0.3)
    paths = ["spk/u0.wav", "spk/u1.wav", "spk/u0.wav", "spk/u2.wav", "spk/u1.wav"]
    emb = _CountingEmbedder()
    out = tt.embed_trial_files(paths, emb, audio_root=str(tmp_path))
    assert emb.n_embedded == 3 and set(out) == {"spk/u0.wav", "spk/u1.wav", "spk/u2.wav"}
    assert out["spk/u0.wav"].shape == (8,)


def _tone_trials(tmp_path):
    """Two 'speakers' (tones at 200 and 3000 Hz), 3 files each of 1.2-2.2 s
    (one at 8 kHz: resampled), and a VoxCeleb list of 7 trials."""
    rng = np.random.default_rng(3)
    for s, (spk, freq) in enumerate((("a", 200.0), ("b", 3000.0))):
        for i in range(3):
            sr = 8000 if (s, i) == (1, 2) else 16000
            t = np.arange(int(sr * (1.2 + 0.5 * i))) / sr
            _write_pcm(tmp_path / spk / f"u{i}.wav",
                       np.sin(2 * np.pi * freq * t + i) + 0.05 * rng.standard_normal(t.size), sr)
    lines = [f"1 {spk}/u0.wav {spk}/u{i}.wav" for spk in ("a", "b") for i in (1, 2)]
    lines += [f"0 a/u{i}.wav b/u{i}.wav" for i in range(3)]
    trial_file = tmp_path / "trials.txt"
    _write(trial_file, "\n".join(lines) + "\n")
    return str(trial_file)


def test_evaluate_trials_with_the_port_embedder_equals_jax(tmp_path):
    """End to end on real WAVs (one at 8 kHz) through the port's
    SpeakerEmbedder and the JAX one on the same small TitaNet: the cosine
    scores within 1e-5, the same EER, minDCF and counts; the scores file
    parses. (S-norm divides by the cohort scores' spread, which magnifies
    the embedders' rounding; test_trial_scores_equal_jax holds it on equal
    embeddings.)"""
    trial_file = _tone_trials(tmp_path)
    jmodel, variables, tmodel = small_titanet_pair(seed=2)
    kw = dict(buckets=[16000, 32000], batch_size=4)
    mine_emb = TorchEmbedder(tmodel, TorchFrontend.from_ms(), device="cpu", **kw)
    ref_emb = JaxEmbedder(jmodel, variables["params"], variables["batch_stats"], JaxFrontend.from_ms(), **kw)
    out = tmp_path / "scores.txt"
    mine = tt.evaluate_trials(trial_file, mine_emb, audio_root=str(tmp_path), scores_out=str(out))
    ref = jt.evaluate_trials(trial_file, ref_emb, audio_root=str(tmp_path), scores_out=str(tmp_path / "ref.txt"))
    assert (mine["n_trials"], mine["n_target"], mine["n_files"]) == (7, 4, 6)
    for key in ("eer", "n_trials", "n_target", "n_nontarget", "n_files"):
        assert mine[key] == ref[key], key
    np.testing.assert_allclose(mine["mindcf"], ref["mindcf"], atol=1e-6)
    rows = [line.split() for line in open(out).read().strip().splitlines()]
    ref_rows = [line.split() for line in open(tmp_path / "ref.txt").read().strip().splitlines()]
    assert len(rows) == 7 and [r[:2] for r in rows] == [r[:2] for r in ref_rows]
    np.testing.assert_allclose([float(r[2]) for r in rows], [float(r[2]) for r in ref_rows], atol=1e-5)
    det = tmp_path / "det.png"
    again = tt.evaluate_trials(trial_file, mine_emb, audio_root=str(tmp_path), det_out=str(det))
    assert again["eer"] == mine["eer"]
    assert det.read_bytes()[:4] == b"\x89PNG"


# -- enrollment --------------------------------------------------------------


def _clustered_embeddings(n_speakers=4, k=5, dim=32, spread=0.15, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_speakers, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return centers, {f"spk{i}": centers[i] + spread * rng.standard_normal((k, dim)) for i in range(n_speakers)}


def test_registry_enroll_verify_identify_expected_values():
    centers, per = _clustered_embeddings()
    reg = te.SpeakerRegistry(threshold=0.5)
    for name, emb in per.items():
        reg.enroll(name, emb)
    assert reg.speakers == sorted(per)
    ok, score = reg.verify("spk0", centers[0])
    assert ok and score > 0.9
    assert not reg.verify("spk0", centers[1])[0]
    assert [r[0][0] for r in reg.identify(centers)] == ["spk0", "spk1", "spk2", "spk3"]
    probe = np.linalg.svd(centers, full_matrices=True)[2][-1]
    assert reg.identify(probe)[0][0][0] is None
    a, b = te.SpeakerRegistry(), te.SpeakerRegistry()
    a.enroll("s", per["spk0"])
    for row in per["spk0"]:
        b.enroll("s", row)
    np.testing.assert_allclose(a.profile("s"), b.profile("s"), atol=1e-12)


@pytest.mark.parametrize("calibrated", [False, True])
def test_registry_equals_jax(calibrated):
    centers, per = _clustered_embeddings(seed=5)
    regs = []
    for mod, cal in ((te, TorchCalibration), (je, JaxCalibration)):
        reg = mod.SpeakerRegistry(threshold=0.0 if calibrated else 0.5,
                                  calibration=cal(8.0, -3.0) if calibrated else None)
        for name, emb in per.items():
            reg.enroll(name, emb)
        regs.append(reg)
    mine, ref = regs
    probes = centers + 0.3 * np.random.default_rng(6).standard_normal(centers.shape)
    for name in mine.speakers:
        np.testing.assert_array_equal(mine.profile(name), ref.profile(name))
        for p in probes:
            assert mine.verify(name, p) == ref.verify(name, p)
    assert mine.identify(probes, top_k=3) == ref.identify(probes, top_k=3)


def test_registry_json_reads_in_both_packages(tmp_path):
    _, per = _clustered_embeddings(seed=2)
    probe = per["spk1"][0]
    for src, dst, cal in ((te, je, TorchCalibration), (je, te, JaxCalibration)):
        reg = src.SpeakerRegistry(threshold=0.0, calibration=cal(8.0, -3.0))
        for name, emb in per.items():
            reg.enroll(name, emb)
        path = str(tmp_path / f"{src.__name__}.json")
        reg.save(path)
        loaded = dst.SpeakerRegistry.load(path)
        assert loaded.speakers == reg.speakers and loaded.threshold == 0.0
        assert (loaded.calibration.a, loaded.calibration.b) == (8.0, -3.0)
        assert loaded.verify("spk1", probe) == reg.verify("spk1", probe)
        assert te.SpeakerRegistry.load(path).identify(probe) == reg.identify(probe)


def test_registry_from_trials_and_errors():
    rng = np.random.default_rng(3)
    dev_scores = np.concatenate([rng.normal(0.8, 0.05, 500), rng.normal(0.1, 0.05, 500)])
    dev_labels = np.concatenate([np.ones(500), np.zeros(500)]).astype(int)
    _, per = _clustered_embeddings(spread=0.05, seed=4)
    reg = te.registry_from_trials(list(per.values()), list(per), dev_scores, dev_labels)
    ref = je.registry_from_trials(list(per.values()), list(per), dev_scores, dev_labels)
    assert reg.threshold == 0.0 and reg.calibration is not None
    assert (reg.calibration.a, reg.calibration.b) == (ref.calibration.a, ref.calibration.b)
    assert reg.verify("spk0", per["spk0"][0])[0] and not reg.verify("spk0", per["spk1"][0])[0]
    empty = te.SpeakerRegistry()
    with pytest.raises(ValueError):
        empty.identify(np.zeros(8))
    assert empty.remove("nobody") is False
    empty.enroll("a", np.ones(8))
    assert empty.remove("a") is True and empty.speakers == []
