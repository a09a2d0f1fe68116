"""The port's scoring (titanet_torch/train/metrics.py, calibration.py) and
event files (titanet_torch/utils/tb_events.py) vs the JAX package's on the
same inputs: numpy in both packages, so every result agrees to 1e-12."""

import numpy as np
import pytest

from titanet_torch.train import calibration as tcal
from titanet_torch.train import metrics as tm
from titanet_torch.utils import tb_events as ttb
from titanet_tpu.train import calibration as jcal
from titanet_tpu.train import metrics as jm
from titanet_tpu.utils import tb_events as jtb

TOL = 1e-12


def _trials(seed, n=60, e=16, speakers=6):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((speakers, e))
    spk = rng.integers(0, speakers, n)
    emb = centers[spk] + rng.standard_normal((n, e)) * (0.6 + 0.3 * seed)
    cohort = rng.standard_normal((25, e))
    return emb.astype(np.float32), spk, cohort.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("norm", ["none", "snorm", "asnorm"])
def test_verification_scores_eer_and_mindcf_equal_jax(seed, norm):
    emb, spk, cohort = _trials(seed)
    kw = {} if norm == "none" else dict(cohort_embeddings=cohort, cohort_topk=10 if norm == "asnorm" else None)
    s_ref, l_ref = jm.all_pairs_scores_labels(emb, spk, **kw)
    s_got, l_got = tm.all_pairs_scores_labels(emb, spk, **kw)
    np.testing.assert_array_equal(l_got, l_ref)
    np.testing.assert_allclose(s_got, s_ref, rtol=0, atol=TOL)
    for p_target in (0.01, 0.05):
        ref = jm.get_test_metrics(s_ref, l_ref, mindcf_p_target=p_target, prefix="test")
        got = tm.get_test_metrics(s_got, l_got, mindcf_p_target=p_target, prefix="test")
        assert got.keys() == ref.keys()
        for k in ref:
            assert abs(got[k] - ref[k]) <= TOL, k
    for a, b in zip(tm.det_curve(s_got, l_got), jm.det_curve(s_ref, l_ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(tm.roc_curve(s_got, l_got), jm.roc_curve(s_ref, l_ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_allclose(tm.cross_cosine_scores(emb, cohort), jm.cross_cosine_scores(emb, cohort),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_calibration_equals_jax(seed):
    emb, spk, cohort = _trials(seed, n=40)
    scores, labels = tm.all_pairs_scores_labels(emb, spk)
    dev_s, dev_l = tm.all_pairs_scores_labels(cohort[:20] + emb[:20], spk[:20])
    ref_cal = jcal.LogisticCalibration.fit(dev_s, dev_l)
    got_cal = tcal.LogisticCalibration.fit(dev_s, dev_l)
    assert abs(got_cal.a - ref_cal.a) <= TOL and abs(got_cal.b - ref_cal.b) <= TOL
    llr = got_cal(scores)
    np.testing.assert_allclose(llr, ref_cal(scores), rtol=0, atol=TOL)
    assert abs(tcal.cllr(llr, labels) - jcal.cllr(llr, labels)) <= TOL
    assert abs(tcal.min_cllr(scores, labels) - jcal.min_cllr(scores, labels)) <= TOL
    for p in (0.01, 0.1):
        assert abs(tcal.actual_dcf(llr, labels, p_target=p) - jcal.actual_dcf(llr, labels, p_target=p)) <= TOL
    np.testing.assert_allclose(tcal.pav_llrs(scores, labels), jcal.pav_llrs(scores, labels), rtol=0, atol=TOL)


def test_classification_metrics_equal_jax():
    rng = np.random.default_rng(4)
    y_true, y_pred = rng.integers(0, 7, 300), rng.integers(0, 7, 300)
    y_pred[:150] = y_true[:150]
    assert tm.get_train_val_metrics(y_true, y_pred, "train") == jm.get_train_val_metrics(y_true, y_pred, "train")
    n = 9
    tp = np.bincount(y_true[y_pred == y_true], minlength=n)
    pc, tc_ = np.bincount(y_pred, minlength=n), np.bincount(y_true, minlength=n)
    correct = int((y_pred == y_true).sum())
    assert (tm.metrics_from_class_counts(tp, pc, tc_, correct, 300, prefix="val")
            == jm.metrics_from_class_counts(tp, pc, tc_, correct, 300, prefix="val"))


def test_tb_event_files_are_byte_compatible_with_jax(tmp_path):
    """The port's writer and reader against the JAX package's: CRC32C, the
    records and the decoded scalars, both ways."""
    for data in (b"", b"123456789", bytes(range(256))):
        assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb.crc32c(b"123456789") == 0xE3069283
    w = ttb.EventFileWriter(str(tmp_path / "port"))
    w.add_scalars({"train/avg_loss": 1.25, "train/accuracy": np.float32(0.5), "skip": np.ones(3)}, step=3)
    w.add_scalar("val/avg_loss", -2.0, step=4)
    w.close()
    events = jtb.read_events(w.path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert events[1]["step"] == 3 and events[1]["scalars"] == {"train/avg_loss": 1.25, "train/accuracy": 0.5}
    assert events[2]["scalars"] == {"val/avg_loss": -2.0}
    assert ttb.read_events(w.path) == events
    jw = jtb.EventFileWriter(str(tmp_path / "jax"))
    jw.add_scalar("x", 3.5, step=1)
    jw.close()
    assert ttb.read_events(jw.path)[1]["scalars"] == {"x": 3.5}
