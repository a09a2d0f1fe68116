"""Evaluation metrics: speaker-ID classification and verification (the
port's own copy of ``titanet_tpu/train/metrics.py``; numpy only, so its
results equal the JAX package's).

Rebuild of the reference metrics (the reference's ``src/utils.py:294-403``):

- EER via ROC + root finding (reference :294-300 used sklearn+brentq; ours
  is a closed-form intersection of the interpolated ROC, same result),
- minDCF with the cumulative error-rate sweep (reference :303-367 is a
  Python loop over scores; ours is a vectorized numpy sweep),
- accuracy / macro precision / recall / F1 (reference :370-382 via sklearn;
  ours is pure numpy so the metrics also run where sklearn is absent).

Verification scoring is batched: embed every utterance once, score ALL pairs
with one ``[N, E] @ [E, N]`` matmul (the reference re-embedded both sides of
every pair at batch size 1 — src/learn.py:429-439, O(N^2) forwards).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def cosine_scores(embeddings: np.ndarray) -> np.ndarray:
    """All-pairs cosine similarity ``[N, N]`` from ``[N, E]`` embeddings."""
    x = np.asarray(embeddings, np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    return x @ x.T


def cross_cosine_scores(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Cosine similarity ``[N, M]`` between two embedding sets."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return a @ b.T


def snorm_scores(
    scores: np.ndarray,
    enroll_cohort: np.ndarray,
    test_cohort: np.ndarray,
    topk: Optional[int] = None,
    eps: float = 1e-12,
) -> np.ndarray:
    """Symmetric score normalization — S-norm, or AS-norm with ``topk``.

    No reference counterpart (the reference scores raw cosines,
    src/learn.py:437-439); this is the standard production calibration for
    open-set verification: each trial score is z-normalized against the
    score distribution of BOTH sides vs an impostor cohort, which removes
    per-utterance score offsets (channel/duration effects).

    Args:
      scores: raw trial scores ``[N, M]`` (enroll x test).
      enroll_cohort: scores of each enroll embedding vs the cohort ``[N, C]``.
      test_cohort: scores of each test embedding vs the cohort ``[M, C]``.
      topk: AS-norm (adaptive): per embedding, use only its ``topk``
        highest cohort scores for the mean/std (the cohort members closest
        to that embedding). ``None`` uses the full cohort (plain S-norm).

    Returns ``0.5 * ((s - mu_e)/sd_e + (s - mu_t)/sd_t)``, shape ``[N, M]``.
    """
    scores = np.asarray(scores, np.float64)
    enroll_cohort = np.asarray(enroll_cohort, np.float64)
    test_cohort = np.asarray(test_cohort, np.float64)

    def _stats(cohort: np.ndarray):
        if topk is not None and topk < cohort.shape[1]:
            # top-K highest scores per row (order within K irrelevant)
            part = np.partition(cohort, cohort.shape[1] - topk, axis=1)
            cohort = part[:, cohort.shape[1] - topk:]
        mu = cohort.mean(axis=1)
        sd = cohort.std(axis=1)
        return mu, np.maximum(sd, eps)

    mu_e, sd_e = _stats(enroll_cohort)
    mu_t, sd_t = _stats(test_cohort)
    z_e = (scores - mu_e[:, None]) / sd_e[:, None]
    z_t = (scores - mu_t[None, :]) / sd_t[None, :]
    return 0.5 * (z_e + z_t)


def all_pairs_scores_labels(
    embeddings: np.ndarray,
    speakers: Sequence,
    cohort_embeddings: Optional[np.ndarray] = None,
    cohort_topk: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scores/labels over the full Cartesian product of utterances,
    including self-pairs and both orderings — the exact pair protocol of the
    reference ``get_sample_pairs`` (src/datasets.py:165-183).

    ``cohort_embeddings`` enables S-norm/AS-norm score calibration
    (:func:`snorm_scores`); ``cohort_topk`` selects the adaptive variant.
    """
    scores = cosine_scores(embeddings)
    if cohort_embeddings is not None:
        cohort = cross_cosine_scores(embeddings, cohort_embeddings)
        scores = snorm_scores(scores, cohort, cohort, topk=cohort_topk)
    spk = np.asarray(speakers)
    labels = (spk[:, None] == spk[None, :]).reshape(-1).astype(np.int64)
    return scores.reshape(-1), labels


def roc_curve(scores: np.ndarray, labels: np.ndarray):
    """FPR/TPR over descending score thresholds (sklearn.roc_curve compatible
    on the points that matter for EER)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    return fpr, tpr


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate: the point where FPR == 1 - TPR (reference
    src/utils.py:294-300)."""
    fpr, tpr = roc_curve(scores, labels)
    fnr = 1.0 - tpr
    diff = fnr - fpr
    idx = int(np.searchsorted(-diff, 0.0))  # diff is non-increasing
    if idx == 0:
        return float((fpr[0] + fnr[0]) / 2)
    if idx >= len(diff):
        return float((fpr[-1] + fnr[-1]) / 2)
    # linear interpolation between the two straddling points
    x0, x1 = diff[idx - 1], diff[idx]
    w = 0.0 if x0 == x1 else x0 / (x0 - x1)
    eer = fpr[idx - 1] + w * (fpr[idx] - fpr[idx - 1])
    return float(eer)


def compute_error_rates(
    scores: np.ndarray, labels: np.ndarray, eps: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative FNR/FPR over ascending score thresholds (reference
    src/utils.py:303-344, vectorized)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(scores, kind="stable")
    sorted_labels = labels[order]
    fnrs = np.cumsum(sorted_labels)
    fprs = np.cumsum(1.0 - sorted_labels)
    fnrs_norm = sorted_labels.sum()
    fprs_norm = len(sorted_labels) - fnrs_norm
    fnrs = fnrs / (fnrs_norm + eps)
    fprs = 1.0 - fprs / (fprs_norm + eps)
    return fnrs, fprs


def det_curve(
    scores: np.ndarray, labels: np.ndarray, eps: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fprs, fnrs, thresholds) over ascending score thresholds — the
    DET-curve sweep (beyond the reference, which reports scalar EER/minDCF
    only, src/learn.py:437-459). Thresholds are the sorted scores; point i
    is the operating point "accept iff score > thresholds[i]"."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(scores, kind="stable")
    fnrs, fprs = compute_error_rates(scores, labels, eps=eps)
    return fprs, fnrs, scores[order]


def compute_mindcf(
    scores: np.ndarray,
    labels: np.ndarray,
    p_target: float = 0.01,
    c_fa: float = 1.0,
    c_miss: float = 1.0,
    eps: float = 1e-6,
) -> float:
    """Minimum detection cost (reference src/utils.py:347-367, vectorized)."""
    fnrs, fprs = compute_error_rates(scores, labels, eps=eps)
    c_det = c_miss * fnrs * p_target + c_fa * fprs * (1.0 - p_target)
    min_c_det = float(c_det.min()) if len(c_det) else float("inf")
    c_def = min(c_miss * p_target, c_fa * (1.0 - p_target))
    return float(min_c_det / (c_def + eps))


def _confusion_counts(y_true: np.ndarray, y_pred: np.ndarray):
    classes = np.unique(np.concatenate([y_true, y_pred]))
    tp = np.array([(y_pred[y_true == c] == c).sum() for c in classes], np.float64)
    pred_c = np.array([(y_pred == c).sum() for c in classes], np.float64)
    true_c = np.array([(y_true == c).sum() for c in classes], np.float64)
    return tp, pred_c, true_c


def get_train_val_metrics(
    y_true, y_pred, prefix: Optional[str] = None
) -> Dict[str, float]:
    """accuracy + macro precision/recall/F1 (reference src/utils.py:370-382;
    sklearn zero_division=0 semantics)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    tp, pred_c, true_c = _confusion_counts(y_true, y_pred)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_c > 0, tp / np.maximum(pred_c, 1), 0.0)
        recall = np.where(true_c > 0, tp / np.maximum(true_c, 1), 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    metrics = {
        "accuracy": float((y_true == y_pred).mean()),
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1": float(f1.mean()),
    }
    if prefix:
        metrics = {f"{prefix}/{k}": v for k, v in metrics.items()}
    return metrics


def metrics_from_class_counts(
    tp, pred_c, true_c, correct, total, prefix: Optional[str] = None
) -> Dict[str, float]:
    """:func:`get_train_val_metrics` from pre-accumulated per-class count
    vectors (device-side epoch accumulation — no per-step host readback).
    Classes appearing in neither targets nor predictions are excluded from
    the macro means, matching sklearn's label-union behavior."""
    tp = np.asarray(tp, np.float64)
    pred_c = np.asarray(pred_c, np.float64)
    true_c = np.asarray(true_c, np.float64)
    present = (pred_c > 0) | (true_c > 0)
    n_present = max(int(present.sum()), 1)
    precision = np.where(pred_c > 0, tp / np.maximum(pred_c, 1), 0.0)
    recall = np.where(true_c > 0, tp / np.maximum(true_c, 1), 0.0)
    denom = precision + recall
    f1 = np.where(denom > 0, 2 * precision * recall / np.maximum(denom, 1e-12), 0.0)
    metrics = {
        "accuracy": float(correct) / max(int(total), 1),
        "precision": float(precision[present].sum() / n_present),
        "recall": float(recall[present].sum() / n_present),
        "f1": float(f1[present].sum() / n_present),
    }
    if prefix:
        metrics = {f"{prefix}/{k}": v for k, v in metrics.items()}
    return metrics


def get_test_metrics(
    scores,
    labels,
    mindcf_p_target: float = 0.01,
    mindcf_c_fa: float = 1.0,
    mindcf_c_miss: float = 1.0,
    prefix: Optional[str] = None,
) -> Dict[str, float]:
    """EER + minDCF (reference src/utils.py:385-403)."""
    metrics = {
        "eer": compute_eer(np.asarray(scores), np.asarray(labels)),
        "mindcf": compute_mindcf(
            np.asarray(scores),
            np.asarray(labels),
            p_target=mindcf_p_target,
            c_fa=mindcf_c_fa,
            c_miss=mindcf_c_miss,
        ),
    }
    if prefix:
        metrics = {f"{prefix}/{k}": v for k, v in metrics.items()}
    return metrics
